"""internlm2-1.8b: dense GQA transformer [arXiv:2403.17297; hf]."""
from ..models.lm import LMConfig
from ._lm_family import lm_arch

SOURCE = "[arXiv:2403.17297; hf]"


def full():
    cfg = LMConfig(
        name="internlm2-1.8b",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92544,
        attn_impl="chunked", remat="full",
    )
    return lm_arch("internlm2-1.8b", cfg, source=SOURCE, train_accum=2)


def smoke():
    cfg = LMConfig(
        name="internlm2-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512,
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("internlm2-1.8b", cfg, source=SOURCE)
