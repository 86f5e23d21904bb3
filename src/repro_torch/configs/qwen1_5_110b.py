"""qwen1.5-110b: dense GQA transformer with QKV bias
[hf:Qwen/Qwen1.5-0.5B family scaled per assignment; hf]."""
from ..models.lm import LMConfig
from ._lm_family import lm_arch

SOURCE = "[hf:Qwen/Qwen1.5-110B; hf]"


def full():
    cfg = LMConfig(
        name="qwen1.5-110b",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=49152, vocab=152064, qkv_bias=True,
        attn_impl="chunked", remat="full",
    )
    return lm_arch("qwen1.5-110b", cfg, profile="tp_fsdp", source=SOURCE,
                   train_accum=16)


def smoke():
    cfg = LMConfig(
        name="qwen1.5-smoke",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=384, vocab=512, qkv_bias=True,
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("qwen1.5-110b", cfg, profile="tp_fsdp", source=SOURCE)
