"""minitron-4b: width/depth-pruned Nemotron, 256k vocabulary
[arXiv:2407.14679; hf].  The 256k vocab makes the embedding/logits the
sharding-critical tensors (vocab-parallel unembed + embedding)."""
from ..models.lm import LMConfig
from ._lm_family import lm_arch

SOURCE = "[arXiv:2407.14679; hf]"


def full():
    cfg = LMConfig(
        name="minitron-4b",
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=9216, vocab=256000,
        attn_impl="chunked", remat="full",
    )
    return lm_arch("minitron-4b", cfg, source=SOURCE, train_accum=4)


def smoke():
    cfg = LMConfig(
        name="minitron-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=2048,            # keep the fat-vocab character
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("minitron-4b", cfg, source=SOURCE)
