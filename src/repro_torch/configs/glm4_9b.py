"""glm4-9b: dense transformer, 2 KV heads (extreme GQA), partial RoPE
[hf:THUDM/glm-4-9b; hf]."""
from ..models.lm import LMConfig
from ._lm_family import lm_arch

SOURCE = "[hf:THUDM/glm-4-9b; hf]"


def full():
    cfg = LMConfig(
        name="glm4-9b",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, rope_fraction=0.5,
        attn_impl="chunked", remat="full",
    )
    return lm_arch("glm4-9b", cfg, profile="tp_fsdp", source=SOURCE,
                   train_accum=8)


def smoke():
    cfg = LMConfig(
        name="glm4-smoke",
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab=512, rope_fraction=0.5,
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("glm4-9b", cfg, profile="tp_fsdp", source=SOURCE)
