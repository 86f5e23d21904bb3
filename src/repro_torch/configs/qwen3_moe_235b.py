"""qwen3-moe-235b-a22b: 94-layer 128-expert top-8 MoE
[hf:Qwen/Qwen3-235B-A22B family; hf].  The EP+FSDP+TP stress case."""
from ..models.lm import LMConfig
from ..models.moe import MoEConfig
from ._lm_family import lm_arch

SOURCE = "[hf:Qwen/Qwen3-235B-A22B; hf]"


def full():
    cfg = LMConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536, impl="shard_map"),
        attn_impl="chunked", remat="full",
    )
    return lm_arch("qwen3-moe-235b-a22b", cfg, family="moe",
                   profile="moe_ep", source=SOURCE, train_accum=16,
                   moment_dtype="bf16")


def smoke():
    cfg = LMConfig(
        name="qwen3-moe-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("qwen3-moe-235b-a22b", cfg, family="moe",
                   profile="moe_ep", source=SOURCE)
