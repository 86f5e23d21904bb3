"""granite-moe-1b-a400m: 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.lm import LMConfig
from ..models.moe import MoEConfig
from ._lm_family import lm_arch

SOURCE = "[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"


def full():
    cfg = LMConfig(
        name="granite-moe-1b-a400m",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff=512, impl="shard_map"),
        attn_impl="chunked", remat="full",
    )
    return lm_arch("granite-moe-1b-a400m", cfg, family="moe",
                   profile="moe_ep", source=SOURCE, train_accum=2)


def smoke():
    cfg = LMConfig(
        name="granite-moe-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64),
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("granite-moe-1b-a400m", cfg, family="moe",
                   profile="moe_ep", source=SOURCE)
