"""zamba2-1.2b: Mamba2 backbone + shared attention block (hybrid)
[arXiv:2411.15242; hf].  Sub-quadratic — runs the long_500k cell."""
from ..models import zamba2
from .base import ArchDef

SOURCE = "[arXiv:2411.15242; hf]"


def _arch(cfg, train_accum: int = 1) -> ArchDef:
    return ArchDef(
        name="zamba2-1.2b",
        family="hybrid",
        cfg=cfg,
        spec_fn=zamba2.zamba2_spec,
        loss_fn=zamba2.loss_fn,
        prefill_fn=zamba2.prefill,
        decode_fn=zamba2.decode_step,
        cache_spec_fn=zamba2.cache_spec,
        profile="tp_dp",
        sub_quadratic=True,
        source=SOURCE,
        train_accum=train_accum,
    )


def full():
    return _arch(zamba2.Zamba2Config(
        name="zamba2-1.2b",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, d_state=64,
        shared_every=6, attn_impl="chunked", remat="full",
    ), train_accum=4)


def smoke():
    return _arch(zamba2.Zamba2Config(
        name="zamba2-smoke",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=512, d_state=16,
        shared_every=2, lora_rank=8, mamba_head_dim=32, mamba_chunk=16,
        attn_impl="dense", vocab_pad_multiple=64,
    ))
