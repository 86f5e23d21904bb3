"""xlstm-125m: sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

The config has ``d_ff = 0``: the feed-forward capacity lives inside the
blocks (see ``repro_torch.models.xlstm_lm``).  Sub-quadratic: runs
long_500k.
"""
from ..models import xlstm_lm
from .base import ArchDef

SOURCE = "[arXiv:2405.04517; unverified]"


def _arch(cfg, train_accum: int = 1) -> ArchDef:
    return ArchDef(
        name="xlstm-125m",
        family="ssm",
        cfg=cfg,
        spec_fn=xlstm_lm.xlstm_lm_spec,
        loss_fn=xlstm_lm.loss_fn,
        prefill_fn=xlstm_lm.prefill,
        decode_fn=xlstm_lm.decode_step,
        cache_spec_fn=xlstm_lm.cache_spec,
        profile="dp_vocab",
        sub_quadratic=True,
        source=SOURCE,
        train_accum=train_accum,
    )


def full():
    return _arch(xlstm_lm.XLSTMLMConfig(
        name="xlstm-125m",
        n_layers=12, d_model=768, n_heads=4, vocab=50304,
        slstm_at=(3, 7), remat="full",
    ), train_accum=4)


def smoke():
    return _arch(xlstm_lm.XLSTMLMConfig(
        name="xlstm-smoke",
        n_layers=3, d_model=64, n_heads=2, vocab=512,
        slstm_at=(1,), chunk=16, vocab_pad_multiple=64,
    ))
