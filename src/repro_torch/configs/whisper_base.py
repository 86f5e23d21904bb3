"""whisper-base: encoder-decoder with a stub conv/mel frontend
[arXiv:2212.04356; unverified].

Shapes for the encoder-decoder family:

* ``train_4k``    — encode seq_len frames, teacher-force seq_len tokens.
* ``prefill_32k`` — encode seq_len frames, prefill a 256-token prompt.
* ``decode_32k``  — one decoder token; self-KV cache of seq_len, cross-KV
  over seq_len encoder frames (computed at prefill).
* ``long_500k``   — skipped: the decoder is full attention.
"""
import torch

from ..models import whisper
from ..models.common import ParamSpec
from .base import ArchDef, ShapeSpec

SOURCE = "[arXiv:2212.04356; unverified]"

PROMPT_LEN = 256


def _prompt_len(shape: ShapeSpec) -> int:
    """Decoder prompt for prefill: 256 at assigned scale, shrunk for the
    smoke shapes so it stays within max_text (11 at 1500 frames)."""
    return min(PROMPT_LEN, max(shape.seq_len // 128, 8))


def _batch_spec(shape: ShapeSpec, cfg: whisper.WhisperConfig) -> dict:
    b = shape.global_batch
    frames = ParamSpec((b, shape.seq_len, cfg.d_model), ("batch", None, "embed"),
                       dtype=torch.bfloat16)

    def ints(s: int, init: str = "zeros") -> ParamSpec:
        return ParamSpec((b, s), ("batch", None), init=init, dtype=torch.int32)

    if shape.kind == "train":
        s = shape.seq_len
        return {"frames": frames, "tokens": ints(s), "labels": ints(s),
                "mask": ParamSpec((b, s), ("batch", None), init="ones",
                                  dtype=torch.float32)}
    if shape.kind == "prefill":
        return {"frames": frames, "tokens": ints(_prompt_len(shape))}
    return {"tokens": ints(1)}              # decode: one token


def _arch(cfg) -> ArchDef:
    return ArchDef(
        name="whisper-base",
        family="audio",
        cfg=cfg,
        spec_fn=whisper.whisper_spec,
        loss_fn=whisper.loss_fn,
        prefill_fn=whisper.prefill,
        decode_fn=whisper.decode_step,
        cache_spec_fn=whisper.cache_spec,
        profile="tp_dp",
        sub_quadratic=False,
        source=SOURCE,
        batch_spec_fn=_batch_spec,
    )


def full():
    return _arch(whisper.WhisperConfig(
        name="whisper-base",
        n_layers=6, d_model=512, n_heads=8, d_ff=2048, vocab=51865,
        attn_impl="chunked", remat="full",
    ))


def smoke():
    return _arch(whisper.WhisperConfig(
        name="whisper-smoke",
        n_layers=2, d_model=64, n_heads=2, d_ff=128, vocab=512,
        max_frames=64, max_text=64,
        attn_impl="dense", vocab_pad_multiple=64,
    ))
