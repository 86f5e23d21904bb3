"""Every arch of the port at its smoke config, the port's counterpart of
tests/test_archs_smoke.py::test_prefill_decode_smoke: parameters drawn by
the port's ``materialize`` from a seed and cast once to the config's
dtype (bf16), a prefill on ``make_batch``'s batch and three greedy decode
steps on the CPU; every logit finite, of the padded vocabulary, and the
cache's length the prompt's (with pixtral's prefix) plus three."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_arch  # noqa: E402
from repro_torch.models.common import cast_params, materialize  # noqa: E402

SMOKE_PREFILL = ShapeSpec("smoke_prefill", seq_len=32, global_batch=2,
                          kind="prefill")
SMOKE_DECODE = ShapeSpec("smoke_decode", seq_len=48, global_batch=2,
                         kind="decode")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_decode_smoke(name):
    arch = get_arch(name, smoke=True)
    assert arch.has_decoder
    params = cast_params(materialize(
        arch.param_spec(), torch.Generator().manual_seed(0), device="cpu"),
        arch.cfg.dtype)
    batch = {k: torch.from_numpy(v)
             for k, v in arch.make_batch(SMOKE_PREFILL, seed=3).items()}
    logits, cache = arch.prefill(params, batch, max_len=SMOKE_DECODE.seq_len)
    vpad = arch.cfg.vocab_padded
    assert logits.shape[0] == 2 and logits.shape[-1] == vpad
    assert bool(torch.isfinite(logits).all())
    tok = logits[:, -1, :arch.cfg.vocab].argmax(-1)[:, None]
    for _ in range(3):
        logits, cache = arch.decode(params, cache, {"tokens": tok})
        assert tuple(logits.shape) == (2, 1, vpad)
        assert bool(torch.isfinite(logits).all()), name
        tok = logits[:, -1, :arch.cfg.vocab].argmax(-1)[:, None]
    assert cache["length"] == (batch["tokens"].shape[1]
                               + getattr(arch.cfg, "image_prefix", 0) + 3)
