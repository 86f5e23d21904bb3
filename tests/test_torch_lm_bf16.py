"""The port's decoder LM (``repro_torch/models/lm.py``) against the
reference's in bf16 (the configs' own dtype), at the reference's
decode-consistency tolerance (6e-2, tests/test_decode_consistency.py:27):
the forward, the prefill and three decode steps, pixtral with its patch
embeddings; then the port on its own at the config's dtype: decode
against its teacher-forced forward, and the parameters cast once against
cast at every use, bit for bit.  The f32 cases and what both share are
tests/test_torch_lm.py and tests/_torch_lm.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_lm import (  # noqa: E402
    DTYPES, LM_ARCHS, MAX_LEN, PROMPT, STEPS, _REF, _close, _f32,
    _prefill_decode, _tokens, reference_params, reference_runs)
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import cast_params, tree_leaves  # noqa: E402


DT = "bf16"


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of each smoke config, as numpy (f32)."""
    return reference_params()


@pytest.fixture(scope="module")
def reference(ref_params):
    return reference_runs(ref_params, DT)


@pytest.mark.parametrize("dt", [DT])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_forward_matches_reference(name, dt, reference, ref_params):
    case = reference[name, dt]
    params = params_from_numpy(ref_params[name], device="cpu")
    h, aux = lm.hidden_states(params, case["cfg"], torch.from_numpy(case["tokens"]))
    logits = lm.logits_fn(params, case["cfg"], h)
    assert logits.dtype == DTYPES[dt][0]
    if case["cfg"].moe is None:
        assert aux == 0.0 == case["aux"]
    else:   # the routers run in f32 in both dtypes
        assert aux.dtype == torch.float32 and case["aux"] > 0
        _close(aux, np.float32(case["aux"]), 2e-3)
    assert tuple(logits.shape) == (2, PROMPT + STEPS, case["cfg"].vocab_padded)
    _close(logits, case["full"], DTYPES[dt][2])


@pytest.mark.parametrize("dt", [DT])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_and_decode_match_reference(name, dt, reference, ref_params):
    """The prefill's last-position logits, then three decode steps; the
    cache ends as the reference's (length on the host)."""
    case = reference[name, dt]
    params = params_from_numpy(ref_params[name], device="cpu")
    steps, cache = _prefill_decode(params, case["cfg"], case["tokens"])
    for got, want in zip(steps, case["steps"], strict=True):
        assert tuple(got.shape) == (2, 1, case["cfg"].vocab_padded)
        _close(got, want, DTYPES[dt][2])
    want = cache_from_numpy(case["cache"], device="cpu")
    assert cache["length"] == want["length"] == PROMPT + STEPS
    for key in ("k", "v"):
        assert cache[key].shape == want[key].shape
        assert cache[key].dtype == want[key].dtype == DTYPES[dt][0]
        _close(cache[key], want[key].float().numpy(), DTYPES[dt][2])


@pytest.mark.parametrize("name", LM_ARCHS)
def test_decode_matches_own_teacher_forced_forward(name, ref_params):
    """At the config's own dtype (bf16): prefill + decode reproduce the
    port's teacher-forced logits (tests/test_decode_consistency.py)."""
    cfg = get_arch(name, smoke=True).cfg
    params = params_from_numpy(ref_params[name], device="cpu")
    toks = _tokens(cfg, seed=7)
    h, _ = lm.hidden_states(params, cfg, torch.from_numpy(toks))
    full = lm.logits_fn(params, cfg, h).float().numpy()
    steps, _ = _prefill_decode(params, cfg, toks)
    for j, got in enumerate(steps):
        _close(got[:, 0], full[:, PROMPT - 1 + j], 6e-2)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_cast_once_equals_cast_at_use(name, ref_params):
    """The parameters cast once to the compute dtype give the logits of
    the f32 parameters cast at every use, bit for bit: full forward,
    prefill and decode."""
    cfg = get_arch(name, smoke=True).cfg
    f32 = params_from_numpy(ref_params[name], device="cpu")
    once = cast_params(f32, cfg.dtype)
    # the MoE router stays f32 (its use casts it to f32)
    dtypes = [t.dtype for t in tree_leaves(once)]
    assert dtypes.count(torch.float32) == (cfg.moe is not None)
    assert dtypes.count(cfg.dtype) == len(dtypes) - (cfg.moe is not None)
    if cfg.moe is not None:
        assert once["layers"]["moe"]["router"].dtype == torch.float32
    toks = _tokens(cfg, seed=5)
    ha, _ = lm.hidden_states(f32, cfg, torch.from_numpy(toks))
    hb, _ = lm.hidden_states(once, cfg, torch.from_numpy(toks))
    assert torch.equal(lm.logits_fn(f32, cfg, ha), lm.logits_fn(once, cfg, hb))
    sa, ca = _prefill_decode(f32, cfg, toks)
    sb, cb = _prefill_decode(once, cfg, toks)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb, strict=True))
    assert torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"])


@pytest.mark.parametrize("dt", [DT])
def test_patch_embeds_match_reference(dt, ref_params):
    """pixtral with its batch as the serve launcher draws it
    (``make_batch``: 8 patch embeddings, then the tokens): the forward
    with the patches prepended, the prefill over both and three decode
    steps, against the reference's."""
    name = "pixtral-12b"
    tdt, jdt, tol = DTYPES[dt]
    ref = ref_arch(name, smoke=True)
    jcfg = dataclasses.replace(ref.cfg, dtype=jdt)
    cfg = dataclasses.replace(get_arch(name, smoke=True).cfg, dtype=tdt)
    shape = ShapeSpec("cli_prefill", PROMPT + cfg.image_prefix, 2, "prefill")
    batch = get_arch(name, smoke=True).make_batch(shape, seed=2)
    assert batch["patch_embeds"].shape == (2, cfg.image_prefix, cfg.d_model)
    p = jax.tree.map(jnp.asarray, ref_params[name])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = params_from_numpy(ref_params[name], device="cpu")
    h, _ = _REF["hidden_states"](p, jcfg, jbatch["tokens"],
                                 extra_embeds=jbatch["patch_embeds"])
    got, _ = lm.hidden_states(params, cfg, tbatch["tokens"],
                              extra_embeds=tbatch["patch_embeds"])
    assert tuple(got.shape) == (2, PROMPT + cfg.image_prefix, cfg.d_model)
    _close(got, _f32(h), tol)
    toks = _tokens(cfg, seed=2, n=STEPS)
    logits, cache = _REF["prefill"](p, jcfg, jbatch, max_len=MAX_LEN + 8)
    got, got_cache = lm.prefill(params, cfg, tbatch, max_len=MAX_LEN + 8)
    assert got_cache["length"] == PROMPT + cfg.image_prefix
    _close(got, _f32(logits), tol)
    for t in range(STEPS):
        logits, cache = _REF["decode_step"](
            p, jcfg, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        got, got_cache = lm.decode_step(
            params, cfg, got_cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        _close(got, _f32(logits), tol)
