"""The port's decoder LM (``repro_torch/models/lm.py``) against the
reference's (``repro/models/lm.py``) on the smoke configs of the dense,
MoE (granite-moe, qwen3-moe: the scatter dispatch, its aux loss) and
multimodal (pixtral) archs: the reference's own parameters (its
``materialize``), carried across with ``convert.params_from_numpy``, and
the same tokens through ``hidden_states`` + ``logits_fn``, ``prefill``
and three ``decode_step``s on both sides; f32 (the config's dtype
replaced on both sides) at the reference's attention tolerance (2e-3,
tests/test_kernels.py:102), bf16 (the configs' own) at its
decode-consistency tolerance (6e-2, tests/test_decode_consistency.py:27).
pixtral also with its patch embeddings prepended.  Then the port on its
own: decode against its teacher-forced forward, the unstacked layer
layout against the stacked one, and the parameters cast once against
cast at every use, bit for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_arch  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import cast_params, tree_leaves, tree_map  # noqa: E402

#: port dtype, reference dtype, tolerance
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-3),
          "bf16": (torch.bfloat16, jnp.bfloat16, 6e-2)}
PROMPT, STEPS, MAX_LEN = 8, 3, 16
#: the archs of this module, those built on ``lm.LMConfig`` (zamba2,
#: xlstm-125m and whisper-base have their own: test_torch_zamba2.py,
#: test_torch_xlstm.py, test_torch_whisper.py)
LM_ARCHS = tuple(n for n in ARCH_NAMES
                 if isinstance(get_arch(n, smoke=True).cfg, lm.LMConfig))
#: the reference's forward, compiled once per config (static)
_REF = {"hidden_states": jax.jit(jlm.hidden_states, static_argnums=1),
        "logits_fn": jax.jit(jlm.logits_fn, static_argnums=1),
        "prefill": jax.jit(jlm.prefill, static_argnums=1,
                           static_argnames="max_len"),
        "decode_step": jax.jit(jlm.decode_step, static_argnums=1)}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's parameters of each smoke config, as numpy (f32)."""
    return {n: jax.tree.map(np.asarray, ref_materialize(
        ref_arch(n, smoke=True).param_spec(), jax.random.key(0)))
        for n in LM_ARCHS}


def _tokens(cfg, seed: int, n: int = PROMPT + STEPS) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, n)).astype(np.int32)


@pytest.fixture(scope="module")
def reference(ref_params):
    """Per (arch, dtype): the configs, the tokens, and the reference's
    logits of the full forward, the prefill and each decode step."""
    out = {}
    for i, name in enumerate(LM_ARCHS):
        for dt, (tdt, jdt, _) in DTYPES.items():
            jcfg = dataclasses.replace(ref_arch(name, smoke=True).cfg, dtype=jdt)
            cfg = dataclasses.replace(get_arch(name, smoke=True).cfg, dtype=tdt)
            p = jax.tree.map(jnp.asarray, ref_params[name])
            toks = _tokens(cfg, seed=i)
            h, aux = _REF["hidden_states"](p, jcfg, jnp.asarray(toks))
            full = _f32(_REF["logits_fn"](p, jcfg, h))
            logits, cache = _REF["prefill"](
                p, jcfg, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                max_len=MAX_LEN)
            steps = [_f32(logits)]
            for t in range(PROMPT, PROMPT + STEPS):
                logits, cache = _REF["decode_step"](
                    p, jcfg, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
                steps.append(_f32(logits))
            out[name, dt] = {"cfg": cfg, "tokens": toks, "full": full,
                             "aux": float(aux), "steps": steps, "cache": jax.tree.map(np.asarray, cache)}
    return out


def _close(got: torch.Tensor, want: np.ndarray, tol: float):
    ok, err, bound = compare(got.float(), torch.from_numpy(np.array(want)),
                            tol=(tol, tol))
    assert ok, (err, bound)


def _prefill_decode(params, cfg, toks):
    """The port's prefill and STEPS decode steps; their logits and the
    final cache."""
    logits, cache = lm.prefill(params, cfg,
                               {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                               max_len=MAX_LEN)
    steps = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = lm.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        steps.append(logits)
    return steps, cache


@pytest.mark.parametrize("dt", DTYPES)
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


@pytest.mark.parametrize("dt", DTYPES)
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
def test_unstacked_layers_equal_stacked(name, ref_params):
    """``scan_layers=False`` declares one ``layer_{i}`` subtree per layer
    and runs the same forward, bit for bit."""
    arch = get_arch(name, smoke=True)
    cfg = dataclasses.replace(arch.cfg, scan_layers=False)
    spec = lm.lm_spec(cfg)
    assert sorted(spec["layers"]) == [f"layer_{i}" for i in range(cfg.n_layers)]
    params = params_from_numpy(ref_params[name], device="cpu")
    layers = lm._layers(params, arch.cfg)
    unstacked = dict(params, layers={f"layer_{i}": p for i, p in enumerate(layers)})
    assert tree_map(lambda t: t.shape, unstacked["layers"]["layer_0"]) == \
        tree_map(lambda s: torch.Size(s.shape), spec["layers"]["layer_0"])
    toks = torch.from_numpy(_tokens(cfg, seed=3))
    h, _ = lm.hidden_states(params, arch.cfg, toks)
    h2, _ = lm.hidden_states(unstacked, cfg, toks)
    assert torch.equal(h, h2)
    with pytest.raises(ValueError, match="scan_layers"):
        lm.prefill(unstacked, cfg, {"tokens": toks})


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


def test_prefix_embeddings_match_reference(ref_params):
    """A prefix of precomputed embeddings (``extra_embeds``, the
    reference's ``image_prefix`` path) in f32."""
    name = "internlm2-1.8b"
    jcfg = dataclasses.replace(ref_arch(name, smoke=True).cfg, dtype=jnp.float32)
    cfg = dataclasses.replace(get_arch(name, smoke=True).cfg, dtype=torch.float32)
    rng = np.random.default_rng(4)
    extra = (rng.standard_normal((2, 3, cfg.d_model)) * 0.02).astype(np.float32)
    toks = _tokens(cfg, seed=4, n=6)
    h, _ = jlm.hidden_states(jax.tree.map(jnp.asarray, ref_params[name]), jcfg,
                             jnp.asarray(toks), extra_embeds=jnp.asarray(extra))
    got, _ = lm.hidden_states(params_from_numpy(ref_params[name], device="cpu"),
                              cfg, torch.from_numpy(toks),
                              extra_embeds=torch.from_numpy(extra))
    assert tuple(got.shape) == (2, 9, cfg.d_model)
    _close(got, _f32(h), 2e-3)


@pytest.mark.parametrize("dt", DTYPES)
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
