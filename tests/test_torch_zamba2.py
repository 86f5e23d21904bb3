"""The port's zamba2 hybrid (``repro_torch/models/zamba2.py``) against the
reference's (``repro/models/zamba2.py``) on its smoke config and its own
parameters (``materialize``, carried across with
``convert.params_from_numpy``): ``hidden_states``, ``loss_fn``,
``prefill`` and three ``decode_step``s with every cache entry (the SSM
and conv states, the shared block's K/V), in f32 at the reference's
attention tolerance (2e-3) and in bf16 at its decode-consistency
tolerance (6e-2); decode against the port's own teacher-forced forward;
the parameters cast once against cast at every use, bit for bit; and the
full config's cache: 7 KV caches for 38 layers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import zamba2 as jz  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import zamba2  # noqa: E402
from repro_torch.models.common import cast_params, tree_leaves, tree_map  # noqa: E402

NAME = "zamba2-1.2b"
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-3),
          "bf16": (torch.bfloat16, jnp.bfloat16, 6e-2)}
PROMPT, STEPS, MAX_LEN = 8, 3, 16
_REF = {"hidden_states": jax.jit(jz.hidden_states, static_argnums=1),
        "loss_fn": jax.jit(jz.loss_fn, static_argnums=1),
        "prefill": jax.jit(jz.prefill, static_argnums=1,
                           static_argnames="max_len"),
        "decode_step": jax.jit(jz.decode_step, static_argnums=1)}


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)


def _close(got, want, tol: float):
    ok, err, bound = compare(got.float(), torch.from_numpy(_f32(want)),
                             tol=(tol, tol))
    assert ok, (err, bound)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke parameters (numpy, f32), with the Mamba
    layers' decay, step bias and skip and the LoRA's B drawn away from
    their constant inits, so every path carries weight."""
    p = jax.tree.map(np.asarray, ref_materialize(
        ref_arch(NAME, smoke=True).param_spec(), jax.random.key(0)))
    rng = np.random.default_rng(1)
    mamba = p["layers"]["mamba"]
    for key, base in (("a_log", 0.0), ("dt_bias", 0.0), ("d_skip", 1.0)):
        mamba[key] = (base + 0.3 * rng.standard_normal(mamba[key].shape)
                      ).astype(np.float32)
    lora_b = p["shared"]["lora_b"]
    p["shared"]["lora_b"] = (0.05 * rng.standard_normal(lora_b.shape)
                             ).astype(np.float32)
    return p


def _tokens(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)


def _cfgs(dt):
    tdt, jdt, _ = DTYPES[dt]
    return (dataclasses.replace(ref_arch(NAME, smoke=True).cfg, dtype=jdt),
            dataclasses.replace(get_arch(NAME, smoke=True).cfg, dtype=tdt))


def _prefill_decode(params, cfg, toks):
    logits, cache = zamba2.prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :PROMPT])},
        max_len=MAX_LEN)
    steps = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = zamba2.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        steps.append(logits)
    return steps, cache


@pytest.mark.parametrize("dt", DTYPES)
def test_hidden_states_and_loss_match_reference(ref_params, dt):
    jcfg, cfg = _cfgs(dt)
    toks = _tokens(cfg, seed=0)
    jp = jax.tree.map(jnp.asarray, ref_params)
    want, _, _ = _REF["hidden_states"](jp, jcfg, jnp.asarray(toks))
    params = params_from_numpy(ref_params, device="cpu")
    got, aux = zamba2.hidden_states(params, cfg, torch.from_numpy(toks))
    assert aux == 0.0 and got.dtype == DTYPES[dt][0]
    assert tuple(got.shape) == (2, PROMPT + STEPS, cfg.d_model)
    _close(got, want, DTYPES[dt][2])
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    want_loss, _ = _REF["loss_fn"](jp, jcfg, jax.tree.map(jnp.asarray, batch))
    got_loss, metrics = zamba2.loss_fn(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics["aux_loss"] == 0.0
    _close(got_loss, want_loss, DTYPES[dt][2])


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_and_decode_match_reference(ref_params, dt):
    """The prefill's last-position logits and three decode steps; the
    cache (SSM and conv states per layer, K/V per application) ends as
    the reference's, its length on the host."""
    jcfg, cfg = _cfgs(dt)
    toks = _tokens(cfg, seed=1)
    jp = jax.tree.map(jnp.asarray, ref_params)
    logits, cache = _REF["prefill"](
        jp, jcfg, {"tokens": jnp.asarray(toks[:, :PROMPT])}, max_len=MAX_LEN)
    want = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = _REF["decode_step"](
            jp, jcfg, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        want.append(logits)
    steps, got_cache = _prefill_decode(params_from_numpy(ref_params, device="cpu"),
                                       cfg, toks)
    for got, w in zip(steps, want, strict=True):
        assert tuple(got.shape) == (2, 1, cfg.vocab_padded)
        _close(got, w, DTYPES[dt][2])
    want_cache = cache_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    assert got_cache["length"] == want_cache["length"] == PROMPT + STEPS
    assert sorted(got_cache) == sorted(want_cache)
    for key in ("ssm", "conv", "k", "v"):
        assert got_cache[key].shape == want_cache[key].shape
        assert got_cache[key].dtype == want_cache[key].dtype
        _close(got_cache[key], want_cache[key].float().numpy(), DTYPES[dt][2])


def test_decode_matches_own_teacher_forced_forward(ref_params):
    """At the config's own dtype (bf16): prefill + decode reproduce the
    port's teacher-forced logits (6e-2)."""
    cfg = get_arch(NAME, smoke=True).cfg
    params = params_from_numpy(ref_params, device="cpu")
    toks = _tokens(cfg, seed=7)
    h, _ = zamba2.hidden_states(params, cfg, torch.from_numpy(toks))
    full = (h @ params["unembed"].to(h.dtype)).float().numpy()
    steps, _ = _prefill_decode(params, cfg, toks)
    for j, got in enumerate(steps):
        _close(got[:, 0], full[:, PROMPT - 1 + j], 6e-2)


def test_cast_once_equals_cast_at_use(ref_params):
    """Cast once to bf16, the Mamba layers' ``a_log``, ``dt_bias`` and
    ``d_skip`` kept in f32 (every use casts them to f32): the same
    logits and cache as the f32 parameters cast at every use."""
    cfg = get_arch(NAME, smoke=True).cfg
    f32 = params_from_numpy(ref_params, device="cpu")
    once = cast_params(f32, cfg.dtype)
    kept = {k: once["layers"]["mamba"][k].dtype for k in ("a_log", "dt_bias", "d_skip")}
    assert set(kept.values()) == {torch.float32}
    assert sum(t.dtype == cfg.dtype for t in tree_leaves(once)) == len(tree_leaves(once)) - 3
    toks = _tokens(cfg, seed=5)
    sa, ca = _prefill_decode(f32, cfg, toks)
    sb, cb = _prefill_decode(once, cfg, toks)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb, strict=True))
    assert all(torch.equal(ca[k], cb[k]) for k in ("ssm", "conv", "k", "v"))


def test_full_cache_holds_seven_kv_caches():
    """The full config (38 layers, the shared block before every 6th)
    keeps one KV cache per application, 7, and SSM and conv states per
    layer, as the reference's spec says (nothing allocated)."""
    port, ref = get_arch(NAME), ref_arch(NAME)
    assert port.cfg.n_shared == 7 and port.cfg.n_layers == 38
    assert [i for i in range(38) if zamba2._fires(port.cfg, i)] == [0, 6, 12, 18, 24, 30, 36]
    got, want = port.cache_spec(8, 2088), ref.cache_spec(8, 2088)
    assert sorted(got) == sorted(want)
    assert tree_map(lambda s: (s.shape, s.axes, s.init), got) == \
        {k: (w.shape, w.axes, w.init) for k, w in want.items()}
    assert got["k"].shape == (7, 8, 2088, 32, 64)
    assert got["ssm"].shape == (38, 8, 64, 64, 64) and got["ssm"].dtype == torch.float32
    assert got["conv"].shape == (38, 8, 3, 4096 + 128)


def test_chip_smoke_contracts_the_fan_in_of_either_attention_subtree():
    """``chip_smoke.py`` draws the served models' attention projections
    at the fan-in they contract over, on the LM's stacked ``layers/attn``
    and on zamba2's ``shared/attn`` alike, and leaves every other leaf."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    module = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(module)
    module.loader.exec_module(chip_smoke)
    for name, subtree in ((NAME, ("shared", "attn")),
                          ("granite-moe-1b-a400m", ("layers", "attn"))):
        arch = get_arch(name)
        acfg = arch.cfg.attn_cfg
        spec = arch.param_spec()
        got = chip_smoke._contracted_fan_in(spec, subtree, acfg)
        attn = got[subtree[0]][subtree[1]]
        assert attn["wq"].scale == attn["wk"].scale == attn["wv"].scale == \
            acfg.d_model ** -0.5
        assert attn["wo"].scale == (acfg.n_heads * acfg.head_dim) ** -0.5
        flat, want = tree_leaves(got), tree_leaves(spec)
        changed = [a for a, b in zip(flat, want, strict=True) if a != b]
        assert len(changed) == 4
