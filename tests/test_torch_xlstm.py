"""The port's xLSTM (``repro_torch/models/xlstm.py`` and ``xlstm_lm.py``)
against the reference's (``repro/models/xlstm.py``, ``xlstm_lm.py``): the
mLSTM's chunkwise form and its recurrence on the same random inputs (a
chunk that divides the sequence and one that leaves padding, the state
carried across a split as tests/test_chunked_equivalence.py carries it),
the sLSTM's loop with a carried state, and the smoke LM on the reference's
own parameters (``materialize``, carried across with
``convert.params_from_numpy``; the sLSTM's recurrent weights and gate
biases drawn away from their inits): ``hidden_states``, ``loss_fn``,
``prefill`` and three ``decode_step``s with every layer's state, in f32 at
the reference's tolerance (2e-3) and in bf16 at its decode-consistency
tolerance (6e-2); decode against the port's own teacher-forced forward;
the parameters cast once against cast at every use, bit for bit, with the
sLSTM's ``r_*`` kept in f32."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro.models import xlstm_lm as jxl  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import common as pc  # noqa: E402
from repro_torch.models import xlstm, xlstm_lm  # noqa: E402

NAME = "xlstm-125m"
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-3),
          "bf16": (torch.bfloat16, jnp.bfloat16, 6e-2)}
#: a prompt of 24 tokens: chunk 16 leaves 8 padded steps
PROMPT, STEPS = 24, 3
_REF = {"hidden_states": jax.jit(jxl.hidden_states, static_argnums=1),
        "loss_fn": jax.jit(jxl.loss_fn, static_argnums=1),
        "prefill": jax.jit(jxl.prefill, static_argnums=1,
                           static_argnames="max_len"),
        "decode_step": jax.jit(jxl.decode_step, static_argnums=1),
        "slstm_core": jax.jit(jx._slstm_core, static_argnums=1),
        "slstm_block": jax.jit(jx.slstm_block, static_argnums=1)}


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)


def _close(got, want, tol: float):
    ok, err, bound = compare(got.float(), torch.from_numpy(_f32(want)),
                             tol=(tol, tol))
    assert ok, (err, bound)


def _mlstm_inputs(seed: int, b=2, s=24, h=2, p=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    i_raw = (2 * rng.standard_normal((b, s, h))).astype(np.float32)
    f_raw = (2 * rng.standard_normal((b, s, h)) + 1).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("chunk", [8, 5, 64])
def test_mlstm_chunked_matches_reference_and_recurrence(chunk):
    """Chunk 8 divides the 24 steps, 5 leaves one padded, 64 takes them
    all in one chunk: the output and the carried (C, n, m) equal the
    reference's chunked form and the port's own recurrence (m at 1e-4, as
    tests/test_chunked_equivalence.py holds it)."""
    arrays = _mlstm_inputs(0)
    want, (c, n, m) = jx._mlstm_chunked(*_j(arrays), chunk=chunk)
    got, (gc, gn, gm) = xlstm._mlstm_chunked(*_t(arrays), chunk=chunk)
    _close(got, want, 2e-3)
    for g, w in ((gc, c), (gn, n)):
        _close(g, w, 2e-3)
    assert torch.allclose(gm, torch.from_numpy(_f32(m)), rtol=1e-4, atol=1e-4)
    rec, (rc, rn, rm) = xlstm._mlstm_core(*_t(arrays))
    _close(got, rec.numpy(), 2e-3)
    _close(gc, rc.numpy(), 2e-3)
    assert torch.allclose(gm, rm, rtol=1e-4, atol=1e-4)


def test_mlstm_core_matches_reference():
    arrays = _mlstm_inputs(1, s=9)
    want, state = jx._mlstm_core(*_j(arrays))
    got, got_state = xlstm._mlstm_core(*_t(arrays))
    _close(got, want, 2e-3)
    for g, w in zip(got_state, state, strict=True):
        _close(g, w, 2e-3)


def test_mlstm_chunked_with_carry_state():
    """The first 8 steps, their state carried, then the last 4, chunk 4:
    the tail equals one pass of the recurrence and the reference's split
    run."""
    q, k, v, i_raw, f_raw = _mlstm_inputs(2, s=12, p=4)
    ref, _ = xlstm._mlstm_core(*_t((q, k, v, i_raw, f_raw)))
    head = [a[:, :8] for a in (q, k, v, i_raw, f_raw)]
    tail = [a[:, 8:] for a in (q, k, v, i_raw, f_raw)]
    _, st8 = xlstm._mlstm_chunked(*_t(head), chunk=4)
    got, _ = xlstm._mlstm_chunked(*_t(tail), state=st8, chunk=4)
    _close(got, ref[:, 8:].numpy(), 2e-3)
    _, jst8 = jx._mlstm_chunked(*_j(head), chunk=4)
    want, _ = jx._mlstm_chunked(*_j(tail), state=jst8, chunk=4)
    _close(got, want, 2e-3)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke parameters (numpy, f32), the sLSTM layer's
    recurrent weights scaled up and its gate biases drawn, so the
    recurrence carries weight."""
    p = jax.tree.map(np.asarray, ref_materialize(
        ref_configs.get_arch(NAME, smoke=True).param_spec(), jax.random.key(0)))
    rng = np.random.default_rng(1)
    sl = p["layers"]["layer_1"]["slstm"]
    for g in xlstm.GATES:
        sl[f"r_{g}"] = (3 * sl[f"r_{g}"]).astype(np.float32)
        sl[f"b_{g}"] = (sl[f"b_{g}"] + 0.3 * rng.standard_normal(
            sl[f"b_{g}"].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("dt", DTYPES)
def test_slstm_core_matches_reference(ref_params, dt):
    """The sLSTM loop on the smoke layer's (perturbed) parameters, from the
    empty state and then from the state it reached: the outputs and (c,
    n, hid, m)."""
    tdt, jdt, tol = DTYPES[dt]
    bc = configs.get_arch(NAME, smoke=True).cfg.block_cfg
    p = ref_params["layers"]["layer_1"]["slstm"]
    x = np.random.default_rng(4).standard_normal((2, 10, bc.d_model))
    xj = jnp.asarray(x, jdt)
    xt = params_from_numpy(np.asarray(xj), device="cpu")
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, device="cpu")
    want, state = _REF["slstm_core"](jp, bc, xj[:, :6])
    want2, state2 = _REF["slstm_core"](jp, bc, xj[:, 6:], state=state)
    got, st = xlstm._slstm_core(tp, bc, xt[:, :6])
    got2, st2 = xlstm._slstm_core(tp, bc, xt[:, 6:], state=st)
    assert got.dtype == tdt
    for g, w in ((got, want), (got2, want2), *zip(st2, state2, strict=True)):
        _close(g, w, tol)


def test_slstm_keeps_f32_recurrent_weights(ref_params):
    """Cast once to bf16, the sLSTM's r_z, r_i, r_f, r_o stay f32 (the
    reference casts them to f32 at use): the block on the cast tree equals
    the block on the f32 tree bit for bit, and the reference's at its bf16
    tolerance; a bf16 recurrent weight would not give the same bits."""
    bc = configs.get_arch(NAME, smoke=True).cfg.block_cfg
    p = ref_params["layers"]["layer_1"]["slstm"]
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 8, bc.d_model)),
                    jnp.bfloat16)
    xt = params_from_numpy(np.asarray(x), device="cpu")
    f32 = params_from_numpy(p, device="cpu")
    once = pc.cast_params(f32, torch.bfloat16)
    assert {g: once[f"r_{g}"].dtype for g in xlstm.GATES} == \
        dict.fromkeys(xlstm.GATES, torch.float32)
    assert once["w_z"].dtype == torch.bfloat16
    got = xlstm.slstm_block(once, bc, xt)
    assert torch.equal(got, xlstm.slstm_block(f32, bc, xt))
    want = _REF["slstm_block"](jax.tree.map(jnp.asarray, p), bc, x)
    _close(got, want, 6e-2)
    rounded = {k: t.to(torch.bfloat16) for k, t in f32.items()}
    assert not torch.equal(got, xlstm.slstm_block(rounded, bc, xt))


def _cfgs(dt):
    tdt, jdt, _ = DTYPES[dt]
    return (dataclasses.replace(ref_configs.get_arch(NAME, smoke=True).cfg, dtype=jdt),
            dataclasses.replace(configs.get_arch(NAME, smoke=True).cfg, dtype=tdt))


def _tokens(cfg, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, PROMPT + STEPS)).astype(np.int32)


def _prefill_decode(params, cfg, toks):
    logits, cache = xlstm_lm.prefill(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :PROMPT])})
    steps = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = xlstm_lm.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        steps.append(logits)
    return steps, cache


@pytest.mark.parametrize("dt", DTYPES)
def test_hidden_states_and_loss_match_reference(ref_params, dt):
    jcfg, cfg = _cfgs(dt)
    toks = _tokens(cfg, seed=0)
    jp = jax.tree.map(jnp.asarray, ref_params)
    want = _REF["hidden_states"](jp, jcfg, jnp.asarray(toks))
    params = params_from_numpy(ref_params, device="cpu")
    got = xlstm_lm.hidden_states(params, cfg, torch.from_numpy(toks))
    assert got.dtype == DTYPES[dt][0]
    assert tuple(got.shape) == (2, PROMPT + STEPS, cfg.d_model)
    _close(got, want, DTYPES[dt][2])
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    want_loss, _ = _REF["loss_fn"](jp, jcfg, jax.tree.map(jnp.asarray, batch))
    got_loss, metrics = xlstm_lm.loss_fn(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics["aux_loss"] == 0.0
    _close(got_loss, want_loss, DTYPES[dt][2])


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_and_decode_match_reference(ref_params, dt):
    """The prefill's last-position logits (the mLSTMs on the chunked form,
    8 steps padded) and three decode steps (on the recurrence); every
    layer's state ends as the reference's, the length on the host."""
    jcfg, cfg = _cfgs(dt)
    toks = _tokens(cfg, seed=1)
    jp = jax.tree.map(jnp.asarray, ref_params)
    logits, cache = _REF["prefill"](jp, jcfg,
                                    {"tokens": jnp.asarray(toks[:, :PROMPT])})
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
    for i in range(cfg.n_layers):
        got_l, want_l = got_cache[f"layer_{i}"], want_cache[f"layer_{i}"]
        assert sorted(got_l) == sorted(want_l) == (
            ["c", "hid", "m", "n"] if cfg.is_slstm(i) else ["c", "m", "n"])
        for key, w in want_l.items():
            assert got_l[key].shape == w.shape and got_l[key].dtype == torch.float32
            _close(got_l[key], w.numpy(), DTYPES[dt][2])


def test_decode_matches_own_teacher_forced(ref_params):
    """At the config's own dtype (bf16): prefill + decode reproduce the
    port's teacher-forced logits (6e-2)."""
    cfg = configs.get_arch(NAME, smoke=True).cfg
    params = params_from_numpy(ref_params, device="cpu")
    toks = _tokens(cfg, seed=7)
    h = xlstm_lm.hidden_states(params, cfg, torch.from_numpy(toks))
    full = (h @ params["unembed"].to(h.dtype)).float().numpy()
    steps, _ = _prefill_decode(params, cfg, toks)
    for j, got in enumerate(steps):
        _close(got[:, 0], full[:, PROMPT - 1 + j], 6e-2)


def test_cast_once_equals_cast_at_use(ref_params):
    """The whole tree cast once to bf16, the sLSTM's four recurrent
    weights kept in f32: the same logits and states as the f32 tree."""
    cfg = configs.get_arch(NAME, smoke=True).cfg
    f32 = params_from_numpy(ref_params, device="cpu")
    once = pc.cast_params(f32, cfg.dtype)
    assert sum(t.dtype == torch.float32 for t in pc.tree_leaves(once)) == 4
    toks = _tokens(cfg, seed=5)
    sa, ca = _prefill_decode(f32, cfg, toks)
    sb, cb = _prefill_decode(once, cfg, toks)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb, strict=True))
    assert all(torch.equal(ca[f"layer_{i}"][k], t)
               for i in range(cfg.n_layers) for k, t in cb[f"layer_{i}"].items())


def test_full_config_and_cache():
    """xlstm-125m: 12 blocks of d 768, 4 heads, sLSTM at 3 and 7; an
    mLSTM's state is C (B, 4, 384, 384) f32, an sLSTM's four (B, 4, 192),
    as the reference's spec says (nothing allocated)."""
    port, ref = configs.get_arch(NAME), ref_configs.get_arch(NAME)
    cfg = port.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.slstm_at, cfg.vocab,
            cfg.block_cfg.head_dim) == (12, 768, 4, (3, 7), 50304, 384)
    got, want = port.cache_spec(8, 2088), ref.cache_spec(8, 2088)
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "length":
            continue
        assert {k: (s.shape, s.axes, s.init) for k, s in got[key].items()} == \
            {k: (s.shape, s.axes, s.init) for k, s in want[key].items()}
    assert got["layer_0"]["c"].shape == (8, 4, 384, 384)
    assert got["layer_3"]["n"].shape == (8, 4, 192) and got["layer_3"]["n"].init == "ones"
