"""The port's optimizer (``repro_torch/optim``) against the reference's
(``repro/optim``) on the same numpy inputs.

One AdamW step from a state with non-zero moments at count 3, f32, bf16
and int8 moments, clipping and weight decay each on and off:
``adamw_update`` + ``apply_updates`` and the in-place ``adamw_step``
(the same bits) against the reference's.  Parameters, updates and f32
moments within 1e-6 relative (of each element, or of the leaf's largest
where ``b1 * mu`` and ``(1 - b1) * g`` cancel: the clip factor, from the
norm's sum in another order, may part by an ulp); bf16 moments equal or
one bf16 ulp apart;
int8 ``q`` equal, or 1 apart only where the f32 value ``mu / scale`` lies
within two f32 ulps of a half-way tie (the two sides' f32 moments may
part by an ulp), their scales within 1e-6.  ``_quantize`` bit for bit
on ties, zero rows, the 1e-12 floor and +-127; the schedules at rtol
1e-6 (``torch.cos`` against ``jnp.cos``); ``global_norm`` at 1e-6; the
state specs against ``adamw_init``.  Then the reference's seven oracles
(tests/test_optim.py) on the port."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.common import ParamSpec as RefParamSpec  # noqa: E402
from repro.optim import adamw as R  # noqa: E402
from repro.optim import schedule as RS  # noqa: E402
from repro_torch.convert import params_from_numpy, state_from_numpy  # noqa: E402
from repro_torch.models.common import ParamSpec, tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig,
    adamw_init,
    adamw_step,
    adamw_update,
    apply_updates,
    global_norm,
    opt_state_spec,
)
from repro_torch.optim import adamw as P  # noqa: E402
from repro_torch.optim.schedule import (  # noqa: E402
    constant,
    cosine,
    linear_warmup_cosine,
)

SHAPES = {"w": (8, 16), "b": (16,), "s": (2, 3, 5)}
LR = 3e-4


def _tree(rng, scale=1.0, positive=False) -> dict:
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32)
           for k, s in SHAPES.items()}
    return {k: np.abs(v) if positive else v for k, v in out.items()}


def _stored(tree: dict, mdt: str) -> dict:
    """f32 moments as the reference stores them at ``mdt``, as numpy."""
    if mdt == "f32":
        return tree
    if mdt == "bf16":
        return {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16))
                for k, v in tree.items()}
    return {k: dict(zip(("q", "scale"), map(np.asarray, R._quantize(
        jnp.asarray(v))))) for k, v in tree.items()}


def _case(mdt: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    params, grads = _tree(rng), _tree(rng, scale=2.0)
    state = {"mu": _stored(_tree(rng, 0.1), mdt),
             "nu": _stored(_tree(rng, 0.1, positive=True), mdt),
             "count": np.asarray(3, np.int32)}
    return params, grads, state


def _ref_step(params, grads, state, kw):
    jt = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    upd, new_state, metrics = R.adamw_update(
        jt(grads), jt(state), jt(params), R.AdamWConfig(**kw), RS.constant(LR))
    new_params = R.apply_updates(jt(params), upd)
    return jax.tree.map(np.asarray, (upd, new_state, new_params, metrics))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _check_int8(got, want, mu_f32) -> int:
    """q equal, or 1 apart only near a half-way tie; returns how many."""
    q, scale = got["q"].numpy().astype(int), got["scale"].numpy()
    np.testing.assert_allclose(scale, want["scale"], rtol=1e-6)
    off = q != want["q"].astype(int)
    assert np.abs(q - want["q"])[off].max(initial=0) <= 1
    t = (mu_f32 / scale)[off]
    tie = np.abs(np.abs(t) - (np.floor(np.abs(t)) + 0.5))
    assert np.all(tie <= 2 * np.spacing(np.abs(t).astype(np.float32))), t
    return int(off.sum())


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("mdt", ["f32", "bf16", "int8"])
def test_adamw_step_matches_reference(mdt, clip, wd):
    kw = {"moment_dtype": mdt, "grad_clip_norm": clip, "weight_decay": wd}
    params, grads, state = _case(mdt, seed=int(clip * 10 + wd * 100))
    upd, new_state, new_params, metrics = _ref_step(params, grads, state, kw)

    cfg = AdamWConfig(**kw)
    p = params_from_numpy(params, device="cpu")
    s = state_from_numpy(state, device="cpu")
    got_upd, got_state, got_metrics = adamw_update(
        params_from_numpy(grads, device="cpu"), s, p, cfg, constant(LR))
    assert got_state is s and int(s["count"]) == 4
    apply_updates(p, got_upd)
    p2, s2 = params_from_numpy(params, device="cpu"), state_from_numpy(
        state, device="cpu")
    m2 = adamw_step(params_from_numpy(grads, device="cpu"), s2, p2, cfg,
                    constant(LR))
    for a, b in zip(tree_leaves(p) + tree_leaves(s), tree_leaves(p2)
                    + tree_leaves(s2)):
        assert torch.equal(a, b)
    assert torch.equal(m2["grad_norm"], got_metrics["grad_norm"])

    for k in SHAPES:
        np.testing.assert_allclose(_np(got_upd[k]), upd[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(upd[k]).max())
        np.testing.assert_allclose(_np(p[k]), new_params[k], rtol=1e-6,
                                   atol=1e-9)
    np.testing.assert_allclose(float(got_metrics["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-6)
    assert float(got_metrics["lr"]) == float(metrics["lr"])
    near_ties = 0
    for key in ("mu", "nu"):
        for k in SHAPES:
            got, want = s[key][k], new_state[key][k]
            if mdt == "f32":
                np.testing.assert_allclose(_np(got), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max())
            elif mdt == "bf16":
                w = np.asarray(want, np.float32)
                ulp = np.spacing(np.abs(w).astype(np.float32)) * 2 ** 16
                assert np.all(np.abs(_np(got) - w) <= ulp)
            else:
                near_ties += _check_int8(got, want, _mu_f32(
                    key, k, grads, state, metrics, kw))
    assert near_ties <= 4


def _mu_f32(key, k, grads, state, metrics, kw) -> np.ndarray:
    """The port's f32 moment before it is quantized, recomputed with its
    own arithmetic (the ties test reads it)."""
    cfg = AdamWConfig(**kw)
    gnorm = torch.tensor(float(metrics["grad_norm"]))
    clip = (torch.clamp(torch.tensor(cfg.grad_clip_norm) / gnorm, max=1.0)
            if cfg.grad_clip_norm else torch.tensor(1.0))
    gf = torch.from_numpy(grads[k]) * clip
    m = P._load_moment(params_from_numpy(state[key][k], device="cpu"), cfg)
    if key == "mu":
        return (cfg.b1 * m + (1 - cfg.b1) * gf).numpy()
    return (cfg.b2 * m + (1 - cfg.b2) * gf * gf).numpy()


def test_quantize_ties_zero_rows_and_limits():
    x = np.array([[0.5, 1.5, 2.5, -2.5, -0.5, 127.0],       # scale 1: ties
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],           # zero row
                  [1e-13, -1e-13, 0.0, 5e-14, 0.0, 0.0],    # under the floor
                  [254.0, -127.0, 1.0, 3.0, -254.0, 0.0]],  # +-127, -63.5
                 np.float32)
    q, scale = P._quantize(torch.from_numpy(x))
    rq, rscale = map(np.asarray, R._quantize(jnp.asarray(x)))
    assert np.array_equal(q.numpy(), rq) and q.dtype == torch.int8
    assert np.array_equal(scale.numpy(), rscale)
    assert list(q.numpy()[0]) == [0, 2, 2, -2, 0, 127]
    assert list(q.numpy()[3][:2]) == [127, -64] and q.numpy()[3][4] == -127
    assert not q.numpy()[1].any()
    back = P._dequantize(q, scale).numpy()
    assert np.array_equal(back, np.asarray(R._dequantize(jnp.asarray(rq),
                                                         jnp.asarray(rscale))))


def test_schedules_match_reference():
    pairs = [(constant(1e-3), RS.constant(1e-3)),
             (cosine(1e-3, 100), RS.cosine(1e-3, 100)),
             (cosine(2e-4, 50, final_fraction=0.0),
              RS.cosine(2e-4, 50, final_fraction=0.0)),
             (linear_warmup_cosine(3e-4, 10, 100),
              RS.linear_warmup_cosine(3e-4, 10, 100))]
    for port, ref in pairs:
        for s in range(0, 121, 3):
            got = port(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(ref(jnp.asarray(s))),
                                       rtol=1e-6)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = {**_tree(rng), "big": rng.standard_normal((64, 257)).astype(np.float32)}
    got = global_norm(params_from_numpy(tree, device="cpu"))
    want = R.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("mdt", ["f32", "bf16", "int8"])
def test_state_spec_matches_reference_and_init(mdt):
    spec = {"w": ParamSpec((8, 4), ("embed", "mlp")),
            "b": ParamSpec((4,), ("mlp",), init="zeros")}
    rspec = {"w": RefParamSpec((8, 4), ("embed", "mlp")),
             "b": RefParamSpec((4,), ("mlp",), init="zeros")}
    cfg = AdamWConfig(moment_dtype=mdt)
    ours = tree_leaves(opt_state_spec(spec, cfg))
    real = tree_leaves(adamw_init(tree_map(lambda s: torch.zeros(s.shape),
                                           spec), cfg))
    refs = jax.tree.leaves(R.opt_state_spec(rspec, R.AdamWConfig(
        moment_dtype=mdt)), is_leaf=lambda x: isinstance(x, RefParamSpec))
    assert len(ours) == len(real) == len(refs)
    for s, t, r in zip(ours, real, refs):
        assert s.shape == tuple(t.shape) == r.shape and s.dtype == t.dtype
        assert str(s.dtype).removeprefix("torch.") in (
            str(np.dtype(r.dtype)), "bfloat16")


# ---------------------------------------------------------------------------
# the reference's oracles (tests/test_optim.py) on the port
# ---------------------------------------------------------------------------


def _params():
    return {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]]),
            "b": torch.zeros((2,))}


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor(5.0)}
    cfg = AdamWConfig(weight_decay=0.0, grad_clip_norm=0.0)
    state = adamw_init(params, cfg)
    sched = constant(0.1)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}          # d/dw w^2
        upd, state, _ = adamw_update(grads, state, params, cfg, sched)
        params = apply_updates(params, upd)
    assert abs(float(params["w"])) < 0.5


@pytest.mark.parametrize("mdt", ["f32", "bf16", "int8"])
def test_moment_dtypes_agree_on_direction(mdt):
    params = _params()
    cfg = AdamWConfig(moment_dtype=mdt, weight_decay=0.0)
    state = adamw_init(params, cfg)
    grads = tree_map(torch.ones_like, params)
    upd, state, _ = adamw_update(grads, state, params, cfg, constant(1e-2))
    for u in tree_leaves(upd):
        assert bool((u < 0).all())              # positive grad -> negative step


def test_int8_moments_close_to_f32():
    w = torch.linspace(-1, 1, 64).reshape(8, 8)
    grads = {"w": torch.ones((8, 8)) * 0.3}
    cfg32 = AdamWConfig(moment_dtype="f32", weight_decay=0.0)
    cfg8 = AdamWConfig(moment_dtype="int8", weight_decay=0.0)
    p32, p8 = {"w": w.clone()}, {"w": w.clone()}
    s32, s8 = adamw_init(p32, cfg32), adamw_init(p8, cfg8)
    for _ in range(10):
        adamw_step(grads, s32, p32, cfg32, constant(1e-2))
        adamw_step(grads, s8, p8, cfg8, constant(1e-2))
    np.testing.assert_allclose(p32["w"].numpy(), p8["w"].numpy(), rtol=0.05,
                               atol=5e-3)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros((4,))}
    cfg = AdamWConfig(grad_clip_norm=1.0, weight_decay=0.0)
    state = adamw_init(params, cfg)
    huge = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(huge, state, params, cfg, constant(1.0))
    assert float(metrics["grad_norm"]) > 1e5     # reported pre-clip


def test_opt_state_spec_matches_init_structure():
    pspec = {"w": ParamSpec((8, 4), ("embed", "mlp")),
             "b": ParamSpec((4,), ("mlp",), init="zeros")}
    for mdt in ("f32", "bf16", "int8"):
        cfg = AdamWConfig(moment_dtype=mdt)
        params = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype), pspec)
        st_real = adamw_init(params, cfg)
        st_abs = opt_state_spec(pspec, cfg)
        shape_of = lambda t: tree_map(lambda _: None, t)  # noqa: E731
        assert shape_of(st_real) == shape_of(st_abs)
        for a, b in zip(tree_leaves(st_real), tree_leaves(st_abs)):
            assert tuple(a.shape) == b.shape and a.dtype == b.dtype


@given(st.floats(1e-5, 1.0), st.integers(1, 50), st.integers(51, 500))
@settings(max_examples=20, deadline=None)
def test_schedule_properties(peak, warm, total):
    sched = linear_warmup_cosine(peak, warm, total)
    lrs = [float(sched(torch.tensor(s))) for s in range(0, total, 7)]
    assert all(0 <= lr <= peak * (1 + 1e-6) for lr in lrs)
    # warmup is nondecreasing
    warm_lrs = [float(sched(torch.tensor(s))) for s in range(warm)]
    assert all(b >= a - 1e-9 for a, b in zip(warm_lrs, warm_lrs[1:]))


@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1,
                max_size=8))
@settings(max_examples=30, deadline=None)
def test_global_norm_matches_numpy(xs):
    tree = {"x": torch.tensor(xs, dtype=torch.float32)}
    want = np.linalg.norm(np.asarray(xs, np.float32))
    got = float(global_norm(tree))
    assert got == pytest.approx(want, rel=1e-4, abs=1e-4)
