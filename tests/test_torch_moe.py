"""The port's MoE FFN (``repro_torch/models/moe.py``) against the
reference's (``repro/models/moe.py``) on the reference's own parameters
(its ``materialize``, carried across with ``convert.params_from_numpy``):
the router, the capacity, and the three dispatch paths in f32 and bf16 at
capacity factors 1.25 and 0.25, the latter dropping half the assignments.
The reference's ``shard_map`` runs on its one-host mesh
(``make_host_mesh(model=1)``), as its serve launcher runs it.  Tolerances
are the reference's kernel tolerances (tests/test_kernels.py:15-17)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.dist.sharding import get_profile, use_mesh_context  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import moe  # noqa: E402

#: port dtype, reference dtype, (rtol, atol)
DTYPES = {"f32": (torch.float32, jnp.float32, (1e-4, 1e-5)),
          "bf16": (torch.bfloat16, jnp.bfloat16, (2e-2, 2e-2))}
D, E, K, F = 32, 8, 2, 16
#: 1024 tokens: 256 assignments an expert on average, so capacity factor
#: 0.25 (capacity 128, the floor) drops about half of them
SHAPE = (4, 256, D)
IMPLS = {"ref": (jmoe.moe_ffn_ref, moe.moe_ffn_ref),
         "scatter": (jmoe.moe_ffn_scatter, moe.moe_ffn_scatter),
         "shard_map": (None, moe.moe_ffn_shard_map)}


def _cfgs(factor: float = 1.25):
    return (jmoe.MoEConfig(E, K, F, capacity_factor=factor),
            moe.MoEConfig(E, K, F, capacity_factor=factor))


@pytest.fixture(scope="module")
def params():
    """The reference's parameters as numpy (f32), and the input."""
    p = jax.tree.map(np.asarray, ref_materialize(
        jmoe.moe_spec(D, _cfgs()[0]), jax.random.key(0)))
    x = np.random.default_rng(0).standard_normal(SHAPE).astype(np.float32)
    return p, x


def _inputs(params, dt):
    p, x = params
    tdt, jdt, _ = DTYPES[dt]
    return (p, jnp.asarray(x).astype(jdt), params_from_numpy(p, device="cpu"),
            torch.from_numpy(x).to(tdt))


def _close(got, want, tol):
    ok, err, bound = compare(got.float(), torch.from_numpy(np.array(want, np.float32)),
                             tol=tol)
    assert ok, (err, bound)


def _ref_shard_map(p, cfg, x):
    mesh = make_host_mesh(model=1)
    with use_mesh_context(mesh, get_profile("moe_ep")):
        return jax.jit(lambda p, x: jmoe.moe_ffn_shard_map(
            p, cfg, x, mesh=mesh))(p, x)


@pytest.mark.parametrize("dt", DTYPES)
def test_route_matches_reference(params, dt):
    """The same top-k ids in the same order, the renormalised weights in
    the compute dtype, the aux loss from the first choices."""
    jp, jx, pp, tx = _inputs(params, dt)
    jcfg, cfg = _cfgs()
    w, ids, aux = jmoe._route(jp, jcfg, jx.reshape(-1, D))
    got_w, got_ids, got_aux = moe._route(pp, cfg, tx.reshape(-1, D))
    assert got_w.dtype == DTYPES[dt][0] and got_ids.shape == (SHAPE[0] * SHAPE[1], K)
    assert np.array_equal(got_ids.numpy(), np.asarray(ids))
    _close(got_w, w, DTYPES[dt][2])
    _close(got_aux, aux, DTYPES["f32"][2])


def test_route_breaks_ties_to_the_lower_index():
    """``lax.top_k``'s order: equal probabilities go to the lower expert."""
    jcfg, cfg = _cfgs()
    router = np.zeros((D, E), np.float32)
    router[:, 5] = router[:, 2] = 1.0
    x = np.ones((3, D), np.float32)
    _, want, _ = jmoe._route({"router": jnp.asarray(router)}, jcfg, jnp.asarray(x))
    _, got, _ = moe._route({"router": torch.from_numpy(router)}, cfg,
                           torch.from_numpy(x))
    assert got.tolist() == np.asarray(want).tolist() == [[2, 5]] * 3


@pytest.mark.parametrize("n", [8, 80, 1024, 16384, 16416])
def test_capacity_matches_reference(n):
    """Rounded up to a multiple of 128: granite's prefill (16384 tokens)
    5120, its decode (8) 128; at ``n_experts / top_k`` it holds every
    token."""
    for factor in (1.25, 0.25, E / K, 4.0):
        jcfg, cfg = _cfgs(factor)
        assert moe._capacity(n, cfg) == jmoe._capacity(n, jcfg)
    granite = moe.MoEConfig(32, 8, 512)
    assert moe._capacity(16384, granite) == 5120
    assert moe._capacity(8, granite) == 128
    assert moe._capacity(n, moe.MoEConfig(32, 8, 512, capacity_factor=4.0)) >= n


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("impl,factor", [("ref", 1.25), ("scatter", 1.25),
                                         ("scatter", 0.25), ("shard_map", 1.25),
                                         ("shard_map", 0.25)])
def test_ffn_matches_reference(params, impl, factor, dt):
    jp, jx, pp, tx = _inputs(params, dt)
    jcfg, cfg = _cfgs(factor)
    ref_fn, port_fn = IMPLS[impl]
    want, want_aux = (ref_fn or _ref_shard_map)(jp, jcfg, jx)
    got, got_aux = port_fn(pp, cfg, tx)
    assert got.shape == SHAPE and got.dtype == DTYPES[dt][0]
    _close(got, want, DTYPES[dt][2])
    _close(got_aux, want_aux, DTYPES["f32"][2])


@pytest.mark.parametrize("dt", DTYPES)
def test_dropped_assignments_are_the_references(params, dt):
    """At capacity factor 0.25 an expert keeps its first 128 assignments
    in token order (the stable sort), as the reference's
    ``jnp.argsort`` keeps them: the port's kept set equals a numpy
    oracle on the reference's own ids, and about half are dropped."""
    jp, jx, pp, tx = _inputs(params, dt)
    jcfg, cfg = _cfgs(0.25)
    _, ids, _ = jmoe._route(jp, jcfg, jx.reshape(-1, D))
    flat = np.asarray(ids).reshape(-1)
    cap = jmoe._capacity(SHAPE[0] * SHAPE[1], jcfg)
    seen = np.zeros(E, int)
    want = np.zeros(flat.shape, bool)
    for i, e in enumerate(flat):
        want[i] = seen[e] < cap
        seen[e] += 1
    _, got_ids, _ = moe._route(pp, cfg, tx.reshape(-1, D))
    sort_idx, _, pos = moe._dispatch(got_ids.reshape(-1), E)
    kept = torch.zeros(flat.shape, dtype=torch.bool)
    kept[sort_idx] = pos < cap
    assert np.array_equal(kept.numpy(), want)
    assert 0.3 < 1 - want.mean() < 0.7


def test_ref_equals_scatter_when_nothing_drops(params):
    _, _, pp, tx = _inputs(params, "f32")
    _, cfg = _cfgs(E / K)
    ref, ref_aux = moe.moe_ffn_ref(pp, cfg, tx)
    for fn in (moe.moe_ffn_scatter, moe.moe_ffn_shard_map):
        got, aux = fn(pp, cfg, tx)
        _close(got, ref.numpy(), DTYPES["f32"][2])
        assert torch.equal(aux, ref_aux)


def test_shard_map_combine_adds_in_scatter_order(params):
    """The one-shard combine (each token's k rows added one after
    another in expert-sorted order) equals the reference's
    ``zeros.at[token_of].add(contrib)`` done as a CPU ``index_add_``
    (which adds in index order), bit for bit in bf16."""
    _, _, pp, tx = _inputs(params, "bf16")
    _, cfg = _cfgs()
    got, _ = moe.moe_ffn_shard_map(pp, cfg, tx)
    xf = tx.reshape(-1, D)
    weights, ids, _ = moe._route(pp, cfg, xf)
    n, cap = xf.shape[0], moe._capacity(xf.shape[0], cfg)
    sort_idx, sorted_ids, pos = moe._dispatch(ids.reshape(-1), E)
    buf = torch.zeros((E, cap, D), dtype=xf.dtype)
    buf[sorted_ids, pos] = xf[sort_idx // K]           # nothing drops here
    h = moe._expert_ffn(pp["w_gate"], pp["w_up"], pp["w_down"], buf)
    contrib = h[sorted_ids, pos] * weights.reshape(-1)[sort_idx][:, None]
    want = torch.zeros((n, D), dtype=xf.dtype).index_add_(0, sort_idx // K, contrib)
    assert torch.equal(got.reshape(n, D), want)


def test_more_than_one_model_shard_raises(params):
    """Expert weights of more than one model shard (here one shard's half
    of the experts) with no mesh raise, as the reference's ``moe_ffn``
    asserts a mesh for ``shard_map``; whole weights with no mesh are the
    one-shard body.  The multi-shard body runs on a mesh in
    ``tests/test_torch_moe_mesh.py``."""
    _, _, pp, tx = _inputs(params, "f32")
    _, cfg = _cfgs()
    half = {**pp, **{k: pp[k][:E // 2] for k in ("w_gate", "w_up", "w_down")}}
    with pytest.raises(ValueError, match="2 model shards needs a mesh"):
        moe.moe_ffn_shard_map(half, cfg, tx)
    shard_map = moe.MoEConfig(E, K, F, impl="shard_map")
    with pytest.raises(ValueError, match="needs a mesh"):
        moe.moe_ffn(half, shard_map, tx)
    out, _ = moe.moe_ffn(pp, shard_map, tx)
    assert torch.equal(out, moe.moe_ffn_shard_map(pp, cfg, tx)[0])
