"""The port's shared model pieces (``repro_torch/models/common.py``)
against the reference's (``repro/models/common.py``): the same numpy
inputs, made from a seed, through both; f32 at the reference's
elementwise tolerance (rtol 1e-4, atol 1e-5, tests/test_kernels.py:15-17),
bf16 at its 2e-2.  Also the parameter specs: the port's ``count_params``
of the four dense full configs equals the reference's with nothing
allocated, and ``materialize`` keeps the reference's initializers."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import common as pc  # noqa: E402

#: port dtype, reference dtype, (rtol, atol)
DTYPES = {"f32": (torch.float32, jnp.float32, (1e-4, 1e-5)),
          "bf16": (torch.bfloat16, jnp.bfloat16, (2e-2, 2e-2))}


def _pair(tree, jdt):
    """A numpy tree as a reference tree of ``jdt`` arrays and the port's
    tree of the same bits."""
    if isinstance(tree, dict):
        pairs = {k: _pair(v, jdt) for k, v in tree.items()}
        return ({k: j for k, (j, _) in pairs.items()},
                {k: t for k, (_, t) in pairs.items()})
    j = jnp.asarray(tree, jdt)
    return j, params_from_numpy(np.asarray(j), device="cpu")


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol):
    (w,) = params_from_numpy({"w": np.asarray(want, np.float32)},
                             device="cpu").values()
    ok, err, bound = compare(got.float(), w, tol=tol)
    assert ok, (err, bound)


@pytest.mark.parametrize("dt", DTYPES)
def test_rmsnorm_matches_reference(dt):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(0)
    (w, x), (pw, px) = zip(*(_pair(a, jdt) for a in (
        _rand(rng, 64) + 1.0, _rand(rng, 2, 9, 64, scale=3.0))))
    got = pc.rmsnorm(pw, px, 1e-6)
    assert got.dtype == tdt
    _close(got, jc.rmsnorm(w, x, 1e-6), tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_layernorm_matches_reference(dt):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(1)
    p, pp = _pair({"scale": _rand(rng, 48) + 1.0, "bias": _rand(rng, 48)},
                  jnp.float32)
    x, px = _pair(_rand(rng, 3, 5, 48, scale=2.0) + 0.5, jdt)
    got = pc.layernorm(pp, px)
    assert got.dtype == tdt
    _close(got, jc.layernorm(p, x), tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("dt", DTYPES)
def test_rope_matches_reference(dt, fraction):
    """Angles and the interleaved-pair rotation, whole and partial (GLM4's
    half), on positions of a cache offset; the rotation comes back in
    f32 from a bf16 input, as the reference's promotion gives."""
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    pos = (np.arange(7)[None] + np.array([[0], [300]])).astype(np.int32)
    cos, sin, rot = jc.rope_angles(jnp.asarray(pos), 32, theta=10000.0,
                                   fraction=fraction)
    pcos, psin, prot = pc.rope_angles(torch.from_numpy(pos), 32,
                                      theta=10000.0, fraction=fraction)
    assert prot == rot == int(32 * fraction)
    _close(pcos, cos, DTYPES["f32"][2])
    _close(psin, sin, DTYPES["f32"][2])
    x, px = _pair(_rand(rng, 2, 7, 4, 32), jdt)
    got = pc.apply_rope(px, pcos, psin, prot)
    want = jc.apply_rope(x, cos, sin, rot)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, tol)
    if fraction < 1:  # the dims past rot pass through untouched
        assert torch.equal(got[..., rot:], px[..., rot:].float())


@pytest.mark.parametrize("dt", DTYPES)
def test_swiglu_matches_reference(dt):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(3)
    spec = pc.swiglu_spec(64, 160)
    p, pp = _pair({k: _rand(rng, *s.shape, scale=0.15) for k, s in spec.items()},
                  jnp.float32)
    x, px = _pair(_rand(rng, 2, 6, 64), jdt)
    got = pc.swiglu(pp, px)
    assert got.dtype == tdt
    _close(got, jc.swiglu(p, x), tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_gelu_mlp_matches_reference(dt):
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(4)
    spec = pc.gelu_mlp_spec(64, 128)
    p, pp = _pair({k: _rand(rng, *s.shape, scale=0.15) for k, s in spec.items()},
                  jnp.float32)
    x, px = _pair(_rand(rng, 2, 6, 64), jdt)
    got = pc.gelu_mlp(pp, px)
    assert got.dtype == tdt
    _close(got, jc.gelu_mlp(p, x), tol)


@pytest.mark.parametrize("dt", DTYPES)
def test_embed_unembed_match_reference(dt):
    """The gather is exact; the unembedding within tolerance."""
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(5)
    table, ptable = _pair(_rand(rng, 96, 32), jnp.float32)
    toks = rng.integers(0, 96, (3, 7)).astype(np.int32)
    got = pc.embed(ptable, torch.from_numpy(toks))
    assert torch.equal(got, params_from_numpy(
        np.asarray(jc.embed(table, jnp.asarray(toks))), device="cpu"))
    w, pw = _pair(_rand(rng, 32, 96, scale=0.2), jnp.float32)
    x, px = _pair(_rand(rng, 3, 7, 32), jdt)
    out = pc.unembed(pw, px)
    assert out.dtype == tdt
    _close(out, jc.unembed(w, x), tol)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("masked", [False, True])
def test_xents_match_reference(masked, z_loss):
    """``masked_xent`` over a padded vocabulary (the pad columns never
    win) with and without a mask, and ``softmax_xent``, with and without
    the z-loss."""
    rng = np.random.default_rng(6)
    logits = _rand(rng, 2, 5, 80, scale=3.0)
    logits[..., 70:] += 50.0                       # pad columns: masked out
    labels = rng.integers(0, 70, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32) if masked else None
    want = jc.masked_xent(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask),
                          vocab=70, vocab_padded=80, z_loss=z_loss)
    got = pc.masked_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask),
                         vocab=70, vocab_padded=80, z_loss=z_loss)
    _close(got, want, DTYPES["f32"][2])
    want = jc.softmax_xent(jnp.asarray(logits[..., :70]), jnp.asarray(labels),
                           z_loss=z_loss)
    got = pc.softmax_xent(torch.from_numpy(logits[..., :70]),
                          torch.from_numpy(labels), z_loss=z_loss)
    _close(got, want, DTYPES["f32"][2])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_matches_reference_without_allocation(name, monkeypatch):
    """The four dense full configs (1.9 B to 111 B parameters) count as
    the reference counts them; nothing is drawn or allocated."""
    def no_alloc(*a, **kw):
        raise AssertionError("count_params allocated a tensor")

    for fn in ("zeros", "ones", "randn", "empty"):
        monkeypatch.setattr(torch, fn, no_alloc)
    want = jc.count_params(ref_arch(name).param_spec())
    assert pc.count_params(get_arch(name).param_spec()) == want
    assert get_arch(name).n_params == want


def test_materialize_keeps_the_reference_initializers():
    """Shapes, dtypes and leaf order as the reference's tree; ones and
    zeros exact; normal leaves at the fan-in-scaled (or given) standard
    deviation; the same generator seed draws the same tree."""
    spec = {"b": pc.layernorm_spec(64), "a": pc.swiglu_spec(64, 256),
            "emb": pc.embedding_spec(512, 64)}
    params = pc.materialize(spec, torch.Generator().manual_seed(0),
                            device="cpu")
    assert list(params) == sorted(spec)
    assert [tuple(t.shape) for t in pc.tree_leaves(params)] == [
        s.shape for s in pc.tree_leaves(spec)]
    assert torch.equal(params["b"]["scale"], torch.ones(64))
    assert torch.equal(params["b"]["bias"], torch.zeros(64))
    for t, fan_in in ((params["a"]["w_gate"], 64), (params["a"]["w_down"], 256)):
        assert t.dtype == torch.float32
        assert abs(float(t.std()) * math.sqrt(fan_in) - 1.0) < 0.05
    assert abs(float(params["emb"].std()) - 1.0) < 0.05
    again = pc.materialize(spec, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(pc.tree_leaves(params),
                                                 pc.tree_leaves(again)))
    bf = pc.materialize(spec, torch.Generator().manual_seed(0), torch.bfloat16,
                        device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in pc.tree_leaves(bf))
