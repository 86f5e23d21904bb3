"""The differentiable collectives of ``dist/collectives.py`` on four
spawned gloo ranks (tests/_torch_dist.py; one spawn for the module):
each rank's output and vector-Jacobian product against the same
function computed on the whole tensor in one process.

* the sum over ``model`` on a ``(1, 4)`` mesh: its VJP the sum of the
  ranks' cotangents;
* the gather over ``model`` along dims 0 and -1: its VJP the rank's
  block of the summed cotangent (a reduce-scatter);
* the gather over the tuple group ``("data", "model")`` of a ``(2, 2)``
  mesh along dim 1 (``gather_entry``, JAX's block order): the same.

Each in f32 (the whole-tensor sums in f64, within 1e-6 of the largest)
and bf16 under the wide-sum rule: a bf16 sum over more than one rank is
taken in f32 and rounded once, in the backward as in the forward, so
the rank's result equals the whole tensor's f32 sum rounded once to
bf16, bit for bit.  The bf16 entries are drawn with magnitudes in [0.5,
4) (f32 sums of four of them are exact, and a sum rounded after each
add in bf16 would part from them); the tuple gather's bf16 case takes
small integers (its backward sums in two stages, one an axis, each
exact).  On a one-rank axis (a ``(4, 1)`` mesh) the sum and the gather
and their VJPs return their inputs' bits, and a ``max`` of a tensor that
requires grad raises ``ValueError`` (with grad off it reduces).
"""
import os

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402

WORLD = 4
SHAPE = (3, 8, 5)
#: case -> (mesh shape, axis, dim): ``dim`` None is the sum
CASES = {"sum": ((1, 4), "model", None),
         "gather0": ((1, 4), "model", 0),
         "gather-1": ((1, 4), "model", -1),
         "gather-tuple": ((2, 2), ("data", "model"), 1)}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _draw(seed: int, shape, dtype, case: str) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.float32:
        return torch.randn(shape, generator=g)
    if case == "gather-tuple":
        return torch.randint(-8, 9, shape, generator=g).to(dtype)
    x = torch.randn(shape, generator=g)
    return (x.sign() * (0.5 + x.abs().clamp_max(3.4))).to(dtype)


def _out_shape(case: str) -> tuple:
    dim = CASES[case][2]
    if dim is None:
        return SHAPE
    shape = list(SHAPE)
    shape[dim] *= WORLD
    return tuple(shape)


def _apply(case, x, mesh):
    from repro_torch.dist.collectives import (all_gather, all_reduce,
                                              gather_entry)

    _, axis, dim = CASES[case]
    if dim is None:
        return all_reduce(x, mesh, axis)
    if isinstance(axis, tuple):
        return gather_entry(x, mesh, axis, dim)
    return all_gather(x, mesh, axis, dim)


def _ranks(rank: int, out: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist.collectives import all_gather, all_reduce

    meshes = {shape: DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                                mesh_dim_names=("data", "model"))
              for shape in ((1, 4), (2, 2), (4, 1))}
    rec = {}
    for case, (shape, _, _) in CASES.items():
        for name, dtype in DTYPES.items():
            x = _draw(100 + rank, SHAPE, dtype, case).requires_grad_(True)
            c = _draw(200 + rank, _out_shape(case), dtype, case)
            y = _apply(case, x, meshes[shape])
            (g,) = torch.autograd.grad(y, x, c)
            rec[case, name] = (y.detach(), g)
    one = meshes[(4, 1)]
    for name, dtype in DTYPES.items():
        x = _draw(100 + rank, SHAPE, dtype, "sum").requires_grad_(True)
        c = _draw(200 + rank, SHAPE, dtype, "sum")
        ys = (all_reduce(x, one, "model"), all_gather(x, one, "model", -1))
        gs = torch.autograd.grad(ys, (x,), (c, c))[0]
        rec["one", name] = (all(torch.equal(y, x) for y in ys),
                            torch.equal(gs, 2 * c))
    x = _draw(300 + rank, SHAPE, torch.float32, "max").requires_grad_(True)
    try:
        all_reduce(x, meshes[(1, 4)], "model", "max")
        rec["max"] = "no error"
    except ValueError as e:
        rec["max"] = str(e)
    with torch.no_grad():
        m = all_reduce(x, meshes[(1, 4)], "model", "max")
    rec["max_no_grad"] = m
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("collectives_grad")
    spawn(_ranks, WORLD, out, str(out), timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _whole(case: str, dtype):
    """Each rank's output and VJP from the whole tensors (in f64 where
    the dtype is f32, in f32 for bf16), as the ranks' dtype."""
    dim = CASES[case][2]
    wide = torch.float64 if dtype == torch.float32 else torch.float32
    xs = [_draw(100 + r, SHAPE, dtype, case).to(wide).requires_grad_(True)
          for r in range(WORLD)]
    cs = [_draw(200 + r, _out_shape(case), dtype, case).to(wide)
          for r in range(WORLD)]
    if dim is None:
        ys = [sum(xs)] * WORLD
    else:
        # rank r = data * 2 + model holds block r of the gathered dim
        ys = [torch.cat(xs, dim=dim)] * WORLD
    gs = torch.autograd.grad(ys, xs, cs)
    return [y.detach().to(dtype) for y in ys], [g.to(dtype) for g in gs]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_vjp_matches_the_whole_tensor(case, dtype, ranks):
    ys, gs = _whole(case, DTYPES[dtype])
    for r, rec in enumerate(ranks):
        y, g = rec[case, dtype]
        assert y.dtype == g.dtype == DTYPES[dtype]
        if dtype == "bf16":
            assert torch.equal(y, ys[r]), (case, r)
            assert torch.equal(g, gs[r]), (case, r)
        else:
            for got, want in ((y, ys[r]), (g, gs[r])):
                err = float((got - want).abs().max())
                assert err <= 1e-6 * float(want.abs().max()), (case, r, err)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_rank_returns_the_same_bits(dtype, ranks):
    for rec in ranks:
        assert rec["one", dtype] == (True, True)


def test_max_under_grad_raises(ranks):
    # with grad off the max reduces over the (1, 4) mesh's model axis
    want = torch.stack([_draw(300 + r, SHAPE, torch.float32, "max")
                        for r in range(WORLD)]).amax(0)
    for rec in ranks:
        assert "has no gradient" in rec["max"], rec["max"]
        assert torch.equal(rec["max_no_grad"], want)
