"""Port stream ops (plain path on the CPU) against the JAX reference's
grid kernels in interpret mode: the same numpy inputs, elementwise ops
bit for bit, sums within the tolerance of the one comparison helper."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.stream import ops as jops  # noqa: E402
from repro_torch.convert import streams_from_numpy  # noqa: E402
from repro_torch.kernels import pipeline as P  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.kernels.stream import kernel as K  # noqa: E402
from repro_torch.kernels.stream import ops  # noqa: E402

S, T = 1.7, -0.3
ROWS = [64, 33, 7]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(rows, jdt, seed=0):
    """Four streams as JAX arrays and, bit for bit, as port tensors."""
    rng = np.random.default_rng(seed)
    j = [jnp.asarray(rng.standard_normal(rows * 128).astype(np.float32), jdt)
         for _ in range(4)]
    return j, streams_from_numpy([np.asarray(x) for x in j], device="cpu")


def _port(name, ts, ns, tdt):
    a, b, c, d = ts
    n = a.numel()
    return {
        "load": lambda: ops.load(a, num_stages=ns),
        "ddot": lambda: ops.ddot(a, b, num_stages=ns),
        "store": lambda: ops.store(S, (n,), tdt, device="cpu", num_stages=ns),
        "update": lambda: ops.update(S, a, num_stages=ns),
        "copy": lambda: ops.copy(b, num_stages=ns),
        "striad": lambda: ops.striad(S, b, c, num_stages=ns),
        "schoenauer": lambda: ops.schoenauer(b, c, d, num_stages=ns),
        "triad_update": lambda: ops.triad_update(S, T, b, c, num_stages=ns),
    }[name]()


def _ref(name, js, ns, jdt):
    a, b, c, d = js
    n = a.shape[0]
    kw = dict(interpret=True, num_stages=ns)
    return {
        "load": lambda: jops.load(a, **kw),
        "ddot": lambda: jops.ddot(a, b, **kw),
        "store": lambda: jops.store(S, (n,), jdt, **kw),
        "update": lambda: jops.update(S, a, **kw),
        "copy": lambda: jops.copy(b, **kw),
        "striad": lambda: jops.striad(S, b, c, **kw),
        "schoenauer": lambda: jops.schoenauer(b, c, d, **kw),
        # the reference's fused chain runs only through the pipeline
        "triad_update": lambda: jops.triad_update(S, T, b, c, interpret=True,
                                                  num_stages=ns or 2),
    }[name]()


def check_against_reference(rows, dt, ns):
    """Every op of the port at depth ``ns`` against the reference's."""
    jdt, tdt = DTYPES[dt]
    js, ts = _inputs(rows, jdt)
    for name in ("load", "ddot", "store", "update", "copy", "striad",
                 "schoenauer", "triad_update"):
        got = _port(name, ts, ns, tdt)
        want = streams_from_numpy([np.asarray(_ref(name, js, ns, jdt))],
                                  device="cpu")[0]
        summed = ts[0] if name in ("load", "ddot") else None
        ok, err, tol = compare(got, want, summed_from=summed)
        assert ok, (name, rows, dt, ns, err, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("rows", ROWS)
def test_grid_ops_match_reference(rows, dt):
    check_against_reference(rows, dt, None)


@pytest.mark.parametrize("block", [64, 33, 7])
def test_grid_map_blocks_match_reference(block):
    """The map ops at the grid blocks the card checks (64 rows, and 33 and
    7, which the card's grid map runs as pieces shorter than 64 rows),
    against the reference's grid kernels at the same block, bit for bit,
    on rows that 33 and 7 divide."""
    rows = 2 * 33 * 7
    for dt, (jdt, tdt) in DTYPES.items():
        js, ts = _inputs(rows, jdt, seed=3)
        kw = dict(block_rows=block)
        for name, port, ref in (
                ("store", lambda: ops.store(S, (rows * 128,), tdt, device="cpu", **kw),
                 lambda: jops.store(S, (rows * 128,), jdt, interpret=True, **kw)),
                ("update", lambda: ops.update(S, ts[0], **kw),
                 lambda: jops.update(S, js[0], interpret=True, **kw)),
                ("copy", lambda: ops.copy(ts[1], **kw),
                 lambda: jops.copy(js[1], interpret=True, **kw)),
                ("striad", lambda: ops.striad(S, ts[1], ts[2], **kw),
                 lambda: jops.striad(S, js[1], js[2], interpret=True, **kw)),
                ("schoenauer", lambda: ops.schoenauer(*ts[1:], **kw),
                 lambda: jops.schoenauer(*js[1:], interpret=True, **kw))):
            want = streams_from_numpy([np.asarray(ref())], device="cpu")[0]
            ok, err, _ = compare(port(), want)
            assert ok, (name, block, dt, err)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_outputs_identical_across_paths(dt):
    """Inside the port the full matrix of paths, None/1/2/3, agrees bit
    for bit, sums included."""
    _, tdt = DTYPES[dt]
    _, ts = _inputs(33, DTYPES[dt][0], seed=1)
    for name in ("load", "ddot", "store", "update", "copy", "striad",
                 "schoenauer", "triad_update"):
        base = _port(name, ts, None, tdt)
        for ns in (1, 2, 3):
            assert torch.equal(_port(name, ts, ns, tdt), base), (name, ns)


def test_striad_rmw_matches_reference():
    js, ts = _inputs(64, jnp.float32, seed=2)
    want = np.asarray(jops.striad_rmw(S, js[0], js[1], js[2]))
    got = ops.striad_rmw(S, ts[0], ts[1], ts[2])
    assert np.array_equal(got.numpy(), want)


def test_compare_fails_on_nan_elementwise():
    x = torch.randn(256)
    y = x.clone()
    assert compare(x, y) == (True, 0.0, 0.0)
    y[3] = float("nan")
    ok, err, _ = compare(y, x)
    assert not ok and err == float("inf")
    ok, err, _ = compare(y, y.clone())          # NaN in both: still not ok
    assert not ok and err == float("inf")


def test_compare_fails_on_nan_sum():
    a = torch.randn(1024)
    want = a.sum()
    assert compare(want.clone(), want, summed_from=a)[0]
    ok, err, tol = compare(torch.tensor(float("nan")), want, summed_from=a)
    assert not ok and err == float("inf") and tol > 0
    ok, _, _ = compare(torch.tensor(float("inf")), torch.tensor(float("inf")),
                       summed_from=a)
    assert not ok
    ok, err, tol = compare(want + 1.0, want, summed_from=a)
    assert not ok and err == pytest.approx(1.0) and tol < 1.0


def test_compare_sum_tolerance_follows_dtype():
    a32 = torch.zeros(10000)
    a16 = torch.zeros(10000, dtype=torch.bfloat16)
    zero = torch.tensor(0.0)
    assert compare(zero, zero, summed_from=a32)[2] == pytest.approx(0.1)
    assert compare(zero, zero, summed_from=a16)[2] == pytest.approx(1.0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper of a CUDA kernel launches on CUDA tensors or raises; it
    never computes the plain version itself."""
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        K.grid_map("copy", (), (x,), rows=8, dtype=x.dtype,
                   device=x.device, block_rows=64)
    with pytest.raises(ValueError, match="CUDA"):
        K.grid_reduce("load", (x,), block_rows=64)
    with pytest.raises(ValueError, match="CUDA"):
        P.reduce_pipeline("ddot", (x, x), num_stages=2, block_rows=64)
    assert K.GRID_MAP.launches == 0 and K.GRID_REDUCE.launches == 0
