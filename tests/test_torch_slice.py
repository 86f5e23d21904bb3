"""The slices as a whole: the port's stream-ECM loop and stencil loop
(``run``) on the CPU against the reference's ops on the same inputs."""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import tpu_stream_ecm  # noqa: E402
from repro.kernels.stencil import ops as jstencil  # noqa: E402
from repro.kernels.stream import ops as jops  # noqa: E402
from repro_torch.benchmarks import gpu_stencil_ecm as GS  # noqa: E402
from repro_torch.benchmarks import gpu_stream_ecm as G  # noqa: E402
from repro_torch.convert import streams_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402

ROWS = 64


def test_run_on_cpu_matches_reference():
    report = G.run(device="cpu", rows=ROWS)
    ref_names = [row[0] for row in tpu_stream_ecm._validate()]
    assert list(report["outputs"]) == ref_names + ["triad_update"]
    assert list(report["outputs"]) == list(G.OPS)
    assert report["n"] == ROWS * 128 and "timings" not in report
    assert report["block_rows"] == {"grid": 64, "pipeline": 32}
    for op, checks in report["checks"].items():
        assert set(checks) == {"grid", "1", "2", "3"}
        assert all(ok for ok, _, _ in checks.values()), (op, checks)

    a, b, c, d = (jnp.asarray(x.numpy())
                  for x in G.make_streams(ROWS, torch.device("cpu")))
    n = ROWS * 128
    want = {
        "load": jops.load(a, interpret=True),
        "ddot": jops.ddot(a, b, interpret=True),
        "store": jops.store(G.S, (n,), jnp.float32, interpret=True),
        "update": jops.update(G.S, a, interpret=True),
        "copy": jops.copy(b, interpret=True),
        "striad": jops.striad(G.S, b, c, interpret=True),
        "schoenauer": jops.schoenauer(b, c, d, interpret=True),
        "triad_update": jops.triad_update(G.S, G.T, b, c, interpret=True),
    }
    summed_from = streams_from_numpy([np.asarray(a)], device="cpu")[0]
    for op, got in report["outputs"].items():
        w = streams_from_numpy([np.asarray(want[op])], device="cpu")[0]
        ok, err, tol = compare(got, w, summed_from=summed_from
                               if op in ("load", "ddot") else None)
        assert ok, (op, err, tol)


def test_run_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run() measures on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        G.run()


def test_no_knob_without_a_caller():
    """validate and pipeline_timings work out the pipeline block from the
    machine and take no tuning knobs; run's parameters are the device and
    the size, which the tests and chip_smoke.py set."""
    for fn in (G.validate, G.pipeline_timings):
        params = inspect.signature(fn).parameters
        assert list(params) == ["streams", "machine"]
        assert all(p.default is inspect.Parameter.empty
                   for p in params.values())
    assert list(inspect.signature(G.run).parameters) == ["device", "rows"]


@pytest.mark.parametrize("shape", [(24, 33), (7, 9, 11)], ids=str)
def test_stencil_run_on_cpu_matches_reference(shape):
    """The stencil loop on the CPU: every path checked, and the output
    equal to the reference's whole-array Pallas kernel in interpret mode.
    The loop's coefficients have c0 != 0, where the reference's paths
    round three ways (ROADMAP §3), so the reference is held at 1e-6 and
    its own oracle, ref.py, bit for bit."""
    from repro.kernels.stencil import ref as jref

    report = GS.run(device="cpu", shape=shape)
    assert report["shape"] == list(shape) and "timings" not in report
    assert report["stencil"] == f"jacobi{len(shape)}d"
    assert set(report["checks"]) == {"grid", "1", "2", "3"}
    assert all(ok for ok, _, _ in report["checks"].values())
    a = jnp.asarray(GS.make_grid(shape, torch.device("cpu")).numpy())
    c0, c1 = GS.COEFFS[len(shape)]
    jop = jref.jacobi2d if len(shape) == 2 else jref.jacobi3d
    want = streams_from_numpy([np.asarray(jop(a, c0, c1))], device="cpu")[0]
    assert compare(report["output"], want)[0]
    op = jstencil.jacobi2d if len(shape) == 2 else jstencil.jacobi3d
    pallas = np.asarray(op(a, c0=c0, c1=c1, interpret=True))
    assert np.abs(report["output"].numpy() - pallas).max() <= 1e-6


def test_stencil_run_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run() measures on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        GS.run()


def test_stencil_loop_has_no_knob_without_a_caller():
    """validate and timings take the array (and the machine); run takes
    the device and the shape, which the tests and chip_smoke.py set."""
    assert list(inspect.signature(GS.validate).parameters) == ["a"]
    assert list(inspect.signature(GS.timings).parameters) == ["a", "machine"]
    assert list(inspect.signature(GS.run).parameters) == ["device", "shape"]
    assert set(GS.POINTS) == {"2d", "3d", "3d_lc_broken"}


def test_streams_from_numpy_keeps_bits():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(1024).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t32, tb = streams_from_numpy([x, xb], device="cpu")
    assert t32.dtype == torch.float32 and np.array_equal(t32.numpy(), x)
    assert tb.dtype == torch.bfloat16
    assert np.array_equal(tb.view(torch.int16).numpy(), xb.view(np.int16))
    (cast,) = streams_from_numpy([x], device="cpu", dtype=torch.bfloat16)
    assert torch.equal(cast, tb)          # both round to nearest even
