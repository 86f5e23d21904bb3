"""The slices as a whole: the port's stream-ECM loop, stencil loop and
compute-bound loop (``run``) on the CPU against the reference's ops on the
same inputs."""
import inspect

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from benchmarks import tpu_stream_ecm  # noqa: E402
from repro.kernels.stencil import ops as jstencil  # noqa: E402
from repro.kernels.stream import ops as jops  # noqa: E402
from repro_torch.benchmarks import gpu_compute_ecm as GC  # noqa: E402
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


#: the reference's kernel_payload sizes (benchmarks/compute_bench.py):
#: matmul 256^3, causal attention at S = 256, d = 64, one head
COMPUTE_POINTS = {
    "matmul": GC.Point("matmul", (256, 256, 256)),
    "attention": GC.Point("attention", (1, 256, 256, 1, 1, 64), causal=True),
    "attention_gqa_decode": GC.Point("attention", (2, 1, 512, 4, 2, 64)),
}


@pytest.mark.parametrize("name", list(COMPUTE_POINTS))
def test_compute_run_on_cpu_matches_reference(name):
    """The compute loop on the CPU: the op's output at the model's pick
    against the reference's Pallas kernel (interpret mode) at the same
    tiling on the same inputs, within the reference's tolerance, which is
    also kernel_payload's matches_ref bound (max error below 1e-3)."""
    from repro.kernels.attention import ops as jatt
    from repro.kernels.matmul import ops as jmm

    point = COMPUTE_POINTS[name]
    report = GC.run(device="cpu", point=point)
    assert "timings" not in report and report["check"][0]
    assert report["ranked"][0]["block"] == report["block"]
    assert all(r["predicted_ms"] > 0 for r in report["ranked"])
    inputs = [jnp.asarray(t.numpy())
              for t in GC.make_inputs(point, torch.device("cpu"))]
    if point.op == "matmul":
        bm, bn, bk = report["block"]
        want = jmm.matmul(*inputs, bm=bm, bn=bn, bk=bk, interpret=True)
    else:
        bq, bk = report["block"]
        want = jatt.flash_attention(*inputs, causal=point.causal, bq=bq,
                                    bk=bk, interpret=True)
    (w,) = streams_from_numpy([np.asarray(want)], device="cpu")
    ok, err, tol = compare(report["output"], w,
                           tol=GC.TOLERANCE[point.op][point.dtype])
    assert ok and err < 1e-3, (err, tol)


def test_compute_run_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run() measures on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        GC.run()


def test_compute_loop_has_no_knob_without_a_caller():
    """run takes the device and the point, which the tests and
    chip_smoke.py set; timings what run hands it; the ops keep the
    reference's signatures less interpret."""
    from repro_torch.kernels.attention import ops as att
    from repro_torch.kernels.matmul import ops as mm

    assert list(inspect.signature(GC.run).parameters) == ["device", "point"]
    assert list(inspect.signature(GC.timings).parameters) == \
        ["point", "inputs", "ranked", "machine"]
    assert set(GC.POINTS) == {"matmul", "matmul_bf16", "attention_prefill",
                              "attention_decode"}
    assert list(inspect.signature(mm.matmul).parameters) == \
        ["x", "y", "bm", "bn", "bk", "out_dtype"]
    assert list(inspect.signature(att.flash_attention).parameters) == \
        ["q", "k", "v", "causal", "bq", "bk"]


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
