"""The port's copy of the analytic model against the reference's: Eq. 1
and the notations, the Table I stream counts, the overlap calibration,
the two-term step model, the GPU machine and stream-ECM model, and the
batched Eq. 1 (``ECMBatch`` and ``eq1_predictions``)."""
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ecm as jecm  # noqa: E402
from repro.core import kernel_spec as jspec  # noqa: E402
from repro.core import tpu_ecm as jtpu  # noqa: E402
from repro_torch.benchmarks.gpu_stream_ecm import gpu_stream_ecm  # noqa: E402
from repro_torch.convert import spec_from_dict  # noqa: E402
from repro_torch.core import gpu_ecm  # noqa: E402
from repro_torch.core.ecm import ECMBatch, ECMModel, eq1_predictions  # noqa: E402
from repro_torch.core.kernel_spec import BENCHMARKS  # noqa: E402
from repro_torch.core.machine import H100_SXM, GPUMachineModel  # noqa: E402

TIMES = [0.0, 0.5, 1.0, 2.0, 3.0, 7.25]


@pytest.mark.parametrize("name", sorted(jspec.PAPER_TABLE1_INPUTS))
def test_ecm_model_matches_reference(name):
    s = jspec.PAPER_TABLE1_INPUTS[name]
    got, want = ECMModel.parse(s, name=name), jecm.ECMModel.parse(s, name=name)
    assert got.predictions() == want.predictions()
    assert got.notation() == want.notation()
    assert got.prediction_notation() == want.prediction_notation()
    assert got.t_core == want.t_core
    for level in want.levels:
        assert got.prediction(level) == want.prediction(level)
    assert got.predictions() == pytest.approx(
        jspec.PAPER_TABLE1_PREDICTIONS[name], abs=0.051)


def test_ecm_model_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        ECMModel(t_ol=1, t_nol=0, transfers=(1.0,), levels=("L1",))
    with pytest.raises(ValueError):
        ECMModel(t_ol=-1, t_nol=0, transfers=(1.0,), levels=("L1", "Mem"))
    with pytest.raises(ValueError):
        ECMModel.parse("{1 | 2 | 3}")
    m = ECMModel.parse("{1 || 2 | 3}")
    with pytest.raises(KeyError):
        m.prediction("L9")
    with pytest.raises(IndexError):
        m.prediction(5)


@pytest.mark.parametrize("name", sorted(jspec.BENCHMARKS))
def test_specs_through_spec_from_dict(name):
    ref = jspec.BENCHMARKS[name]
    got = spec_from_dict(dataclasses.asdict(ref))
    assert got == BENCHMARKS[name]
    for prop in ("load_streams", "l1_evict_streams", "mem_streams",
                 "l2_streams"):
        assert getattr(got, prop) == getattr(ref, prop), prop


def test_spec_from_dict_rejects_unknown_fields():
    d = dataclasses.asdict(jspec.BENCHMARKS["copy"]) | {"bogus": 1}
    with pytest.raises(TypeError):
        spec_from_dict(d)


def test_overlap_calibration_matches_reference():
    for a, b, c in itertools.product(TIMES, repeat=3):
        assert gpu_ecm.overlap_coefficient(a, b, c) == \
            jtpu.overlap_coefficient(a, b, c)
        assert gpu_ecm.measured_overlap(a, b, c) == \
            jtpu.measured_overlap(a, b, c)


def test_step_ecm_matches_reference():
    for t_comp, t_hbm in itertools.product(TIMES, repeat=2):
        for f in (0.0, 0.25, 0.5, 1.0):
            got = gpu_ecm.StepECM("s", t_comp, t_hbm, exposed_hbm_fraction=f)
            want = jtpu.TPUStepECM("s", t_comp, t_hbm, 0.0,
                                   exposed_hbm_fraction=f)
            assert got.t_ecm == want.t_ecm
            assert got.t_roofline == want.t_roofline
        for ts, tp in itertools.product(TIMES, repeat=2):
            got = gpu_ecm.with_measured_overlap(
                gpu_ecm.StepECM("s", t_comp, t_hbm), t_serial_s=ts,
                t_pipelined_s=tp)
            want = jtpu.with_measured_overlap(
                jtpu.TPUStepECM("s", t_comp, t_hbm, 0.0), t_serial_s=ts,
                t_pipelined_s=tp)
            assert got.exposed_hbm_fraction == want.exposed_hbm_fraction
            assert got.t_ecm == want.t_ecm


def _props(name):
    return types.SimpleNamespace(
        name=name, multi_processor_count=132, L2_cache_size=52428800,
        total_memory=85 * 10**9, shared_memory_per_block_optin=232448)


def test_machine_from_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _props("NVIDIA H100 80GB HBM3"))
    m = GPUMachineModel.from_device(0)
    assert (m.sm_count, m.l2_bytes, m.smem_per_block_optin) == \
        (132, 52428800, 232448)
    assert (m.hbm_bytes_per_s, m.peak_f32_flops) == (3.35e12, 67e12)
    assert m.peak_bf16_tensor_flops == 989e12
    assert set(m.priors) == {"hbm_bytes_per_s", "peak_f32_flops",
                             "peak_bf16_tensor_flops", "clock_hz",
                             "nvlink_bytes_per_s", "net_bytes_per_s"}
    # the data sheet's 900 GB/s of NVLink, counted each way; the DGX
    # H100's network, one 400 Gb/s port a card
    assert m.nvlink_bytes_per_s == 450e9
    assert m.net_bytes_per_s == 50e9
    assert m.exposed_hbm_fraction == 0.0
    # the FP32 peak is the lanes at the clock: 132 x 128 x 2 x 1.98 GHz
    assert 2 * m.sm_count * m.fp32_lanes_per_sm * m.clock_hz == \
        pytest.approx(m.peak_f32_flops, rel=0.01)
    with pytest.raises(dataclasses.FrozenInstanceError):
        m.exposed_hbm_fraction = 0.5


def test_machine_refuses_unknown_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _props("NVIDIA Some Other Card"))
    with pytest.raises(ValueError, match="data-sheet"):
        GPUMachineModel.from_device(0)


@pytest.mark.parametrize("name", ["load", "ddot", "store", "update", "copy",
                                  "striad", "schoenauer"])
def test_gpu_stream_ecm(name):
    """Per 128-lane row: the HBM term moves (loads + stores + nt_stores)
    x 512 B at the data-sheet rate (no RFO); the FP32-lane term is one
    lane-cycle per operation per element over all SMs."""
    e = gpu_stream_ecm(name, H100_SXM)
    spec = BENCHMARKS[name]
    streams = spec.loads_explicit + spec.stores + spec.nt_stores
    bpc = H100_SXM.hbm_bytes_per_s / H100_SXM.clock_hz
    assert e.transfers == pytest.approx((streams * 512 / bpc,))
    assert e.levels == ("REG", "HBM") and e.t_nol == 0.0
    assert e.t_ol == pytest.approx(max((spec.uop_fma + spec.uop_mul
                                        + spec.uop_add) / 2, 1) / 132)
    # memory-bound: the prediction is the HBM time of the row
    assert e.prediction("HBM") == pytest.approx(e.transfers[0])


def _random_batch(seed, shape=(5,), edges=3):
    rng = np.random.default_rng(seed)
    t_ol = rng.uniform(0, 4, shape)
    t_nol = rng.uniform(0, 2, shape)
    transfers = rng.uniform(0, 3, shape + (edges,))
    transfers[..., 0] *= rng.integers(0, 2, shape)      # some zero terms
    return t_ol, t_nol, transfers


@pytest.mark.parametrize("shape,edges", [((5,), 3), ((2, 4), 1), ((7,), 2),
                                         ((), 3)])
def test_ecm_batch_matches_reference(shape, edges):
    args = _random_batch(len(shape) * 10 + edges, shape, edges)
    levels = tuple(f"L{i}" for i in range(edges + 1))
    got = ECMBatch(*args, levels=levels)
    want = jecm.ECMBatch(*args, levels=levels)
    assert np.array_equal(got.predictions(), want.predictions())
    assert np.array_equal(got.t_data(), want.t_data())
    assert np.array_equal(got.t_core, want.t_core)
    for level in (0, -1, levels[-1]):
        assert np.array_equal(got.prediction(level), want.prediction(level))
        assert np.array_equal(got.core_bound(level), want.core_bound(level))
        assert np.array_equal(got.performance(64.0, level, clock_hz=2e9),
                              want.performance(64.0, level, clock_hz=2e9))
    assert np.array_equal(got.scaled(1.7).predictions(),
                          want.scaled(1.7).predictions())
    assert got.batch_shape == want.batch_shape and len(got) == len(want)
    if shape:
        f = np.linspace(0.5, 2.0, int(np.prod(shape))).reshape(shape)
        assert np.array_equal(got.scaled(f).transfers, want.scaled(f).transfers)
        for i in range(len(got)):
            g, w = got.scalar(i), want.scalar(i)
            assert (g.t_ol, g.t_nol, g.transfers) == (w.t_ol, w.t_nol, w.transfers)
            assert g.predictions() == w.predictions()


def test_ecm_batch_from_models_matches_scalar():
    models = [ECMModel.parse(s, name=n)
              for n, s in sorted(jspec.PAPER_TABLE1_INPUTS.items())]
    batch = ECMBatch.from_models(models)
    assert batch.names == tuple(m.name for m in models)
    for i, m in enumerate(models):
        assert tuple(batch.predictions()[i]) == m.predictions()
        assert batch.scalar(i) == m
    with pytest.raises(ValueError):
        ECMBatch.from_models([models[0], ECMModel(1, 0, (1.0,),
                                                  levels=("L1", "Mem"))])


@pytest.mark.parametrize("name", sorted(jspec.PAPER_TABLE1_INPUTS))
def test_ecm_model_scalar_methods_match_reference(name):
    s = jspec.PAPER_TABLE1_INPUTS[name]
    got, want = ECMModel.parse(s), jecm.ECMModel.parse(s)
    for level in range(len(want.levels)):
        assert got.core_bound(level) == want.core_bound(level)
        assert got.performance(8.0, level) == want.performance(8.0, level)
        assert got.performance(8.0, level, 2.3e9) == \
            want.performance(8.0, level, 2.3e9)
    assert got.scaled(0.37).predictions() == want.scaled(0.37).predictions()


@pytest.mark.parametrize("seed", range(4))
def test_eq1_predictions_match_reference(seed):
    """The port's ``eq1_predictions`` is the reference's, bit for bit in
    f64, on a random batch."""
    args = _random_batch(seed, (3, 4), 3)
    assert np.array_equal(eq1_predictions(*args), jecm.eq1_predictions(*args))


def test_empty_measured_bw_is_the_data_sheet():
    """With no calibration, the stream and stencil models equal the ones
    built from the data-sheet rate, bit for bit."""
    from repro_torch.core.layer_condition import STENCILS

    for name in ("load", "copy", "striad", "schoenauer"):
        e = gpu_stream_ecm(name, H100_SXM)
        spec = BENCHMARKS[name]
        streams = spec.loads_explicit + spec.stores + spec.nt_stores
        assert e.transfers == (streams * 512 / H100_SXM.hbm_bytes_per_cycle(),)
    spec = dataclasses.replace(STENCILS["jacobi2d"], elem_bytes=4)
    step = gpu_ecm.gpu_stencil_ecm(spec, (8192, 8192), H100_SXM, 4)
    streams = gpu_ecm.stencil_hbm_streams(spec, (8192, 8192), H100_SXM)
    assert step.t_hbm == streams * 4 * 8192 * 8192 / H100_SXM.hbm_bytes_per_s
    fitted = dataclasses.replace(H100_SXM, measured_bw={"jacobi2d": 3.0e12})
    assert gpu_ecm.gpu_stencil_ecm(spec, (8192, 8192), fitted, 4).t_hbm == \
        streams * 4 * 8192 * 8192 / 3.0e12
