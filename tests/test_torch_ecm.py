"""The port's copy of the analytic model against the reference's: Eq. 1
and the notations, the Table I stream counts, the overlap calibration,
the two-term step model, and the GPU machine and stream-ECM model."""
import dataclasses
import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from repro.core import ecm as jecm  # noqa: E402
from repro.core import kernel_spec as jspec  # noqa: E402
from repro.core import tpu_ecm as jtpu  # noqa: E402
from repro_torch.benchmarks.gpu_stream_ecm import gpu_stream_ecm  # noqa: E402
from repro_torch.convert import spec_from_dict  # noqa: E402
from repro_torch.core import gpu_ecm  # noqa: E402
from repro_torch.core.ecm import ECMModel  # noqa: E402
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
                             "peak_bf16_tensor_flops", "clock_hz"}
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
