"""Eq. 2 on the port (``repro_torch.core.saturation``) against the
reference's ``repro.core.saturation``: ``ScalingModel``, ``batch_curve``
and ``batch_saturation`` equal on the same ECM inputs, bandwidth-bound,
core-bound and ``cores``-capped; and the model side of the Eq. 2 sweep
(``benchmarks/gpu_scaling_ecm.py``), which runs without the card."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ecm as jecm  # noqa: E402
from repro.core import saturation as jsat  # noqa: E402
from repro_torch.benchmarks import gpu_scaling_ecm as SC  # noqa: E402
from repro_torch.core import saturation as sat  # noqa: E402
from repro_torch.core.ecm import ECMBatch, ECMModel  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.kernels import pipeline as P  # noqa: E402

#: (t_ol, t_nol, transfers): bandwidth-bound, core-bound at memory, and a
#: zero bottleneck term (linear scaling to the whole chip)
MODELS = [(2.0, 1.0, (1.0, 2.0, 9.1)), (12.0, 0.0, (0.5, 1.0, 2.0)),
          (1.0, 2.0, (2.0, 4.0, 0.0)), (0.0076, 0.0, (7.9, 0.68)),
          (4.0, 4.0, (0.0, 0.0, 3.0))]


def _pair(t_ol, t_nol, transfers):
    levels = tuple(f"L{i}" for i in range(len(transfers) + 1))
    return (ECMModel(t_ol, t_nol, transfers, levels=levels),
            jecm.ECMModel(t_ol, t_nol, transfers, levels=levels))


@pytest.mark.parametrize("args", MODELS)
@pytest.mark.parametrize("cores", [0, 1, 14, 132])
def test_scaling_model_matches_reference(args, cores):
    got, want = (sat.ScalingModel.from_ecm(e, cores=cores) if i == 0
                 else jsat.ScalingModel.from_ecm(e, cores=cores)
                 for i, e in enumerate(_pair(*args)))
    assert got.t_single == want.t_single
    assert got.core_bound == want.core_bound
    assert got.n_saturation == want.n_saturation
    for n in (1, 2, 7, 50, 132):
        assert got.performance(n, 512.0, 1.98e9) == \
            want.performance(n, 512.0, 1.98e9)
    assert got.curve(20, 3.0) == want.curve(20, 3.0)


@pytest.mark.parametrize("level", [-1, 0])
def test_batch_curve_and_saturation_match_reference(level):
    edges = {len(m[2]) for m in MODELS}
    for k in edges:
        rows = [m for m in MODELS if len(m[2]) == k]
        args = (np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
                np.array([r[2] for r in rows]))
        levels = tuple(f"L{i}" for i in range(k + 1))
        got, want = ECMBatch(*args, levels=levels), jecm.ECMBatch(*args,
                                                                 levels=levels)
        w = np.linspace(1.0, 2.0, len(rows))
        assert np.array_equal(
            sat.batch_curve(got, 40, w, 1.98e9, bottleneck_level=level),
            jsat.batch_curve(want, 40, w, 1.98e9, bottleneck_level=level))
        for cores in (0, 8, 132):
            assert np.array_equal(
                sat.batch_saturation(got, level, cores),
                jsat.batch_saturation(want, level, cores))


def _calibrated():
    return dataclasses.replace(
        H100_SXM, l2_bytes_per_s=8.42e12,
        measured_bw={"striad": 3.06e12, "_stream": 3.1e12})


def test_one_sm_ecm():
    """Per row on one SM: the lane operations on 128 lanes, then the
    row's bytes from L2 at the card's L2 rate over the SMs, then from HBM
    at the rate the card sustains for the op."""
    m = _calibrated()
    e = SC.one_sm_ecm("striad", m)
    row = 3 * 128 * 4
    assert e.levels == ("REG", "L2", "HBM") and e.t_nol == 0.0
    assert e.t_ol == 1.0                     # one FMA a lane
    assert e.transfers == (row * m.clock_hz / (8.42e12 / 132),
                           row * m.clock_hz / 3.06e12)
    assert SC.one_sm_ecm("copy", m).transfers[1] == \
        2 * 128 * 4 * m.clock_hz / 3.1e12    # the family key
    with pytest.raises(ValueError, match="calibrate"):
        SC.one_sm_ecm("striad", H100_SXM)


def test_predicted_saturation():
    m = _calibrated()
    p = SC.predicted("striad", m, t_one_cta_cy=60.0)
    e = SC.one_sm_ecm("striad", m)
    sm = sat.ScalingModel.from_ecm(e, cores=132)
    assert p["n_s_model"] == sm.n_saturation
    # (T_L2 + T_HBM) / T_HBM = 1 + 132 x 3.06 / 8.42
    assert p["n_s_model"] == int(np.ceil(1 + 132 * 3.06 / 8.42))
    assert p["n_s_from_one_cta"] == int(np.ceil(60.0 / e.transfers[1]))
    assert list(p["gbps"]) == list(SC.CTAS)
    assert p["gbps"][132] == pytest.approx(3.06e12 / 1e9)
    assert p["gbps"][1] == pytest.approx(3 * 512 * m.clock_hz
                                         / e.prediction("HBM") / 1e9)


def test_measured_saturation_point():
    gbps = {n: min(n * 60.0, 3000.0) for n in SC.CTAS}
    assert SC.saturation_point(gbps) == 48
    gbps = {n: 1.0 for n in SC.CTAS}
    assert SC.saturation_point(gbps) == 1


def test_one_cta_reserve_leaves_room_for_one(monkeypatch):
    """Two reserves do not fit an SM's shared memory (the opt-in limit of
    one block plus the 1 KiB each block keeps), one does."""
    props = types.SimpleNamespace(
        shared_memory_per_block_optin=H100_SXM.smem_per_block_optin)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
    r = P.one_cta_reserve(torch.device("cuda"))
    sm_bytes = H100_SXM.smem_per_block_optin + 1024
    assert r <= H100_SXM.smem_per_block_optin
    assert 2 * (r + 1024) > sm_bytes


def test_sweep_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="card"):
        SC.run(_calibrated())
