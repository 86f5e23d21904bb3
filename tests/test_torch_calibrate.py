"""The port's calibration (``repro_torch.core.calibrate``), its machine
file and its CLI, on the CPU with a synthetic backend built from the
port's own forward model: the fit primitives equal the reference's on the
same inputs; known bandwidths, a known L2 plateau, a known knee and a
known pipeline pair are recovered; measurements at the prior snap every
field bit-identically; a response that does not bracket keeps its prior;
the machine file round-trips and refuses what it does not know; a warm
cache fits nothing; the CLI exits 0, 1 above the bound, and non-zero
without a card.  The synthetic card's power grid is its ``ChipPower``
over the SM counts (the power fit's own tests are in
``test_torch_power.py``)."""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibrate as jcal  # noqa: E402
from repro_torch.benchmarks import gpu_stream_ecm as G  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import diskcache  # noqa: E402
from repro_torch.core.gpu_ecm import (gpu_stencil_ecm, gpu_stream_ecm,  # noqa: E402
                                      measured_overlap, stream_count)
from repro_torch.core.layer_condition import STENCILS  # noqa: E402
from repro_torch.core.machine import (H100_SXM, MACHINE_SCHEMA_VERSION,  # noqa: E402
                                      load_machine_file, machine_from_dict,
                                      machine_to_dict, save_machine_file)
from repro_torch.launch import calibrate as cli  # noqa: E402

#: the synthetic card: sustained rates, a knee, an L2 plateau, a one-SM pair
TRUE_BW = {k: 2.9e12 + 0.04e12 * i for i, k in enumerate(cal.STREAM_KERNELS)}
TRUE_STENCIL_BW = {"jacobi2d": 2.71e12, "jacobi3d": 2.83e12}
TRUE_L2_RATE = 7.3e12
TRUE_CAP = int(0.8 * H100_SXM.l2_bytes)
PAIR = (22.3e-3, 13.2e-3, 13.2e-3)


class SyntheticBackend:
    """A card made of the port's forward model: stream sweeps blend the L2
    and HBM plateaus by the residence weight clamp(2C/ws - 1, 0, 1) of a
    cache of ``cap`` bytes; stencil sweeps are the model at their own
    rates with the layer condition of that cache."""

    name = "synthetic"

    def __init__(self, machine, *, bw=None, stencil_bw=None, l2_rate=TRUE_L2_RATE,
                 cap=TRUE_CAP, pair=PAIR, rfo_ratio=4 / 3, noise=0.0,
                 power=None, power_noise=0.0):
        self.machine = machine
        self.power = power or machine.power
        self.power_noise = power_noise
        self.bw = bw or TRUE_BW
        self.stencil_bw = stencil_bw or TRUE_STENCIL_BW
        self.l2_rate = l2_rate
        self.truth = dataclasses.replace(machine, l2_bytes=cap)
        self.pair = pair
        self.rfo_ratio = rfo_ratio
        self.noise = noise
        self.measured = 0

    def _l2(self, kernels):
        return np.array([stream_count(k) * 512 * self.machine.clock_hz
                         / self.l2_rate for k in kernels])

    def stream_sweep(self, kernels, sizes, *, sustained_bw=None):
        if sustained_bw is not None:
            return cal.stream_response(self.machine, kernels, sizes, sustained_bw)
        self.measured += 1
        hbm = cal.stream_response(self.machine, kernels, sizes, self.bw)
        w = np.clip(2 * self.truth.l2_bytes / np.asarray(sizes) - 1, 0, 1)
        out = w * self._l2(kernels)[:, None] + (1 - w) * hbm
        # alternating +-noise over the sizes: a spread the fit cannot remove
        return out * (1 + self.noise * (-1.0) ** np.arange(len(sizes)))

    def l2_sweep(self, name, sizes):
        """A line through the L2 plateau: 3 us of launch, then the rows at
        the L2 rate, with the same alternating noise."""
        rows = np.asarray(sizes) / (stream_count(name) * 512)
        secs = 3e-6 + rows * self._l2([name])[0] / self.machine.clock_hz
        return rows, secs * (1 + self.noise * (-1.0) ** np.arange(len(rows)))

    def stencil_sweep(self, name, ns, *, sustained_bw=None):
        if sustained_bw is not None:
            return cal.stencil_response(self.machine, name, ns, sustained_bw)
        return cal.stencil_response(self.truth, name, ns, self.stencil_bw[name])

    def pipeline_pair(self):
        return self.pair

    def power_grid(self, n_grid, f_grid):
        """``(F, N)`` watts of the synthetic card's ``ChipPower``, with an
        alternating +-power_noise over the SM counts."""
        self.measured += 1
        n = np.asarray(n_grid, float)
        wobble = 1 + self.power_noise * (-1.0) ** np.arange(len(n))
        return np.array([self.power.watts(n, f) * wobble for f in f_grid])

    def rfo_pair(self):
        return 1.0e-3, self.rfo_ratio * 1.0e-3

    def info(self):
        return {"synthetic": True}


@pytest.fixture
def cache_dir(tmp_path):
    prev = diskcache.set_cache_dir(tmp_path)
    diskcache.reset_counters()
    cal.reset_counters()
    yield tmp_path
    diskcache.restore_cache_dir(prev)


def _fits(report):
    return {f.field: f for f in report.fits}


# ---------------------------------------------------------------------------
# fit primitives against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fitted,prior,rtol", [
    (1.0, 1.0, 0.0), (1.04, 1.0, 0.05), (1.06, 1.0, 0.05), (0.5, 0.0, 0.05),
    (0.0, 0.0, 0.0), (3.2e12, 3.35e12, 0.05), (2.9e12, 3.35e12, 0.05)])
def test_snap_matches_reference(fitted, prior, rtol):
    assert cal._snap(fitted, prior, rtol) == jcal._snap(fitted, prior, rtol)


def test_rms_rel_and_crossings_match_reference():
    rng = np.random.default_rng(0)
    obs, pred = rng.uniform(1, 2, 16), rng.uniform(1, 2, 16)
    assert cal._rms_rel(obs, pred) == jcal._rms_rel(obs, pred)
    sizes = np.geomspace(1e3, 1e9, 200)
    curve = np.clip(np.log10(sizes) - 5, 0, 2)
    for level in (0.5, 1.0, 1.9, 5.0):
        assert cal._crossings(sizes, curve, level) == \
            jcal._crossings(sizes, curve, level)


@pytest.mark.parametrize("obs", [0.2, 1.0, 3.0, 1e-6, 1e6])
def test_bisect_bw_matches_reference(obs):
    def forward(bw):
        return 0.01 + 3e12 / bw
    assert cal._bisect_bw(forward, obs, 3.35e12) == \
        jcal._bisect_bw(forward, obs, 3.35e12)


def test_forward_model_is_the_ecm():
    """The stream response is the port's per-row ECM at the given rates,
    through ``ECMBatch``; the stencil response is ``gpu_stencil_ecm`` per
    lattice update."""
    sizes = cal.deep_sizes(H100_SXM)
    resp = cal.stream_response(H100_SXM, list(TRUE_BW), sizes, TRUE_BW)
    for i, (k, bw) in enumerate(TRUE_BW.items()):
        m = cal.with_bandwidths(H100_SXM, {k: bw})
        assert np.all(resp[i] == gpu_stream_ecm(k, m).prediction("HBM"))
    for name in cal.STENCIL_KERNELS:
        ns = cal.stencil_deep_widths(H100_SXM, name)
        got = cal.stencil_response(H100_SXM, name, ns, 2.5e12)
        m = cal.with_bandwidths(H100_SXM, {name: 2.5e12})
        spec = dataclasses.replace(STENCILS[name], elem_bytes=4)
        for n, g in zip(ns, got):
            shape = cal.stencil_shape(name, n)
            want = (gpu_stencil_ecm(spec, shape, m, 4).t_ecm
                    * H100_SXM.clock_hz / math.prod(shape))
            assert g == pytest.approx(want, rel=1e-12)


def test_sweep_geometry():
    """Deep stream sweeps at 16-128x L2; deep stencil widths 2-8x the
    first layer-condition break; the 240-point knee sweep from L2/16 to
    32x L2; the 64-width LC sweep a third to three times the 2D break."""
    c = H100_SXM.l2_bytes
    assert cal.deep_sizes(H100_SXM)[[0, -1]] == pytest.approx([16 * c, 128 * c])
    assert cal.stencil_break_width(H100_SXM, "jacobi2d") == c / 24
    assert cal.stencil_break_width(H100_SXM, "jacobi3d") == math.sqrt(c / 24)
    assert list(cal.stencil_deep_widths(H100_SXM, "jacobi3d")) == \
        [int(2 * math.sqrt(c / 24)), int(4 * math.sqrt(c / 24)),
         int(8 * math.sqrt(c / 24))]
    sizes = cal.capacity_sizes(H100_SXM)
    assert len(sizes) == 240 and sizes[[0, -1]] == pytest.approx([c / 16, 32 * c])
    assert len(cal.lc_widths(H100_SXM, c)) == 64
    l2 = cal.l2_plateau_sizes(H100_SXM)
    assert len(l2) == 16 and l2[[0, -1]] == pytest.approx([c / 8, c / 4])
    assert cal.stencil_shape("jacobi2d", 10) == (64, 10)
    assert cal.stencil_shape("jacobi3d", 10) == (16, 10, 10)


# ---------------------------------------------------------------------------
# synthetic recovery
# ---------------------------------------------------------------------------


def test_synthetic_recovery_no_snap():
    report = cal.calibrate(H100_SXM, backend=SyntheticBackend(H100_SXM),
                           snap_rtol=0.0, use_cache=False)
    fits, m = _fits(report), report.machine
    for k, bw in {**TRUE_BW, **TRUE_STENCIL_BW}.items():
        assert fits[f"measured_bw[{k}]"].fitted == pytest.approx(bw, rel=1e-9)
        assert m.measured_bw[k] == fits[f"measured_bw[{k}]"].adopted
        assert not fits[f"measured_bw[{k}]"].snapped
        assert fits[f"measured_bw[{k}]"].residual < 1e-9
    assert m.measured_bw["_stream"] == np.median(
        [m.measured_bw[k] for k in cal.STREAM_KERNELS])
    assert m.measured_bw["_stencil"] == np.median(
        [m.measured_bw[k] for k in cal.STENCIL_KERNELS])
    assert m.l2_bytes_per_s == pytest.approx(TRUE_L2_RATE, rel=1e-12)
    assert m.l2_bytes == pytest.approx(TRUE_CAP, rel=0.01)
    assert fits["sm.exposed_hbm_fraction"].fitted == measured_overlap(*PAIR)
    assert fits["sm.exposed_hbm_fraction"].residual < 1e-12
    # the overlap stays out of the machine; the data-sheet rates stay put
    assert m.exposed_hbm_fraction == H100_SXM.exposed_hbm_fraction
    assert (m.hbm_bytes_per_s, m.peak_f32_flops) == \
        (H100_SXM.hbm_bytes_per_s, H100_SXM.peak_f32_flops)
    assert m.write_allocate is False
    rfo = report.checks["rfo"]
    assert rfo["verdict"] == "no RFO" and rfo["ratio"] == pytest.approx(4 / 3)
    lc = report.checks["stencil_lc_breaks"]["L2"]
    assert lc["detected"] and lc["capacity_est"] == pytest.approx(TRUE_CAP, rel=0.05)
    assert report.checks["backend"] == {"synthetic": True}
    # a clean sweep: the L2 sweep's times lie on their line, and the knees
    # of the even and odd points differ by their log interpolation alone
    assert fits["l2_bytes_per_s"].residual < 1e-12
    assert report.residual_max("bandwidth") < 1e-9
    assert fits["l2_bytes"].residual == report.checks["capacity"]["knee_spread"]
    assert report.residual_max() < 1e-3
    # the capacity's rounding to whole bytes is its model gap
    assert fits["l2_bytes"].model_gap < 1e-7


def test_rfo_verdict_skips_the_overlap():
    """A ratio within 5 % of 1.0 says the card's stores read their line
    first: the machine gets ``write_allocate`` and no overlap is fitted."""
    report = cal.calibrate(H100_SXM, backend=SyntheticBackend(
        H100_SXM, rfo_ratio=1.02), snap_rtol=0.0, use_cache=False)
    assert report.machine.write_allocate is True
    assert report.checks["rfo"]["verdict"] == "RFO"
    assert "sm.exposed_hbm_fraction" not in _fits(report)


@pytest.mark.parametrize("ratio,verdict", [
    (4 / 3, "no RFO"), (1.30, "no RFO"), (1.27, "no RFO"), (1.40, "no RFO"),
    (1.26, "undetermined"), (1.117, "undetermined"), (1.41, "undetermined"),
    (1.06, "undetermined"), (1.04, "RFO"), (1.0, "RFO"), (0.96, "RFO"),
    (0.94, "undetermined")])
def test_rfo_verdict_band(ratio, verdict):
    """The ratio decides only within RFO_BAND of 4/3 or of 1.0."""
    assert cal.rfo_verdict(ratio, stream_count("striad")) == verdict


def test_undetermined_rfo_keeps_the_prior_and_fails_the_cli(capsys):
    """A ratio that fits neither answer (a slow ``striad``: 1.117) leaves
    ``write_allocate`` at its prior, fits no overlap, and the CLI exits 1."""
    backend = SyntheticBackend(H100_SXM, rfo_ratio=1.117)
    report = cal.calibrate(H100_SXM, backend=backend, snap_rtol=0.0,
                           use_cache=False)
    assert report.checks["rfo"]["verdict"] == "undetermined"
    assert report.machine.write_allocate is H100_SXM.write_allocate
    assert "sm.exposed_hbm_fraction" not in _fits(report)
    assert report.residual_max() < cal.MAX_FIT_RESIDUAL
    rc, _ = cli.run(["--no-snap", "--no-cache", "--quiet"], backend=backend)
    assert rc == 1
    assert "neither" in capsys.readouterr().err


def test_fit_above_the_data_sheet_is_refused(capsys):
    """A sustained rate above ``hbm_bytes_per_s`` (the model's traffic
    short of the kernel's) keeps the prior, whose misfit is the residual,
    so the CLI exits 1."""
    backend = SyntheticBackend(H100_SXM, stencil_bw={
        "jacobi2d": 1.14 * H100_SXM.hbm_bytes_per_s, "jacobi3d": 2.8e12})
    report = cal.calibrate(H100_SXM, backend=backend, snap_rtol=0.0,
                           use_cache=False)
    f = _fits(report)["measured_bw[jacobi2d]"]
    assert f.fitted == pytest.approx(1.14 * H100_SXM.hbm_bytes_per_s, rel=1e-9)
    assert f.adopted == f.prior == H100_SXM.hbm_bytes_per_s
    assert not f.snapped and "above the data sheet" in f.note
    assert f.residual > 0.1
    assert report.machine.measured_bw["jacobi2d"] == H100_SXM.hbm_bytes_per_s
    rc, _ = cli.run(["--no-snap", "--no-cache", "--quiet"], backend=backend)
    assert rc == 1
    assert "exceeds the bound" in capsys.readouterr().err


def test_measurements_at_the_prior_snap_bit_identically():
    prior = dataclasses.replace(H100_SXM, l2_bytes_per_s=TRUE_L2_RATE)
    hbm = prior.hbm_bytes_per_s
    backend = SyntheticBackend(
        prior, bw=dict.fromkeys(cal.STREAM_KERNELS, hbm),
        stencil_bw=dict.fromkeys(cal.STENCIL_KERNELS, hbm),
        cap=prior.l2_bytes, pair=(2.0, 1.0, 1.0))
    report = cal.calibrate(prior, backend=backend, use_cache=False)
    for f in report.fits:
        assert f.snapped and f.adopted == f.prior, f
    m = report.machine
    assert m.l2_bytes == prior.l2_bytes
    assert m.l2_bytes_per_s == prior.l2_bytes_per_s
    assert set(m.measured_bw.values()) == {hbm}
    for k in cal.STREAM_KERNELS:
        assert gpu_stream_ecm(k, m) == gpu_stream_ecm(k, prior)


def test_unbracketed_stencil_keeps_the_prior():
    backend = SyntheticBackend(H100_SXM, stencil_bw={
        "jacobi2d": 1e3 * H100_SXM.hbm_bytes_per_s, "jacobi3d": 2.8e12})
    report = cal.calibrate(H100_SXM, backend=backend, snap_rtol=0.0,
                           use_cache=False)
    f = _fits(report)["measured_bw[jacobi2d]"]
    assert f.adopted == f.prior == H100_SXM.hbm_bytes_per_s
    assert "does not bracket" in f.note
    assert "jacobi2d" not in report.machine.measured_bw


def test_noise_shows_in_the_residual():
    report = cal.calibrate(H100_SXM, backend=SyntheticBackend(
        H100_SXM, noise=0.03), snap_rtol=0.0, use_cache=False)
    assert report.residual_max("bandwidth") == pytest.approx(0.03, rel=0.05)
    # the L2 sweep's times spread about their line, and the knee moves
    # between the even and odd points
    fits = _fits(report)
    assert fits["l2_bytes_per_s"].residual == pytest.approx(0.03, rel=0.05)
    assert fits["l2_bytes"].residual > 0.02


# ---------------------------------------------------------------------------
# machine file
# ---------------------------------------------------------------------------


def _calibrated():
    return cal.calibrate(H100_SXM, backend=SyntheticBackend(H100_SXM),
                         snap_rtol=0.0, use_cache=False)


def test_machine_file_round_trip(tmp_path):
    report = _calibrated()
    for m in (H100_SXM, report.machine):
        assert machine_from_dict(machine_to_dict(m)) == m
        assert machine_from_dict(json.loads(json.dumps(machine_to_dict(m)))) == m
    path = report.save(tmp_path / "card.json")
    loaded, prov = load_machine_file(path, with_provenance=True)
    assert loaded == report.machine
    assert prov["calibrated_from"] == H100_SXM.name
    assert prov["residual_max"] == report.residual_max()
    assert len(prov["fits"]) == len(report.fits)
    again = save_machine_file(loaded, tmp_path / "again.json",
                              provenance=report.provenance())
    assert again.read_bytes() == path.read_bytes()


def test_machine_file_refuses_unknown_fields_and_schemas(tmp_path):
    d = machine_to_dict(H100_SXM) | {"not_a_field": 1}
    with pytest.raises(ValueError, match="unknown"):
        machine_from_dict(d)
    doc = {"schema": MACHINE_SCHEMA_VERSION + 1, "kind": "gpu-machine",
           "machine": machine_to_dict(H100_SXM)}
    with pytest.raises(ValueError, match="schema"):
        machine_from_dict(doc)
    doc = {"schema": MACHINE_SCHEMA_VERSION, "kind": "ecm-machine",
           "machine": machine_to_dict(H100_SXM)}
    with pytest.raises(ValueError, match="gpu-machine"):
        machine_from_dict(doc)
    path = tmp_path / "bare.json"
    path.write_text(json.dumps(machine_to_dict(H100_SXM)))
    with pytest.raises(ValueError, match="not a machine file"):
        load_machine_file(path)


def test_sustained_bw_walks_the_keys():
    m = dataclasses.replace(H100_SXM, measured_bw={"copy": 1.0, "_stream": 2.0})
    assert m.sustained_bw("copy", "_stream") == 1.0
    assert m.sustained_bw("striad", "_stream") == 2.0
    assert m.sustained_bw("jacobi2d", "_stencil") == m.hbm_bytes_per_s
    assert m.sustained_bw("jacobi2d", default=5.0) == 5.0
    assert dataclasses.replace(m, measured_bw={"_default": 3.0}).sustained_bw(
        "x") == 3.0


def test_bounds_stay_on_the_data_sheet():
    """A calibrated machine moves predictions, never a bound."""
    m = _calibrated().machine
    n = 1 << 26
    assert G._bound("striad", n, 12 * n, m) == G._bound("striad", n, 12 * n,
                                                        H100_SXM)
    assert gpu_stream_ecm("striad", m) != gpu_stream_ecm("striad", H100_SXM)


# ---------------------------------------------------------------------------
# cache and CLI
# ---------------------------------------------------------------------------


def test_warm_cache_fits_nothing(cache_dir):
    backend = SyntheticBackend(H100_SXM)
    cold = cal.calibrate(H100_SXM, backend=backend, snap_rtol=0.0)
    fits, measured = cal.CAL_COUNTERS["fits"], backend.measured
    assert fits == len(cold.fits) and not cold.from_cache
    diskcache.clear_memo()                      # as after a restart
    warm = cal.calibrate(H100_SXM, backend=backend, snap_rtol=0.0)
    assert warm.from_cache and cal.CAL_COUNTERS["cache_hits"] == 1
    assert cal.CAL_COUNTERS["fits"] == fits and backend.measured == measured
    assert warm.machine == cold.machine and warm.fits == cold.fits
    assert warm.checks == cold.checks
    # another tolerance is another entry
    cal.calibrate(H100_SXM, backend=backend, snap_rtol=0.05)
    assert cal.CAL_COUNTERS["fits"] > fits


def test_cli_with_a_backend(tmp_path, capsys):
    out = tmp_path / "card.json"
    argv = ["--no-snap", "--no-cache", "--machine-out", str(out)]
    rc, report = cli.run(argv, backend=SyntheticBackend(H100_SXM))
    assert rc == 0 and load_machine_file(out) == report.machine
    text = capsys.readouterr().out
    assert "measured_bw[striad]" in text and "no RFO" in text
    rc, _ = cli.run(["--no-snap", "--no-cache", "--quiet"],
                    backend=SyntheticBackend(H100_SXM, noise=0.03))
    assert rc == 1
    assert "exceeds the bound" in capsys.readouterr().err
    rc, _ = cli.run(["--no-snap", "--no-cache", "--max-residual", "0.05"],
                    backend=SyntheticBackend(H100_SXM, noise=0.03))
    assert rc == 0


def test_cli_warm_run_from_a_cache_dir(tmp_path):
    argv = ["--no-snap", "--cache-dir", str(tmp_path / "cache")]
    cal.reset_counters()
    assert cli.run(argv, backend=SyntheticBackend(H100_SXM))[0] == 0
    fits = cal.CAL_COUNTERS["fits"]
    rc, report = cli.run(argv, backend=SyntheticBackend(H100_SXM))
    assert rc == 0 and report.from_cache and cal.CAL_COUNTERS["fits"] == fits
    assert not diskcache.enabled() or diskcache.cache_dir() != tmp_path / "cache"


def test_no_card_no_fallback(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.benchmarks.gpu_calibrate import CardBackend

    assert cli.main(["--no-cache"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        CardBackend(H100_SXM)
