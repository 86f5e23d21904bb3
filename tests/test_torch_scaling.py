"""Chip scaling and energy on the port (``repro_torch.core.scaling``,
``repro_torch.core.energy``) against the reference's
``repro.core.scaling`` and ``repro.core.energy``: ``frequency_scale``,
``fill_domains`` and every ``ChipScaling`` method equal the reference's
bit for bit on the same ECM arrays, ``ChipPower`` values and clock grids
(a stand-in ``GPUMachineModel`` carries the reference Haswell's power and
nominal clock; the clock grids go to ``frequency_scale`` as in the
reference's engine); ``tests/test_energy.py``'s five claims hold through
the port's views, which equal the reference's; and the model side of the
energy sweep (``benchmarks/gpu_energy_ecm.py``), which runs without the
card."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ecm as jecm  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import haswell_ecm  # noqa: E402
from repro.core import scaling as jscal  # noqa: E402
from repro.core.machine import HASWELL_EP  # noqa: E402
from repro_torch.benchmarks import gpu_energy_ecm as EN  # noqa: E402
from repro_torch.benchmarks import gpu_scaling_ecm as SC  # noqa: E402
from repro_torch.core import energy, gpu_ecm, scaling  # noqa: E402
from repro_torch.core.ecm import ECMBatch, ECMModel  # noqa: E402
from repro_torch.core.machine import (H100_SXM, POWER_PRIORS,  # noqa: E402
                                      ChipPower)

FREQS = [1.2, 1.6, 2.0, 2.3, 2.7, 3.0]
WORK = 10e9 / 3 / 64        # tests/test_energy.py: 10 GB striad, CLs of A
HASWELL_POWER = ChipPower(**dataclasses.asdict(HASWELL_EP.power))
#: the reference Haswell's cores, power and nominal clock on a port machine
STAND_IN = dataclasses.replace(
    H100_SXM, sm_count=HASWELL_EP.cores, power=HASWELL_POWER,
    clock_hz=HASWELL_EP.nominal_ghz * 1e9)
#: a calibrated H100 stand-in: an L2 plateau and stream rates near what
#: the calibration fits on the card, its power the prior
H100_CAL = dataclasses.replace(
    H100_SXM, l2_bytes_per_s=7.18e12,
    measured_bw={"ddot": 3.21e12, "copy": 3.02e12, "striad": 3.10e12,
                 "_stream": 3.15e12})


def _batches(shape=(4,), levels=4, seed=0):
    """The same ECM arrays as a port and a reference batch; one element
    with no memory transfer (nothing to saturate)."""
    rng = np.random.default_rng(seed)
    t_ol = rng.uniform(1, 10, shape)
    t_nol = rng.uniform(0, 5, shape)
    tr = rng.uniform(0.5, 12, shape + (levels - 1,))
    tr.reshape(-1, levels - 1)[0, -1] = 0.0
    names = tuple(f"w{i}" for i in range(int(np.prod(shape))))
    lv = tuple(f"L{i}" for i in range(levels))
    return (ECMBatch(t_ol, t_nol, tr, levels=lv, names=names),
            jecm.ECMBatch(t_ol, t_nol, tr, levels=lv, names=names))


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("floor", [2.0 / 3.0, 0.5])
def test_frequency_scale_matches_reference(coupled, floor):
    got_in, want_in = _batches()
    kw = dict(f_nominal_ghz=2.3, bw_freq_coupled=coupled, coupling_floor=floor)
    got = scaling.frequency_scale(got_in, FREQS, **kw)
    want = jscal.frequency_scale(want_in, FREQS, **kw)
    for f in ("t_ol", "t_nol", "transfers"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.levels, got.names, got.unit) == (want.levels, want.names,
                                                 want.unit)
    assert np.array_equal(got.predictions(), want.predictions())


@pytest.mark.parametrize("cpd,domains", [(7, 2), (14, 1), (132, 1), (5, 3)])
@pytest.mark.parametrize("first", [True, False])
def test_fill_domains_matches_reference(cpd, domains, first):
    rng = np.random.default_rng(1)
    p1 = rng.uniform(0.01, 1, (3, 2))
    p_sat = rng.uniform(0.5, 4, (3, 2))
    p_sat[0, 0] = np.inf
    n = cpd * domains
    assert np.array_equal(
        scaling.fill_domains(p1, p_sat, n, cpd, domains, first),
        jscal.fill_domains(p1, p_sat, n, cpd, domains, first))


def _pair(cpd, domains, shape=(4,)):
    """A port and a reference ChipScaling on the same arrays: (W, F) over
    the Haswell clocks, the reference Haswell's power on both."""
    b, jb = _batches(shape)
    f = np.asarray(FREQS)
    sb = scaling.frequency_scale(b, f, f_nominal_ghz=2.3)
    jsb = jscal.frequency_scale(jb, f, f_nominal_ghz=2.3)
    kw = lambda s, batch: dict(  # noqa: E731
        names=batch.names, f_ghz=f, t_single=s.predictions()[..., -1],
        bottleneck=s.transfers[..., -1], t_ol=np.asarray(batch.t_ol, float),
        cores_per_domain=cpd, n_domains=domains)
    got = scaling.ChipScaling(machine=dataclasses.replace(
        STAND_IN, sm_count=cpd * domains), **kw(sb, b))
    want = jscal.ChipScaling(machine=HASWELL_EP, **kw(jsb, jb))
    return got, want


@pytest.mark.parametrize("cpd,domains", [(7, 2), (14, 1), (132, 1)])
def test_chip_scaling_matches_reference(cpd, domains):
    got, want = _pair(cpd, domains)
    assert got.cores == want.cores
    for m in ("core_bound", "n_saturation", "n_saturation_chip"):
        assert np.array_equal(getattr(got, m)(), getattr(want, m)()), m
    for f in (None, 1.2, 2.7):
        assert got.saturation_summary(f) == want.saturation_summary(f)
    w = np.linspace(1.0, 3.0, 4)[:, None]
    for args, kw in (((), {}), ((None, 2.0), {}), ((9,), {}),
                     ((None, w), {}), ((), {"fill_domains_first": False})):
        assert np.array_equal(got.performance(*args, **kw),
                              want.performance(*args, **kw))
    for kw in ({}, {"n_cores": 9}, {"fill_domains_first": False}):
        g, j = got.energy(WORK, **kw), want.energy(WORK, **kw)
        assert set(g) == set(j)
        for k in g:
            assert np.array_equal(g[k], j[k]), k
    for obj in ("performance", "energy", "edp"):
        assert got.operating_points(WORK, objective=obj, top=25) == \
            want.operating_points(WORK, objective=obj, top=25)
        assert got.best(WORK, objective=obj) == want.best(WORK, objective=obj)
    with pytest.raises(KeyError):
        got.operating_points(objective="watts")


def test_chip_scaling_grids_are_read_only():
    got, _ = _pair(14, 1)
    with pytest.raises(ValueError):
        got.n_saturation()[0, 0] = 1
    assert got.performance() is got.performance()


def test_scale_workloads_matches_reference_engine():
    """The port's entry on the one-SM ECMs equals the reference's engine
    fed the same ECMBatch, the card's one clock and power."""
    m = dataclasses.replace(H100_CAL, power=HASWELL_POWER)
    got = scaling.scale_workloads(EN.OPS, m)
    models = [gpu_ecm.one_sm_ecm(op, m) for op in EN.OPS]
    jb = jecm.ECMBatch.from_models([
        jecm.ECMModel(e.t_ol, e.t_nol, e.transfers, levels=e.levels,
                      unit=e.unit, name=e.name) for e in models])
    js = jscal.frequency_scale(jb, [1.98], f_nominal_ghz=m.nominal_ghz)
    want = jscal.ChipScaling(
        machine=HASWELL_EP, names=EN.OPS, f_ghz=np.asarray([1.98]),
        t_single=js.predictions()[..., -1], bottleneck=js.transfers[..., -1],
        t_ol=np.asarray(jb.t_ol), cores_per_domain=m.sm_count, n_domains=1)
    assert got.names == EN.OPS and got.cores == 132
    assert np.array_equal(got.f_ghz, want.f_ghz)
    assert np.array_equal(got.t_single, want.t_single)
    assert np.array_equal(got.bottleneck, want.bottleneck)
    for k, v in got.energy(1 << 19).items():
        assert np.array_equal(v, want.energy(1 << 19)[k]), k
    # the Eq. 2 points equal the ScalingModel's of the Eq. 2 sweep
    nominal = scaling.scale_workloads(EN.OPS, H100_CAL)
    assert nominal.f_ghz.tolist() == [H100_CAL.nominal_ghz]
    for i, op in enumerate(EN.OPS):
        assert nominal.n_saturation()[i, 0] == \
            SC.predicted(op, H100_CAL)["n_s_model"]


def test_one_sm_ecm_lives_in_the_model():
    assert SC.one_sm_ecm is gpu_ecm.one_sm_ecm
    assert SC.CTAS == gpu_ecm.SM_COUNTS


# ---------------------------------------------------------------------------
# tests/test_energy.py's claims, through the port's views
# ---------------------------------------------------------------------------


def _port_ecm(name):
    e = haswell_ecm(name)
    return ECMModel(e.t_ol, e.t_nol, e.transfers, levels=e.levels, unit=e.unit,
                    name=e.name)


def _grids(coupled: bool):
    fecm = energy.FrequencyScaledECM(_port_ecm("striad"), f_nominal_ghz=2.3,
                                     bw_freq_coupled=coupled)
    return energy.energy_grid(fecm, STAND_IN, f_ghz_list=FREQS,
                              total_work_units=WORK)


def test_race_to_idle_not_optimal():
    g = _grids(False)
    f, n, _ = energy.best_config(g["energy_J"], FREQS)
    assert (f, n) != (FREQS[-1], 14)


def test_energy_optimum_at_lowest_frequency():
    g = _grids(False)
    f, _, _ = energy.best_config(g["energy_J"], FREQS)
    assert f == FREQS[0]


def test_coupled_uarch_needs_higher_frequency():
    f_h, _, _ = energy.best_config(_grids(False)["edp_Js"], FREQS)
    f_s, _, _ = energy.best_config(_grids(True)["edp_Js"], FREQS)
    assert f_s > f_h


def test_uncoupled_beats_coupled_on_energy_and_edp():
    gh, gs = _grids(False), _grids(True)
    e_ratio = energy.best_config(gs["energy_J"], FREQS)[2] / \
        energy.best_config(gh["energy_J"], FREQS)[2]
    d_ratio = energy.best_config(gs["edp_Js"], FREQS)[2] / \
        energy.best_config(gh["edp_Js"], FREQS)[2]
    assert 1.05 < e_ratio < 1.35
    assert 1.15 < d_ratio < 1.65


def test_saturation_plateau():
    g = _grids(False)
    row, t_row = g["energy_J"][0], g["runtime_s"][0]
    assert t_row[13] == pytest.approx(t_row[7], rel=0.01)
    assert row[13] > row[7]


@pytest.mark.parametrize("coupled", [False, True])
@pytest.mark.parametrize("name", ["striad", "copy", "ddot", "load"])
def test_energy_views_match_reference(coupled, name):
    kw = dict(f_nominal_ghz=2.3, bw_freq_coupled=coupled)
    fecm = energy.FrequencyScaledECM(_port_ecm(name), **kw)
    jfecm = jenergy.FrequencyScaledECM(haswell_ecm(name), **kw)
    for f in FREQS:
        got, want = fecm.at_frequency(f), jfecm.at_frequency(f)
        assert (got.t_ol, got.t_nol, got.transfers, got.levels, got.name) == \
            (want.t_ol, want.t_nol, want.transfers, want.levels, want.name)
    grid_kw = dict(f_ghz_list=FREQS, total_work_units=WORK)
    got = energy.energy_grid(fecm, STAND_IN, **grid_kw)
    want = jenergy.energy_grid(jfecm, HASWELL_EP.power, n_cores_max=14,
                               **grid_kw)
    assert got == want
    for k in got:
        assert energy.best_config(got[k], FREQS) == \
            jenergy.best_config(want[k], FREQS)


# ---------------------------------------------------------------------------
# the card's prior and the energy sweep's model side
# ---------------------------------------------------------------------------


def test_h100_power_prior():
    """The prior reaches the data sheet's 700 W board limit with every SM
    at the boost clock; every term positive; the card's machine carries it
    and runs at one clock, its data sheet's."""
    p = POWER_PRIORS[H100_SXM.name]
    assert H100_SXM.power is p
    assert p.watts(132, 1.98) == pytest.approx(700.0, rel=1e-12)
    assert p.watts(0, 1.98) == p.idle_watts == 100.0
    per_sm = (p.static_per_core, p.dyn_lin * 1.98, p.dyn_quad * 1.98**2)
    assert all(t > 0 for t in per_sm)
    assert np.allclose(np.array(per_sm) / sum(per_sm), (0.2, 0.2, 0.6))
    assert H100_SXM.frequency_grid() == (H100_SXM.nominal_ghz,) == (1.98,)


def test_energy_sweep_model_side():
    rows = (1 << 26) // 128
    model = EN.predicted(H100_CAL, rows)
    cs = scaling.scale_workloads(EN.OPS, H100_CAL)
    g = cs.energy(rows)
    for i, op in enumerate(EN.OPS):
        m = model[op]
        assert list(m["joules"]) == list(SC.CTAS)
        for n in SC.CTAS:
            assert m["joules"][n] == g["energy_J"][i, 0, n - 1]
            assert m["seconds"][n] == g["runtime_s"][i, 0, n - 1]
            assert m["watts"][n] == H100_CAL.power.watts(n, 1.98)
            assert m["edp"][n] == m["joules"][n] * m["seconds"][n]
        best = {o: cs.best(rows, objective=o)[i]["n_cores"]
                for o in ("energy", "edp")}
        assert (m["energy_optimal"], m["edp_optimal"]) == \
            (best["energy"], best["edp"])
        assert m["energy_optimal_swept"] in SC.CTAS
        # past the model's saturation point its time is flat and each SM
        # adds its watts: the energy optimum is at n_S = ceil(T_1 / T_HBM),
        # or one below it, where n P_1 falls short of the cap by less than
        # the SM's share of the power
        assert m["n_s"] - 1 <= m["energy_optimal"] <= m["n_s"]
        # the model's time at n SMs is Eq. 2's P(n) of the Eq. 2 sweep
        p = SC.predicted(op, H100_CAL)["gbps"]
        nbytes = gpu_ecm.stream_count(op) * (1 << 26) * 4
        for n in SC.CTAS:
            assert nbytes / m["seconds"][n] / 1e9 == pytest.approx(p[n],
                                                                   rel=1e-12)


@pytest.mark.parametrize("joules,n_s,shows", [
    ({1: 9.0, 64: 2.0, 96: 2.1, 128: 2.2, 132: 2.3}, 64, True),
    ({1: 9.0, 64: 2.0, 96: 1.9, 128: 1.8, 132: 1.7}, 64, False),
    ({1: 9.0, 64: 2.0, 96: 1.9, 128: 1.8, 132: 1.7}, 132, False)])
def test_claim_ii_is_reported(joules, n_s, shows):
    got = EN.claim_ii(joules, n_s, ctas=tuple(joules))
    assert got["shows"] is shows
    assert got["last_over_n_s"] == joules[132] / joules[n_s]
    assert list(got["joules_past_n_s"]) == [n for n in joules if n >= n_s]


def test_energy_sweep_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="card"):
        EN.run(H100_CAL)
