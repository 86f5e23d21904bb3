"""The power fit (``repro_torch.core.calibrate._fit_power``), the card's
power reader (``repro_torch.benchmarks.power``) and the machine file's
schema 2, on the CPU.

The fit takes a synthetic backend whose power grid is a known
``ChipPower`` over the SM counts: with 3 or more clocks it equals the
reference's fit; with one clock it recovers the idle draw and the per-SM
slope and splits the slope in the prior's proportions, every field
positive, with a note; a noisy grid above the residual bound fails the
CLI.  The card's power sweep refuses a grid read off its clock or under
a power cap or heat, before anything is fitted.  The reader runs with its NVML calls and the CUDA calls around its
window replaced by fakes: it raises without a card or a library, picks
the card by PCI bus id, and bills no busy-wait."""
import ast
import contextlib
import ctypes
import dataclasses
import inspect
import json
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibrate as jcal  # noqa: E402
from repro.core.machine import HASWELL_EP  # noqa: E402
from repro_torch.benchmarks import gpu_calibrate as GC  # noqa: E402
from repro_torch.benchmarks import power as PW  # noqa: E402
from repro_torch.core import calibrate as cal  # noqa: E402
from repro_torch.core import diskcache  # noqa: E402
from repro_torch.core.machine import (H100_SXM, MACHINE_SCHEMA_VERSION,  # noqa: E402
                                      POWER_PRIORS, ChipPower,
                                      GPUMachineModel, load_machine_file, machine_from_dict,
                                      machine_to_dict, save_machine_file)
from repro_torch.launch import calibrate as cli  # noqa: E402
from test_torch_calibrate import SyntheticBackend  # noqa: E402

#: a card whose per-SM power splits otherwise than the prior's: static
#: heavy, and 4.1 W an SM at 1.98 GHz over 131 W idle
TRUE_POWER = ChipPower(idle_watts=131.0, static_per_core=2.5, dyn_lin=0.5,
                       dyn_quad=0.155)
HASWELL_POWER = ChipPower(**dataclasses.asdict(HASWELL_EP.power))


@dataclasses.dataclass(frozen=True)
class Clocked(GPUMachineModel):
    """A port machine with a grid of clocks, as a card whose clocks can
    be set would carry; the port's own machine runs at one."""

    clocks: tuple = ()

    def frequency_grid(self):
        return self.clocks


def clocked(machine, clocks, **changes):
    return Clocked(**{f.name: getattr(machine, f.name)
                      for f in dataclasses.fields(machine)},
                   clocks=tuple(clocks), **changes)


class PowerBackend:
    """Only a power grid: ``power`` over the SM counts at each clock, with
    an alternating +-noise over the counts."""

    name = "power-only"

    def __init__(self, power, noise=0.0):
        self.power, self.noise = power, noise

    def power_grid(self, n_grid, f_grid):
        n = np.asarray(n_grid, float)
        wobble = 1 + self.noise * (-1.0) ** np.arange(len(n))
        return np.array([self.power.watts(n, f) * wobble for f in f_grid])


def _fit(machine, backend, snap_rtol=0.0):
    meas, fits, checks = [], [], {}
    power = cal._fit_power(machine, backend, snap_rtol, meas, fits, checks)
    return power, {f.field: f for f in fits}, checks, meas


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise", [0.0, 0.004, 0.03])
@pytest.mark.parametrize("snap_rtol", [0.0, 0.05])
def test_three_clocks_equal_the_reference(noise, snap_rtol, monkeypatch):
    """With the reference Haswell's clocks, cores and power on both sides,
    and its grid of every core, the port's fit is the reference's OLS:
    the same fits, the same adopted ChipPower."""
    monkeypatch.setattr(cal, "power_counts",
                        lambda m: tuple(range(1, m.sm_count + 1)))
    truth = dataclasses.replace(HASWELL_POWER, idle_watts=27.0, dyn_quad=2.0)
    m = clocked(dataclasses.replace(H100_SXM, sm_count=HASWELL_EP.cores,
                                    power=HASWELL_POWER),
                HASWELL_EP.frequency_grid())
    backend = PowerBackend(truth, noise)
    got, fits, _, meas = _fit(m, backend, snap_rtol)
    jmeas, jfits = [], []
    want = jcal._fit_power(HASWELL_EP, backend, snap_rtol, jmeas, jfits)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.as_dict() for f in fits.values()] == [f.as_dict() for f in jfits]
    assert [(k, v.tolist()) for k, v in meas] == \
        [(k, v.tolist()) for k, v in jmeas]
    if noise == 0.0:
        for nm in cal.POWER_FIELDS:
            assert getattr(got, nm) == pytest.approx(getattr(truth, nm),
                                                     rel=1e-9)


def test_two_clocks_keep_the_priors():
    m = clocked(H100_SXM, (1.5, 1.98))
    got, fits, _, meas = _fit(m, PowerBackend(TRUE_POWER))
    assert got == m.power and not meas
    assert all(f.snapped and "priors retained" in f.note for f in fits.values())


def test_one_clock_recovers_idle_and_slope():
    """One clock: the intercept and the per-SM slope are exact, the slope
    splits in the prior's proportions at that clock, and every field stays
    positive where the rule "lin and quad keep their priors" would not."""
    f = H100_SXM.nominal_ghz
    prior = H100_SXM.power
    got, fits, checks, meas = _fit(H100_SXM, PowerBackend(TRUE_POWER))
    per_sm = lambda p: p.static_per_core + p.dyn_lin * f + p.dyn_quad * f * f  # noqa: E731
    assert got.idle_watts == pytest.approx(TRUE_POWER.idle_watts, rel=1e-12)
    assert per_sm(got) == pytest.approx(per_sm(TRUE_POWER), rel=1e-12)
    scale = per_sm(TRUE_POWER) / per_sm(prior)
    for nm in ("static_per_core", "dyn_lin", "dyn_quad"):
        assert getattr(got, nm) == pytest.approx(scale * getattr(prior, nm),
                                                 rel=1e-12)
    assert all(getattr(got, nm) > 0 for nm in cal.POWER_FIELDS)
    for nm in cal.POWER_FIELDS:
        fit = fits[f"power.{nm}"]
        assert "one clock" in fit.note and fit.residual < 1e-12
        assert fit.n_points == len(cal.power_counts(H100_SXM)) == 11
        assert fit.group == "power" and not fit.snapped
    assert "split" in fits["power.dyn_quad"].note
    assert checks["power"]["scale"] == pytest.approx(scale, rel=1e-12)
    assert checks["power"]["n"] == list(cal.power_counts(H100_SXM))
    assert meas[0][0] == "power_grid" and meas[0][1].shape == (1, 11)
    # the retired rule: lin and quad at their priors, static the rest
    small = ChipPower(idle_watts=131.0, static_per_core=0.1, dyn_lin=0.1,
                      dyn_quad=0.1)
    static_rest = per_sm(small) - prior.dyn_lin * f - prior.dyn_quad * f * f
    assert static_rest < 0
    got, _, _, _ = _fit(H100_SXM, PowerBackend(small))
    assert all(getattr(got, nm) > 0 for nm in cal.POWER_FIELDS)


def test_one_clock_snaps_at_the_prior():
    got, fits, _, _ = _fit(H100_SXM, PowerBackend(H100_SXM.power), 0.05)
    assert got == H100_SXM.power
    assert all(f.snapped for f in fits.values())


def test_calibrate_fits_the_power():
    """The whole calibration adopts the fitted power, records its grid
    and shows it in the CLI's table."""
    report = cal.calibrate(H100_SXM, backend=SyntheticBackend(
        H100_SXM, power=TRUE_POWER), snap_rtol=0.0, use_cache=False)
    p = report.machine.power
    assert p.idle_watts == pytest.approx(131.0, rel=1e-9)
    assert report.residual_max("power") < 1e-9
    assert report.checks["power"]["watts"][0][0] == pytest.approx(
        TRUE_POWER.watts(1, 1.98))
    text = cal.format_report(report)
    assert "power.idle_watts" in text and "power: P(n, f)" in text


def test_noisy_power_grid_fails_the_cli(capsys):
    backend = SyntheticBackend(H100_SXM, power=TRUE_POWER, power_noise=0.03)
    rc, report = cli.run(["--no-snap", "--no-cache", "--quiet"],
                         backend=backend)
    assert rc == 1
    assert report.residual_max("power") == pytest.approx(0.03, rel=0.2)
    assert report.residual_max("bandwidth") < cal.MAX_FIT_RESIDUAL
    assert "exceeds the bound" in capsys.readouterr().err
    rc, _ = cli.run(["--no-snap", "--no-cache", "--quiet"],
                    backend=SyntheticBackend(H100_SXM, power=TRUE_POWER,
                                             power_noise=0.005))
    assert rc == 0


def test_cli_prints_the_idle_reading(capsys):
    class WithIdle(SyntheticBackend):
        def info(self):
            return {"power": {"idle": {"watts": 131.3, "window_s": 2.1,
                                       "sm_mhz": 1980}}}

    rc, _ = cli.run(["--no-snap", "--no-cache"], backend=WithIdle(H100_SXM))
    out = capsys.readouterr().out
    assert rc == 0
    assert "idle card" in out and "131.3 W" in out and "not fitted" in out


def _visit(ctas, lo=1980, hi=1980, reasons=(), **kw):
    return {"ctas": ctas, "watts": 400.0, "sm_mhz_min": lo, "sm_mhz_max": hi,
            "temp_c_max": 50, "reasons": list(reasons), **kw}


@pytest.mark.parametrize("visit,faulty", [
    (_visit(8), False),
    (_visit(8, lo=1965, hi=1995, reasons=["gpu_idle"]), False),
    (_visit(132, lo=1890), True),
    (_visit(132, hi=2010), True),
    (_visit(132, reasons=["sw_power_cap"]), True),
    (_visit(132, reasons=["hw_thermal_slowdown"]), True),
    ({"ctas": 64, "watts": 400.0}, True)])
def test_power_faults(visit, faulty):
    """A visit off the law's clock by more than CLOCK_RTOL, under a power
    cap or heat, or with no clock read is a fault; the clock's own jitter
    and an idle reason are not."""
    faults = GC.power_faults([_visit(1), visit], 1.98)
    assert len(faults) == faulty
    if faulty:
        assert faults[0].startswith(f"{visit['ctas']} SMs:")


def test_power_sweep_refuses_a_throttled_card(monkeypatch):
    """The card's sweep on a card whose 132-SM visits read 1890 MHz under
    its power cap raises with the readings, before the occupancy check
    and the fit: nothing is fitted from a grid off its clock."""

    class Reader:
        def __init__(self, device):
            pass

        def update_period(self):
            return 0.1

        def idle(self):
            return PW.Window(2.0, 230.0, 0, 0.0)

        def run(self, fn):
            n = fn().shape[2]
            capped = n == 2
            sample = {"sm_mhz": 1890 if capped else 1980, "temp_c": 60,
                      "watts": 690.0, "reasons":
                      ["sw_power_cap"] if capped else []}
            return PW.Window(1.0, 100.0 + 4 * n, 50, 0.05, [sample])

    monkeypatch.setattr(GC, "PowerReader", Reader)
    monkeypatch.setattr(GC, "POWER_SK", 64)
    backend = types.SimpleNamespace(device="cpu")
    backend.power_ctas_per_sm = lambda: pytest.fail("reached the fit")
    with pytest.raises(RuntimeError, match=r"left the 1\.98 GHz") as e:
        GC.CardBackend.power_grid(backend, (1, 2), (1.98,))
    assert "2 SMs: SM clock 1890-1890 MHz" in str(e.value)
    assert "sw_power_cap" in str(e.value) and "1 SMs" not in str(e.value)


def test_no_power_prior_is_its_own_refusal(monkeypatch):
    """A card with data-sheet rates but no power prior is refused, and the
    message names what is missing."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(
                            name="NVIDIA H100 80GB HBM3"))
    monkeypatch.delitem(POWER_PRIORS, "NVIDIA H100 80GB HBM3")
    with pytest.raises(ValueError, match="no power prior"):
        GPUMachineModel.from_device(0)


def test_a_machine_names_its_power():
    """There is no default power: a machine built without one is refused."""
    kw = {f.name: getattr(H100_SXM, f.name)
          for f in dataclasses.fields(H100_SXM) if f.name != "power"}
    with pytest.raises(TypeError, match="power"):
        GPUMachineModel(**kw)


# ---------------------------------------------------------------------------
# the machine file and the cache
# ---------------------------------------------------------------------------


def test_schema_2_round_trips(tmp_path):
    m = dataclasses.replace(H100_SXM, power=TRUE_POWER)
    assert MACHINE_SCHEMA_VERSION == 2
    path = save_machine_file(m, tmp_path / "m.json")
    doc = json.loads(path.read_text())
    assert doc["schema"] == 2 and doc["machine"]["power"]["idle_watts"] == 131.0
    assert load_machine_file(path) == m
    assert machine_from_dict(json.loads(json.dumps(machine_to_dict(m)))) == m


def test_schema_1_is_refused(tmp_path):
    d = machine_to_dict(H100_SXM)
    d.pop("power")
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"schema": 1, "kind": "gpu-machine",
                                "machine": d}))
    with pytest.raises(ValueError, match="schema 1"):
        load_machine_file(path)


def test_new_prior_misses_old_cache_entries(tmp_path):
    """The cache is keyed by the prior machine's fingerprint, which covers
    the power field: an entry under one power prior is a miss under
    another, with nothing added to force it."""
    prev = diskcache.set_cache_dir(tmp_path)
    try:
        diskcache.put("calibration", ("report", "card", 0.0), {"v": 1},
                      machine=H100_SXM)
        assert diskcache.get("calibration", ("report", "card", 0.0),
                             machine=H100_SXM) == {"v": 1}
        diskcache.clear_memo()
        other = dataclasses.replace(H100_SXM, power=TRUE_POWER)
        assert diskcache.get("calibration", ("report", "card", 0.0),
                             machine=other) is None
    finally:
        diskcache.restore_cache_dir(prev)


# ---------------------------------------------------------------------------
# the reader, with NVML and the CUDA calls faked
# ---------------------------------------------------------------------------


class FakeNVML:
    """NVML over cards keyed by PCI bus id; the energy counter steps every
    ``period`` seconds at ``watts``."""

    def __init__(self, cards, *, watts=250.0, period=0.01, fail=()):
        self.cards = cards                        # bus id -> name
        self.watts, self.period, self.fail = watts, period, set(fail)
        self.t0 = time.perf_counter()
        self.asked = []

    def _ret(self, name):
        return 999 if name in self.fail else 0

    def nvmlInit_v2(self):
        return self._ret("init")

    def nvmlErrorString(self, ret):
        return b"fake failure"

    def nvmlDeviceGetHandleByPciBusId_v2(self, bus, handle):
        self.asked.append(bus.decode())
        if bus.decode() not in self.cards:
            return 13
        handle._obj.value = list(self.cards).index(bus.decode()) + 1
        return 0

    def _card(self, handle):
        return list(self.cards.values())[handle.value - 1]

    def nvmlDeviceGetName(self, handle, buf, n):
        buf.value = self._card(handle).encode()
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, out):
        steps = int((time.perf_counter() - self.t0) / self.period)
        out._obj.value = int(steps * self.period * self.watts * 1e3)
        return self._ret("energy")

    def nvmlDeviceGetPowerUsage(self, handle, out):
        out._obj.value = int(self.watts * 1e3)
        return 0

    def nvmlDeviceGetClockInfo(self, handle, kind, out):
        out._obj.value = 1980
        return 0

    def nvmlDeviceGetTemperature(self, handle, kind, out):
        out._obj.value = 40
        return 0

    def nvmlDeviceGetCurrentClocksEventReasons(self, handle, out):
        out._obj.value = 0x4
        return 0

    def nvmlDeviceGetEnforcedPowerLimit(self, handle, out):
        out._obj.value = 700000
        return 0


#: CUDA devices 0 and 1 as CUDA_VISIBLE_DEVICES="3,1" would number them:
#: CUDA's device 1 is the card at bus 0x1B, NVML's second card another
CUDA_BUS = {0: 0xDB, 1: 0x1B}
NVML_CARDS = {"00000000:18:00.0": "NVIDIA H100 80GB HBM3",
              "00000000:1B:00.0": "NVIDIA H100 80GB HBM3",
              "00000000:DB:00.0": "NVIDIA H100 80GB HBM3"}


@pytest.fixture
def fake_card(monkeypatch):
    """A CPU host that believes it has two H100s, with no device work:
    events and synchronize are fakes, and the busy-wait fails the test."""

    class Event:
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def query(self):
            return True

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

        def reset(self):
            pass

    class Stream:
        def wait_stream(self, other):
            pass

    def sleep(_):
        raise AssertionError("the busy-wait ran inside an energy window")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: Stream())

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            pci_domain_id=0, pci_bus_id=CUDA_BUS[i],
                            pci_device_id=0))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "_sleep", sleep)
    return Graph


def test_reader_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PW.PowerReader("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PW.PowerReader("cpu")


def test_reader_raises_without_the_library(fake_card, monkeypatch):
    def missing(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", missing)
    with pytest.raises(RuntimeError, match="cannot load NVML"):
        PW.PowerReader("cuda:0")


def test_reader_picks_the_card_by_pci_bus_id(fake_card):
    lib = FakeNVML(NVML_CARDS)
    r = PW.PowerReader("cuda:1", lib=lib)
    assert lib.asked == ["00000000:1B:00.0"] and r.bus_id == "00000000:1B:00.0"
    assert r.handle.value == 2          # NVML's second card, not index 1's
    assert PW.PowerReader("cuda:0", lib=lib).handle.value == 3


@pytest.mark.parametrize("cards,fail,match", [
    ({"00000000:18:00.0": "NVIDIA H100 80GB HBM3"}, (), "PciBusId"),
    ({"00000000:DB:00.0": "NVIDIA A100-SXM4-80GB"}, (), "A100"),
    (NVML_CARDS, ("init",), "nvmlInit")])
def test_reader_raises_on_a_card_it_cannot_see(fake_card, cards, fail, match):
    with pytest.raises(RuntimeError, match=match):
        PW.PowerReader("cuda:0", lib=FakeNVML(cards, fail=fail))


def test_a_failed_read_raises(fake_card):
    r = PW.PowerReader("cuda:0", lib=FakeNVML(NVML_CARDS, fail=("energy",)))
    with pytest.raises(PW.NVMLError, match="fake failure"):
        r.energy_mj()
    with pytest.raises(PW.NVMLError):
        r.run(lambda: None)


def test_window_bills_only_the_calls(fake_card):
    """The window opens and closes at two counter updates inside a loop
    of graph replays (no busy-wait: the fake ``_sleep`` fails the test),
    holds MIN_UPDATES updates, and its energy is the counter's steps
    between them; a call's energy is the mean power times its device
    time, over every call the replays enqueued."""
    lib = FakeNVML(NVML_CARDS, watts=250.0, period=0.01)
    r = PW.PowerReader("cuda:0", lib=lib)
    assert r.update_period(0.2) == pytest.approx(0.01, rel=0.3)
    calls = []

    def fn():
        calls.append(time.perf_counter())
        time.sleep(5e-4)

    fake_card.replays = 0
    w = r.run(fn, seconds=0.05)
    per_replay = len(calls) - 1 - PW.WARM_CALLS - 2     # warm, timed, side
    assert per_replay >= 1 and fake_card.replays > 0
    assert w.calls == fake_card.replays * per_replay
    assert w.seconds >= PW.MIN_UPDATES * r.period_s
    assert w.joules == pytest.approx(
        round(w.seconds / lib.period) * lib.period * 250.0, rel=1e-6)
    assert w.watts == pytest.approx(250.0, rel=0.1)
    assert w.joules_per_call == pytest.approx(w.watts * w.device_s / w.calls)
    s = w.summary()
    assert s["sm_mhz"] == 1980 and s["reasons"] == ["sw_power_cap"]
    assert s["samples"] >= 1 and s["temp_c_max"] == 40
    idle = r.idle(seconds=0.05)
    assert idle.calls == 0 and idle.watts == pytest.approx(250.0, rel=0.1)
    assert "s_per_call" not in idle.summary()


def test_the_reader_never_queues_a_busy_wait():
    """Nothing in the reader calls the busy-wait or the timers that queue
    it (``timing.time_call``, ``timing.time_graph``)."""
    tree = ast.parse(inspect.getsource(PW))
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & {"_sleep", "time_call", "time_graph"}
