"""The card's power and energy, read from NVML.

The counterpart of the RAPL counters the paper reads (§III-D) and the
reference's simulator backend stands in for.  :class:`PowerReader`
binds NVML (``libnvidia-ml.so.1``, the library ``nvidia-smi`` links)
with ``ctypes``:

* energy from ``nvmlDeviceGetTotalEnergyConsumption`` (a running total
  in mJ), read at two of the counter's own updates;
* beside it, sampled after each update of the counter: the board power
  (``nvmlDeviceGetPowerUsage``), the SM clock
  (``nvmlDeviceGetClockInfo``), the temperature, and the current clock
  event ("throttle") reasons.

The card is picked by the CUDA device's PCI bus id, not by index
(``CUDA_VISIBLE_DEVICES`` renumbers CUDA's devices but not NVML's), and
NVML's name for it must be CUDA's.

**The window** (:meth:`PowerReader.run`).  The counter moves in steps,
once every :meth:`PowerReader.update_period` (measured, not assumed),
so a reading taken at an arbitrary time is off by up to one step.  The
window therefore starts and ends at two of the counter's updates (each
timed at the midpoint of the two reads around it), both while the card
runs the calls, and it holds at least :data:`WINDOW_S` and
:data:`MIN_UPDATES` updates.  The calls are captured in a CUDA graph,
:data:`GRAPH_S` of them a replay, and the loop keeps about
:data:`AHEAD_S` of replays queued, so the card never waits on the host:
an NVML read blocks the host for milliseconds, and a shallow queue of
single launches let the card idle in some windows, which then read a
slower call and a lower power.  No busy-wait is queued
(``torch.cuda._sleep``, which ``timing.time_call`` queues before each
repeat, runs on an SM and would be billed to the kernel).  The mean
power is the window's energy over its length; the device time of a call
is the CUDA-event time of the whole loop, between two ``synchronize()``
calls, over the number of calls; the energy of a call is their product.
The kernels' wrappers count the calls they capture; the window counts
every call its replays enqueue.

**No fallback.**  Without a card, without the library, or on a failed
call, the reader raises; nothing stands in for a reading.
"""
from __future__ import annotations

import collections
import ctypes
import math
import statistics
import time
from dataclasses import dataclass, field

import torch

LIBRARY = "libnvidia-ml.so.1"
#: a window holds at least this long and this many counter updates
WINDOW_S = 1.0
MIN_UPDATES = 10
#: the idle window: no kernel for at least this long
IDLE_S = 2.0
#: device time of the calls kept queued ahead of the card: well over what
#: the host takes to read the counter and sample beside it (milliseconds
#: a read: ``PowerReader.read_s``), and over the host's stalls
AHEAD_S = 0.2
#: device time of the calls one graph replay enqueues
GRAPH_S = 0.01
#: calls timed to size the graph and the queue
WARM_CALLS = 3
#: counter updates let pass before a window starts
SETTLE_UPDATES = 1
_NVML_SUCCESS = 0
_CLOCK_SM = 1
_TEMPERATURE_GPU = 0
#: NVML's clock event reasons (``nvmlClocksEventReason*``) by bit
REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting",
           0x4: "sw_power_cap", 0x8: "hw_slowdown", 0x10: "sync_boost",
           0x20: "sw_thermal_slowdown", 0x40: "hw_thermal_slowdown",
           0x80: "hw_power_brake_slowdown", 0x100: "display_clock_setting"}
#: the reasons that mean the card lowered its clock under a limit: power
#: or heat
SLOWDOWN = ("sw_power_cap", "hw_slowdown", "sw_thermal_slowdown",
            "hw_thermal_slowdown", "hw_power_brake_slowdown")
#: the largest relative distance of an SM clock read from the clock a
#: sweep runs at
CLOCK_RTOL = 0.01


class NVMLError(RuntimeError):
    """An NVML call that did not return success."""


def _captured(fn, calls: int) -> "torch.cuda.CUDAGraph":
    """A CUDA graph of ``calls`` calls of ``fn`` (run twice on a side
    stream first: the capture needs its kernels loaded and its memory
    pooled)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def pci_bus_id(index: int) -> str:
    """NVML's ``domain:bus:device.function`` form of CUDA device
    ``index``'s PCI address."""
    props = torch.cuda.get_device_properties(index)
    return (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
            f"{props.pci_device_id:02X}.0")


def reasons(mask: int) -> list[str]:
    """The names of the reasons set in ``mask``."""
    return [name for bit, name in REASONS.items() if mask & bit] + (
        [f"0x{mask & ~sum(REASONS):x}"] if mask & ~sum(REASONS) else [])


@dataclass
class Window:
    """One energy window: ``joules`` over ``seconds`` between two counter
    updates, ``watts`` their ratio; over the whole loop, ``calls`` calls
    in ``device_s`` of CUDA-event time.  ``samples``: what was sampled
    beside the window."""

    seconds: float
    joules: float
    calls: int
    device_s: float
    samples: list = field(default_factory=list)

    @property
    def watts(self) -> float:
        return self.joules / self.seconds

    @property
    def s_per_call(self) -> float:
        return self.device_s / self.calls

    @property
    def joules_per_call(self) -> float:
        return self.watts * self.s_per_call

    def summary(self) -> dict:
        """The window's numbers with the samples' SM clock (median, min,
        max), temperature (max), board power (median) and every reason
        seen."""
        clocks = [s["sm_mhz"] for s in self.samples]
        out = {"watts": self.watts, "window_s": self.seconds,
               "joules": self.joules, "calls": self.calls,
               "samples": len(self.samples)}
        if self.calls:
            out |= {"s_per_call": self.s_per_call,
                    "joules_per_call": self.joules_per_call}
        if self.samples:
            out |= {"sm_mhz": statistics.median(clocks),
                    "sm_mhz_min": min(clocks), "sm_mhz_max": max(clocks),
                    "temp_c_max": max(s["temp_c"] for s in self.samples),
                    "power_usage_w": statistics.median(
                        s["watts"] for s in self.samples),
                    "reasons": sorted({r for s in self.samples
                                       for r in s["reasons"]})}
        return out


class PowerReader:
    """NVML's view of the CUDA device ``device`` (see module notes).
    ``lib`` replaces the loaded library, as the tests do."""

    def __init__(self, device="cuda", *, lib=None):
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError(f"the power reader reads a card: no CUDA device "
                               f"for {device!r}")
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise RuntimeError(f"cannot load NVML ({LIBRARY}): {e}") from e
            lib.nvmlErrorString.restype = ctypes.c_char_p
        self.lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self.bus_id = pci_bus_id(index)
        self.handle = ctypes.c_void_p()
        self._check(lib.nvmlDeviceGetHandleByPciBusId_v2(
            self.bus_id.encode(), ctypes.byref(self.handle)),
            f"nvmlDeviceGetHandleByPciBusId_v2({self.bus_id})")
        buf = ctypes.create_string_buffer(96)
        self._check(lib.nvmlDeviceGetName(self.handle, buf, len(buf)),
                    "nvmlDeviceGetName")
        self.name = buf.value.decode()
        want = torch.cuda.get_device_name(index)
        if self.name != want:
            raise RuntimeError(f"NVML's device at {self.bus_id} is "
                               f"{self.name!r}, CUDA's device {index} {want!r}")
        self.period_s: float | None = None
        self.read_s: float | None = None

    def _check(self, ret: int, what: str) -> None:
        if ret != _NVML_SUCCESS:
            raise NVMLError(f"{what} returned {ret}: "
                            f"{self.lib.nvmlErrorString(ret)!r}")

    def _read(self, fn: str, *args, ctype=ctypes.c_uint) -> int:
        v = ctype()
        self._check(getattr(self.lib, fn)(self.handle, *args, ctypes.byref(v)),
                    fn)
        return v.value

    def energy_mj(self) -> int:
        return self._read("nvmlDeviceGetTotalEnergyConsumption",
                          ctype=ctypes.c_ulonglong)

    def sample(self) -> dict:
        """Board power (W), SM clock (MHz), temperature (C) and the clock
        event reasons, now."""
        return {
            "t": time.perf_counter(),
            "watts": self._read("nvmlDeviceGetPowerUsage") / 1e3,
            "sm_mhz": self._read("nvmlDeviceGetClockInfo", _CLOCK_SM),
            "temp_c": self._read("nvmlDeviceGetTemperature", _TEMPERATURE_GPU),
            "reasons": reasons(self._read(
                "nvmlDeviceGetCurrentClocksEventReasons",
                ctype=ctypes.c_ulonglong)),
        }

    def power_limit_w(self) -> float:
        return self._read("nvmlDeviceGetEnforcedPowerLimit") / 1e3

    def update_period(self, seconds: float = 1.0) -> float:
        """The energy counter's update period in seconds: the median gap
        between its changes while polled for ``seconds``."""
        changes, last, reads = [], self.energy_mj(), 0
        t_end = time.perf_counter() + seconds
        while (now := time.perf_counter()) < t_end:
            e = self.energy_mj()
            reads += 1
            if e != last:
                changes.append(now)
                last = e
        self.read_s = seconds / reads
        if len(changes) < 3:
            raise RuntimeError(f"the energy counter moved {len(changes)} "
                               f"times in {seconds} s")
        self.period_s = statistics.median(
            b - a for a, b in zip(changes, changes[1:]))
        self.updates_per_s = len(changes) / seconds
        return self.period_s

    def hold_s(self, seconds: float = WINDOW_S) -> float:
        """A window's least length: ``seconds`` and MIN_UPDATES updates."""
        if self.period_s is None:
            self.update_period()
        return max(seconds, MIN_UPDATES * self.period_s)

    def _watch(self, step, hold: float, t0: float) -> tuple:
        """Call ``step()`` and read the counter until the window closes:
        it opens at the first update SETTLE_UPDATES periods after ``t0``
        and closes at the first update ``hold`` seconds after that.  An
        update is timed at the midpoint of the two reads around it, and
        the samples are taken right after an update, so that no sample
        delays the read that sees the next one.  Returns ``(seconds,
        joules, samples)``."""
        settle = SETTLE_UPDATES * self.period_s
        opened = closed = None
        last, t_last, samples = self.energy_mj(), time.perf_counter(), []
        while closed is None:
            step()
            e, now = self.energy_mj(), time.perf_counter()
            if e != last:
                t_update = (t_last + now) / 2
                last = e
                if opened is None:
                    if t_update - t0 >= settle:
                        opened = (t_update, e)
                elif t_update - opened[0] >= hold:
                    closed = (t_update, e)
                if opened is not None and closed is None:
                    samples.append(self.sample())
            t_last = now
        return closed[0] - opened[0], (closed[1] - opened[1]) * 1e-3, samples

    def run(self, fn, *, seconds: float = WINDOW_S) -> Window:
        """The energy of calls of ``fn`` (see module notes): replays of
        ``fn`` captured in a CUDA graph, about AHEAD_S of them queued,
        between two ``synchronize()`` calls; no busy-wait."""
        hold = self.hold_s(seconds)
        fn()                                   # warm (loads the kernel)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(WARM_CALLS):            # a call's time, to size
            fn()                               # the graph and the queue
        torch.cuda.synchronize()
        t_call = max((time.perf_counter() - t) / WARM_CALLS, 1e-6)
        per_replay = math.ceil(GRAPH_S / t_call)
        graph = _captured(fn, per_replay)
        ahead = max(2, math.ceil(AHEAD_S / (per_replay * t_call)))
        pending = collections.deque()
        replays = 0

        def step():
            nonlocal replays
            while pending and pending[0].query():
                pending.popleft()
            while len(pending) < ahead:
                graph.replay()
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                replays += 1

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        seconds_, joules, samples = self._watch(step, hold, time.perf_counter())
        end.record()
        torch.cuda.synchronize()
        graph.reset()
        return Window(seconds_, joules, replays * per_replay,
                      start.elapsed_time(end) * 1e-3, samples)

    def idle(self, seconds: float = IDLE_S) -> Window:
        """The card with no kernel for at least ``seconds`` (and
        MIN_UPDATES updates) after a ``synchronize()``."""
        hold = self.hold_s(seconds)
        torch.cuda.synchronize()
        seconds_, joules, samples = self._watch(lambda: None, hold,
                                                time.perf_counter())
        return Window(seconds_, joules, 0, 0.0, samples)
