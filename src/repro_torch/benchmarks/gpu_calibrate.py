"""The card's measurements for the calibration (``core/calibrate.py``).

:class:`CardBackend` times the port's kernels on the card and hands the
calibration what it fits:

* ``stream_sweep(kernels, sizes_bytes)``: the grid kernels (the
  reference's 64-row block) at each working set, split over the kernel's
  streams and rounded to whole 64-row blocks, in cycles per 128-lane row
  at ``clock_hz`` (a unit only: the model converts with the same clock).
  Each point is the time of one launch replayed from a CUDA graph
  (``timing.time_graph``: launches of a few us, timed back to back from
  the host, vary by tens of percent) less the kernel's per-launch floor,
  the time of one 64-row block timed the same way.  Without it, the
  floor (a few us) would set the L2-resident points, and with them the
  knee.  Each point is the median of :data:`STREAM_PASSES` passes over
  the sweep, ascending and descending in turn, as the L2 sweep takes
  its points; every pass is kept (``info()["stream_passes"]``).  Given
  ``sustained_bw``, it returns the port's model response instead
  (``calibrate.stream_response``): the fits bisect through it.
* ``l2_sweep(kernel, sizes_bytes)``: ``(rows, seconds)`` of one launch of
  the grid kernel at each L2-resident working set, on a grid of whole
  waves: :data:`L2_WAVE_CTAS` blocks an SM, the block height set by the
  working set, each point the median of :data:`L2_PASSES` passes.  With
  a 64-row block the SMs' share of the blocks changes with the working
  set (one SM with a block more than another sets the time); the
  calibration fits the L2 rate as the slope of these times.
* ``stencil_sweep(name, widths)``: the whole-array Jacobi kernel on
  ``(R, N)`` (2D) or ``(R, N, N)`` (3D), ``R`` = ``calibrate.STENCIL_ROWS``,
  in cycles per lattice update; or the model response.  These points are
  long enough (tens of us to ms) that no floor is taken off.
* ``pipeline_pair()``: one CTA of the map pipeline, ``striad`` at 2^26,
  depths 1 and 2 (the stream loop's one-SM pair).
* ``rfo_pair()``: ``striad`` against the one-pass ``striad_rmw``, both on
  the grid map at 2^26, the median of three turns each
  (:data:`RFO_TURNS`; each turn's time kept in ``info()``).
* ``power_grid(n_grid, f_grid)``: the card's watts with ``n`` SMs busy,
  read by ``power.PowerReader`` (the energy counter between two of its
  updates, each window at least a second).  The law's premise is that
  each busy SM adds the same power, which holds where the SMs share no
  bottleneck, so the load is compute-bound on FFMA: the flash-attention
  tile route, f32, :data:`POWER_TILE` at head dim :data:`POWER_D`, one
  query block of ``POWER_TILE[0]`` rows for each of ``n`` heads against
  one shared KV head of :data:`POWER_SK` keys (read from HBM once, then
  from the L2), so ``n`` CTAs of one an SM (the registers ``-Xptxas -v``
  gave the kernel and its shared memory both allow one; checked), light
  enough that all the SMs together stay under the card's power limit
  (the share of the limit the busiest visit drew is reported).  The
  counts are visited ascending, then descending; each takes the median
  of its two readings, so a drift of the card shows as a spread, not a
  slope.
  Every count's output is held against the plain attention
  (``kernels/attention/ref.py``) at the reference's f32 tolerance, and a
  failed check raises.
  Before the sweep the card idles (no kernel for ``power.IDLE_S``): that
  reading, with its SM clock, goes beside the fit in ``info()`` and is
  not fitted.  The port sets no clock, so the card runs at one and
  ``f_grid`` must hold one.  The law is fitted at that clock, so every
  visit's SM clock reads must lie within ``power.CLOCK_RTOL`` of it and
  no visit may show a reason of ``power.SLOWDOWN`` (a power cap or heat
  that lowered the clock); otherwise the sweep raises with every visit's
  clock, temperature, watts and reasons (:func:`power_faults`), and
  nothing is fitted.

There is no CPU path: without the card the backend raises.  The inputs
are N(0, 1), drawn on the card from a fixed seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import calibrate as cal
from ..core.gpu_ecm import stream_count
from ..core.machine import GPUMachineModel
from ..kernels import _build
from ..kernels import pipeline as P
from ..kernels.check import compare
from ..kernels.attention import kernel as AK
from ..kernels.attention import ops as AO
from ..kernels.attention import ref as AR
from ..kernels.stencil import kernel as SK
from ..kernels.stream import kernel as K
from ..kernels.stream import ops
from . import gpu_stream_ecm as G
from .gpu_compute_ecm import full_f32
from .power import CLOCK_RTOL, SLOWDOWN, PowerReader
from .timing import REPEATS, time_call, time_graph

LANES = P.LANES
SEED = 0
#: calls per timed repeat of the one-CTA pair (a call streams 768 MB
#: through one SM)
ONE_CTA_INNER = 2
#: device time a graph of stream-sweep launches fills: 4 to 100 launches
GRAPH_FILL_S = 2e-3
#: blocks an SM in the L2 sweep's grid: at one, each CTA runs alone at
#: its own latency-bound rate; from two on the SMs share the L2
L2_WAVE_CTAS = 3
#: passes over the L2 sweep, forwards and backwards in turn; each point
#: takes its median, so a drift of the card within one pass shows in
#: neither the line nor its residual
L2_PASSES = 5
#: the RFO pair's timings, in turns: three of each kernel
RFO_TURNS = ("striad", "striad_rmw", "striad_rmw", "striad", "striad",
             "striad_rmw")
#: stencil coefficients (c0 != 0, so both products round)
STENCIL_COEFFS = {2: (0.3, 0.175), 3: (0.3, 0.1)}
#: passes over each stream and capacity sweep, ascending and descending
#: in turn, as the L2 sweep's; each point takes its median, so neither a
#: drift of the card nor a brief slowdown moves the fits or the knee.  A
#: slowdown at a turn, where a point is timed twice in a row, moves two
#: of five (three passes let it move two of three and fail a fit); a
#: kernel's first timing, after another kernel's, one of five.  A pass
#: times a point by one graph replay (STREAM_PASS_REPEATS), so a point
#: takes five replays, as the one pass of five did before
STREAM_PASSES = 5
STREAM_PASS_REPEATS = 1
#: the power sweep's load (module notes): the tile route's (bq, bk) at
#: head dim POWER_D, its query heads on one KV head of POWER_SK keys.  The
#: FFMA matmul's 128 x 256 tile (32 deep) on every SM drew so close to the
#: card's power limit that the card capped its clock, and its 64 x 256
#: tile drew more (more shared-memory reads a product); this tile issues
#: fewer FFMA a cycle than either and draws less.
POWER_TILE = (128, 128)
POWER_D = 128
POWER_SK = 4096
#: registers of one SM (Hopper)
SM_REGISTERS = 65536


def power_faults(points, f_ghz: float) -> list[str]:
    """The power sweep's visits (``Window.summary()`` with ``ctas``) that
    ran off the clock ``f_ghz`` the law is fitted at: an SM clock read
    more than CLOCK_RTOL from it, a reason of SLOWDOWN, or no clock read."""
    mhz = f_ghz * 1e3
    faults = []
    for p in points:
        lo, hi = p.get("sm_mhz_min"), p.get("sm_mhz_max")
        slow = [r for r in p.get("reasons", ()) if r in SLOWDOWN]
        if lo is None or slow or max(abs(lo - mhz), abs(hi - mhz)) \
                > CLOCK_RTOL * mhz:
            faults.append(
                f"{p['ctas']} SMs: SM clock {lo}-{hi} MHz against {mhz:g}, "
                f"{p.get('temp_c_max')} C, {p['watts']:.1f} W, reasons "
                f"{p.get('reasons')}")
    return faults


def rows_for(ws_bytes: float, streams: int) -> int:
    """Rows of each stream for a working set of ``ws_bytes`` split over
    ``streams`` f32 streams, rounded to whole 64-row blocks (one at
    least)."""
    blocks = round(ws_bytes / (streams * LANES * 4 * K.BLOCK_ROWS))
    return max(1, blocks) * K.BLOCK_ROWS


def _inputs(name: str) -> int:
    """Input streams of a kernel: its streams less its one store."""
    return stream_count(name) - (name not in P.REDUCE_OPS)


def grid_call(name: str, ins: tuple, rows: int,
              block_rows: int = K.BLOCK_ROWS):
    """The grid kernel of the Table I kernel ``name`` on ``ins`` (its
    input streams, flat, in the op's argument order) in blocks of
    ``block_rows``, as a callable."""
    dev = torch.device("cuda")
    kw = {"block_rows": block_rows}
    return {
        "load": lambda: ops.load(*ins, **kw),
        "ddot": lambda: ops.ddot(*ins, **kw),
        "store": lambda: ops.store(G.S, (rows * LANES,), torch.float32,
                                   device=dev, **kw),
        "update": lambda: ops.update(G.S, *ins, **kw),
        "copy": lambda: ops.copy(*ins, **kw),
        "striad": lambda: ops.striad(G.S, *ins, **kw),
        "schoenauer": lambda: ops.schoenauer(*ins, **kw),
    }[name]


class CardBackend:
    """Measurements of the card behind ``machine`` (see module notes)."""

    name = "card"

    def __init__(self, machine: GPUMachineModel, device="cuda"):
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            raise RuntimeError("CardBackend measures the card: no CUDA device "
                               f"for {device!r}")
        self.machine = machine
        self.device = dev
        self.launch_floor_ms: dict[str, float] = {}
        self.rfo_turns_ms: list[tuple[str, float]] = []
        self.l2_passes_s: list[list[float]] = []
        self.stream_passes: list[dict] = []
        self.power: dict = {}

    def _pool(self, n: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(SEED)
        return torch.randn(max(n, 1), generator=g, device=self.device)

    def _floor_ms(self, name: str) -> float:
        """One 64-row block of ``name``'s grid kernel, back to back."""
        if name not in self.launch_floor_ms:
            self.launch_floor_ms[name] = self._time(name, K.BLOCK_ROWS)
        return self.launch_floor_ms[name]

    def _time(self, name: str, rows: int, pool: torch.Tensor | None = None,
              block_rows: int = K.BLOCK_ROWS, repeats: int = REPEATS) -> float:
        """ms of one launch of ``name``'s grid kernel on ``rows`` rows a
        stream, its inputs consecutive slices of ``pool``: the median of
        ``repeats`` CUDA-graph replays of the launches that fill about
        GRAPH_FILL_S at the data sheet's rate."""
        n_in = _inputs(name)
        if pool is None:
            pool = self._pool(n_in * rows * LANES)
        ins = tuple(pool[i * rows * LANES:(i + 1) * rows * LANES]
                    for i in range(n_in))
        t_est = (stream_count(name) * rows * LANES * 4
                 / self.machine.hbm_bytes_per_s)
        launches = int(min(100, max(4, GRAPH_FILL_S // t_est)))
        return time_graph(grid_call(name, ins, rows, block_rows), launches,
                          repeats)

    def _measure(self, name: str, sizes_bytes) -> np.ndarray:
        """Cycles per row of ``name`` at each working set, the floor off:
        the median of STREAM_PASSES passes, forwards and backwards in
        turn, every pass kept in ``stream_passes``."""
        floor = self._floor_ms(name)
        rows = [rows_for(ws, stream_count(name)) for ws in sizes_bytes]
        pool = self._pool(_inputs(name) * max(rows) * LANES)
        order = list(range(len(rows)))
        passes = np.empty((STREAM_PASSES, len(rows)))
        for p in range(STREAM_PASSES):
            for j in (order if p % 2 == 0 else order[::-1]):
                t = self._time(name, rows[j], pool,
                               repeats=STREAM_PASS_REPEATS)
                passes[p, j] = (t - floor) * 1e-3 * self.machine.clock_hz / rows[j]
        del pool
        self.stream_passes.append({"kernel": name, "rows": rows,
                                   "cy_per_row": passes.tolist()})
        torch.cuda.empty_cache()
        return np.median(passes, axis=0)

    def stream_sweep(self, kernels, sizes_bytes, *,
                     sustained_bw=None) -> np.ndarray:
        if sustained_bw is not None:
            return cal.stream_response(self.machine, kernels, sizes_bytes,
                                       sustained_bw)
        cal.CAL_COUNTERS["measurements"] += 1
        return np.stack([self._measure(k, sizes_bytes) for k in kernels])

    def l2_sweep(self, name: str, sizes_bytes) -> tuple[np.ndarray,
                                                       np.ndarray]:
        """``(rows, seconds)``: one launch of ``name``'s grid kernel at
        each working set, on ``sm_count x L2_WAVE_CTAS`` blocks."""
        cal.CAL_COUNTERS["measurements"] += 1
        blocks = self.machine.sm_count * L2_WAVE_CTAS
        heights = [max(1, round(ws / (stream_count(name) * LANES * 4
                                      * blocks))) for ws in sizes_bytes]
        rows = np.array([blocks * h for h in heights])
        pool = self._pool(_inputs(name) * int(rows.max()) * LANES)
        order = list(range(len(rows)))
        passes = np.empty((L2_PASSES, len(rows)))
        for p in range(L2_PASSES):
            for j in (order if p % 2 == 0 else order[::-1]):
                passes[p, j] = self._time(name, int(rows[j]), pool,
                                          heights[j]) * 1e-3
        del pool
        self.l2_passes_s = passes.tolist()
        secs = np.median(passes, axis=0)
        torch.cuda.empty_cache()
        return rows, secs

    def stencil_sweep(self, name, problem_ns, *,
                      sustained_bw=None) -> np.ndarray:
        if sustained_bw is not None:
            return cal.stencil_response(self.machine, name, problem_ns,
                                        sustained_bw)
        cal.CAL_COUNTERS["measurements"] += 1
        grid = SK.jacobi2d_grid if name == "jacobi2d" else SK.jacobi3d_grid
        out = np.empty(len(problem_ns))
        for j, n in enumerate(problem_ns):
            shape = cal.stencil_shape(name, n)
            c0, c1 = STENCIL_COEFFS[len(shape)]
            g = torch.Generator(device=self.device).manual_seed(SEED)
            p = torch.randn(tuple(s + 2 for s in shape), generator=g,
                            device=self.device)
            t = time_call(lambda: grid(p, c0=c0, c1=c1))[0]
            out[j] = t * 1e-3 * self.machine.clock_hz / math.prod(shape)
            del p
        torch.cuda.empty_cache()
        return out

    def _streams(self) -> tuple[torch.Tensor, ...]:
        return G.make_streams(G.N_FULL_ROWS, self.device)

    def pipeline_pair(self) -> tuple[float, float, float]:
        """(t_serial, t_pipelined, t_transfer) seconds: ``striad`` at 2^26
        through the map pipeline on one CTA at depths 1 and 2; the
        transfer time is the pipelined time (one SM's stream)."""
        cal.CAL_COUNTERS["measurements"] += 1
        _, b, c, _ = self._streams()
        rows = G.N_FULL_ROWS
        pb = G.pipeline_block(self.machine)
        b2, c2 = b.view(rows, LANES), c.view(rows, LANES)
        t = {d: time_call(lambda d=d: P.map_pipeline(
            "striad", (G.S,), (b2, c2), rows=rows, dtype=b.dtype,
            device=b.device, num_stages=d, block_rows=pb, ctas=1),
            inner=ONE_CTA_INNER)[0] * 1e-3 for d in (1, 2)}
        return t[1], t[2], t[2]

    def rfo_pair(self) -> tuple[float, float]:
        """(striad, striad_rmw) seconds on the grid map at 2^26, each the
        median of three timings taken in turns (striad, striad_rmw,
        striad_rmw, striad, striad, striad_rmw), so neither a drift of
        the card nor one slow timing moves either (with the mean of two
        turns, one slow timing could fail the verdict)."""
        cal.CAL_COUNTERS["measurements"] += 1
        a, b, c, _ = self._streams()
        calls = {"striad": lambda: ops.striad(G.S, b, c),
                 "striad_rmw": lambda: ops.striad_rmw(G.S, a, b, c)}
        t = {k: [] for k in calls}
        for k in RFO_TURNS:
            ms = time_call(calls[k])[0]
            self.rfo_turns_ms.append((k, ms))
            t[k].append(ms * 1e-3)
        return float(np.median(t["striad"])), float(np.median(t["striad_rmw"]))

    def power_ctas_per_sm(self) -> dict:
        """CTAs of the power sweep's kernel an SM holds, by its registers
        (``-Xptxas -v``, allocated in 8s a thread) and by its shared
        memory; the library must be built."""
        bq, bk = POWER_TILE
        tag = f"flash_tile<float, {bq}, {bk}, {POWER_D}>"
        entry = next(e for e in _build.ptxas_report("attention")
                     if tag in e["kernel"])
        threads = AK.tile_panels(bq, bk, POWER_D)[0]
        regs = -(-entry["registers"] // 8) * 8 * threads
        props = torch.cuda.get_device_properties(self.device)
        smem = AK.smem_bytes(bq, bk, POWER_D)
        return {"kernel": entry["kernel"], "registers": entry["registers"],
                "spill_stores": entry["spill_stores"], "smem_bytes": smem,
                "by_registers": SM_REGISTERS // regs,
                "by_smem": props.shared_memory_per_multiprocessor // smem}

    def power_grid(self, n_grid, f_grid) -> np.ndarray:
        """``(1, N)`` watts of the card with ``n`` SMs busy for each ``n``
        of ``n_grid``, at the card's one clock (module notes)."""
        if len(f_grid) != 1:
            raise ValueError(f"the card runs at one clock; a power grid over "
                             f"{list(f_grid)} GHz needs clocks set")
        cal.CAL_COUNTERS["measurements"] += 1
        reader = PowerReader(self.device)
        period = reader.update_period()
        idle = reader.idle()
        bq, bk = POWER_TILE
        g = torch.Generator(device=self.device).manual_seed(SEED)
        q = torch.randn(1, bq, max(n_grid), POWER_D, generator=g,
                        device=self.device)
        k, v = (torch.randn(1, POWER_SK, 1, POWER_D, generator=g,
                            device=self.device) for _ in range(2))
        checks, readings = {}, {n: [] for n in n_grid}
        points = []
        for n in list(n_grid) + list(n_grid)[::-1]:
            qn = q[:, :, :n]
            call = (lambda qn=qn: AO.flash_attention(qn, k, v, causal=False,
                                                     bq=bq, bk=bk))
            if n not in checks:
                with full_f32():
                    want = AR.attention(*AO.fused_inputs(qn, k, v),
                                        causal=False)
                checks[n] = compare(
                    call(), want.reshape(1, n, bq, POWER_D).permute(0, 2, 1, 3),
                    tol=AR.TOLERANCE[torch.float32])
                if not checks[n][0]:
                    raise RuntimeError(f"power sweep: the attention on {n} "
                                       f"CTAs differs from its plain version: "
                                       f"{checks[n]}")
            w = reader.run(call)
            readings[n].append(w.watts)
            points.append({"ctas": n, **w.summary()})
        faults = power_faults(points, f_grid[0])
        if faults:
            raise RuntimeError(f"power sweep: the card left the {f_grid[0]} "
                               f"GHz the law is fitted at: {faults}")
        occupancy = self.power_ctas_per_sm()
        if min(occupancy["by_registers"], occupancy["by_smem"]) != 1:
            raise RuntimeError(f"power sweep: not one CTA an SM: {occupancy}")
        watts = [float(np.median(readings[n])) for n in n_grid]
        limit = reader.power_limit_w()
        self.power = {
            "counter_period_s": period,
            "counter_updates_per_s": reader.updates_per_s,
            "counter_read_s": reader.read_s,
            "power_limit_w": limit, "bus_id": reader.bus_id,
            "peak_share_of_limit": max(p["watts"] for p in points) / limit,
            "idle": idle.summary(),
            "load": {"kernel": "flash_attention tile", "dtype": "float32",
                     "block": list(POWER_TILE), "d": POWER_D,
                     "sk": POWER_SK},
            "ctas_per_sm": occupancy, "points": points,
            "watts": dict(zip(n_grid, watts)),
            "spread": {n: abs(r[0] - r[-1]) / float(np.median(r))
                       for n, r in readings.items()},
            "checks": checks}
        del q, k, v
        torch.cuda.empty_cache()
        return np.array([watts])

    def info(self) -> dict:
        """What the measurements rest on, for the report's checks."""
        return {"device": torch.cuda.get_device_name(self.device),
                "launch_floor_ms": dict(self.launch_floor_ms),
                "rfo_turns_ms": list(self.rfo_turns_ms),
                "l2_plateau_sizes_bytes": [
                    float(s) for s in cal.l2_plateau_sizes(self.machine)],
                "l2_wave_ctas": L2_WAVE_CTAS,
                "l2_passes_s": self.l2_passes_s,
                "stream_passes": self.stream_passes,
                "stencil_rows": dict(cal.STENCIL_ROWS),
                "block_rows": K.BLOCK_ROWS,
                "power": self.power}
