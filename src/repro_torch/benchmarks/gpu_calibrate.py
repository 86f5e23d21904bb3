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
  knee.  Given ``sustained_bw``, it returns the port's model response
  instead (``calibrate.stream_response``): the fits bisect through it.
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
  the grid map at 2^26, in turns (each turn's time kept in ``info()``).

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
from ..kernels import pipeline as P
from ..kernels.stencil import kernel as SK
from ..kernels.stream import kernel as K
from ..kernels.stream import ops
from . import gpu_stream_ecm as G
from .timing import time_call, time_graph

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
#: stencil coefficients (c0 != 0, so both products round)
STENCIL_COEFFS = {2: (0.3, 0.175), 3: (0.3, 0.1)}


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

    def _pool(self, n: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(SEED)
        return torch.randn(max(n, 1), generator=g, device=self.device)

    def _floor_ms(self, name: str) -> float:
        """One 64-row block of ``name``'s grid kernel, back to back."""
        if name not in self.launch_floor_ms:
            self.launch_floor_ms[name] = self._time(name, K.BLOCK_ROWS)
        return self.launch_floor_ms[name]

    def _time(self, name: str, rows: int, pool: torch.Tensor | None = None,
              block_rows: int = K.BLOCK_ROWS) -> float:
        """ms of one launch of ``name``'s grid kernel on ``rows`` rows a
        stream, its inputs consecutive slices of ``pool``: a CUDA-graph
        replay of the launches that fill about GRAPH_FILL_S at the data
        sheet's rate."""
        n_in = _inputs(name)
        if pool is None:
            pool = self._pool(n_in * rows * LANES)
        ins = tuple(pool[i * rows * LANES:(i + 1) * rows * LANES]
                    for i in range(n_in))
        t_est = (stream_count(name) * rows * LANES * 4
                 / self.machine.hbm_bytes_per_s)
        launches = int(min(100, max(4, GRAPH_FILL_S // t_est)))
        return time_graph(grid_call(name, ins, rows, block_rows), launches)

    def _measure(self, name: str, sizes_bytes) -> np.ndarray:
        """Cycles per row of ``name`` at each working set, the floor off."""
        floor = self._floor_ms(name)
        rows = [rows_for(ws, stream_count(name)) for ws in sizes_bytes]
        pool = self._pool(_inputs(name) * max(rows) * LANES)
        out = np.empty(len(rows))
        for j, r in enumerate(rows):
            t = self._time(name, r, pool)
            out[j] = (t - floor) * 1e-3 * self.machine.clock_hz / r
        del pool
        torch.cuda.empty_cache()
        return out

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
        mean of two timings taken in turns (striad, striad_rmw,
        striad_rmw, striad), so a drift of the card shows in neither."""
        cal.CAL_COUNTERS["measurements"] += 1
        a, b, c, _ = self._streams()
        calls = {"striad": lambda: ops.striad(G.S, b, c),
                 "striad_rmw": lambda: ops.striad_rmw(G.S, a, b, c)}
        t = {k: 0.0 for k in calls}
        for k in ("striad", "striad_rmw", "striad_rmw", "striad"):
            ms = time_call(calls[k])[0]
            self.rfo_turns_ms.append((k, ms))
            t[k] += ms * 1e-3 / 2
        return t["striad"], t["striad_rmw"]

    def info(self) -> dict:
        """What the measurements rest on, for the report's checks."""
        return {"device": torch.cuda.get_device_name(self.device),
                "launch_floor_ms": dict(self.launch_floor_ms),
                "rfo_turns_ms": list(self.rfo_turns_ms),
                "l2_plateau_sizes_bytes": [
                    float(s) for s in cal.l2_plateau_sizes(self.machine)],
                "l2_wave_ctas": L2_WAVE_CTAS,
                "l2_passes_s": self.l2_passes_s,
                "stencil_rows": dict(cal.STENCIL_ROWS),
                "block_rows": K.BLOCK_ROWS}
