"""Device time of one call on the card, as both loops measure it."""
from __future__ import annotations

import statistics
import time

import torch

INNER = 20            # launches per timed repeat
REPEATS = 5           # timed repeats; the median is reported
SPIN_CYCLES = 20_000_000   # ~10 ms busy-wait queued ahead of each repeat


def time_call(fn, inner: int = INNER) -> tuple[float, float]:
    """``(device ms, host us)`` per call of ``fn``: the median over
    REPEATS of ``inner`` back-to-back calls between two CUDA events, after
    one warm-up call.  Each repeat is queued behind a busy-wait on the
    card, so the host has enqueued every call before the card reaches the
    first event and the events read device time alone; the host's enqueue
    time is returned beside it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev, host = [], []
    for _ in range(REPEATS):
        torch.cuda._sleep(SPIN_CYCLES)
        h0 = time.perf_counter()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        h1 = time.perf_counter()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / inner)
        host.append((h1 - h0) / inner * 1e6)
    return statistics.median(dev), statistics.median(host)


GRAPH_LAUNCHES = 100  # launches captured in one CUDA graph


def time_graph(fn, launches: int = GRAPH_LAUNCHES,
               repeats: int = REPEATS) -> float:
    """Device ms per call of ``fn`` replayed from a CUDA graph of
    ``launches`` calls: the median over ``repeats`` replays, each behind
    the same busy-wait as :func:`time_call`.  For launches of a few us, whose
    times back to back from the host vary by tens of percent: one replay
    enqueues them all at once.  ``fn`` runs twice on a side stream first
    (the capture needs its kernels loaded and its memory pooled)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    dev = []
    for _ in range(repeats):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        dev.append(start.elapsed_time(end) / launches)
    graph.reset()
    return statistics.median(dev)
