"""Calibration of the card's model: measure -> fit -> emit a machine file.

The port of the reference's ``repro/core/calibrate.py``.  The ECM
model's premise (paper §IV-V) is that machine parameters are measured by
the same microbenchmarks that validate the model.  On the card:

1. **Measure.**  A backend runs the sweeps.  On the card it is
   ``benchmarks/gpu_calibrate.py`` ``CardBackend``, which times the
   port's grid kernels; any object with the same methods plugs in (the
   CPU tests feed a synthetic one).  Asked for a sweep *with* a sustained
   bandwidth, a backend answers with the port's forward model
   (:func:`stream_response`, :func:`stencil_response`) instead of a
   measurement: the fits invert that response.
2. **Fit.**  Each calibration field of
   :class:`~.machine.GPUMachineModel`:

   * ``measured_bw[kernel]`` for the Table I stream kernels and the two
     Jacobi sweeps: the mean of a deep sweep (working sets 16-128x L2) is
     inverted through the forward response by geometric bisection; the
     family keys ``_stream`` / ``_stencil`` take their members' median.
     The gated ``residual`` is the rms relative misfit of the adopted
     response to the sweep.  The card has no cache simulator, so the
     response *is* the ECM, and ``model_gap`` (the pure-ECM affine form
     ``t = a + c/bw`` at the adopted rate) equals the residual.  A fit
     above the data sheet's ``hbm_bytes_per_s`` is no sustained rate: it
     is not adopted, the prior stays, and the residual is the prior's
     misfit.
   * ``l2_bytes_per_s``: the ``copy`` kernel's L2 plateau, the slope of
     its launch times over :data:`L2_PLATEAU_POINTS` working sets from
     L2/8 to L2/4 (``backend.l2_sweep``): ``t = t0 + rows / rate``, so
     the launch floor is the intercept, not a separate measurement taken
     off.  Its residual is the line's rms relative misfit to the times.
   * ``l2_bytes`` (the hierarchy is ``(l2_bytes,)``): the residence knee
     of a ``copy`` sweep from L2/16 to 32x L2, where the curve crosses the
     midpoint of the L2 and HBM plateaus, ``C = 3/4 ws`` (the reference's
     rule, ``ws = 4C/3``).  Its residual is the spread of the knee over
     neighbouring points: the relative distance between the knees of the
     sweep's even and odd points.  The Jacobi 2D layer-condition break is
     an independent estimate, recorded in ``checks`` (``C = LC_SAFETY x 3
     rows x elem_bytes x N_break``).
   * ``write_allocate``: ``striad`` against the one-pass ``striad_rmw``.
     Without an RFO the ratio is 4/3 (3 streams against 4), with one it
     is 1.0.  A ratio within :data:`RFO_BAND` of one of them decides;
     outside both the verdict is "undetermined", ``write_allocate`` keeps
     its prior and the CLI fails.  Recorded in ``checks``.
   * the one-SM overlap pair (``pipeline_pair``, where the verdict is "no
     RFO") gives ``sm.exposed_hbm_fraction``.  It is kept in
     the provenance, not stored in the machine: the pair describes one
     SM, the machine's ``exposed_hbm_fraction`` the card.  Its residual
     is the misfit of Eq. 1 at the fitted fraction to the pair (0 unless
     the fraction is clamped to [0, 1]); its ``model_gap`` the distance
     from the prior.
3. **Snap.**  A fit within ``snap_rtol`` of its prior adopts the prior
   bit-identically; ``snap_rtol=0`` adopts raw fits.
4. **Emit.**  :meth:`CalibrationReport.save` writes the fitted machine
   file with its provenance.  Reports are cached in :mod:`.diskcache`
   under the prior machine's fingerprint, so a warm rerun fits nothing.

Left out: the reference's simulator backend, its ECM-forward inversion
for hierarchies a simulator cannot sweep (the card can sweep), and the
power fit (one card at one clock is rank-deficient).

This module imports no kernel.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from dataclasses import dataclass, field

import numpy as np

from . import diskcache
from .ecm import ECMBatch, ECMModel
from .gpu_ecm import (LANES, gpu_stencil_ecm, gpu_stream_ecm, measured_overlap,
                      stream_count)
from .layer_condition import LC_SAFETY, STENCILS
from .machine import (GPUMachineModel, machine_from_dict, machine_to_dict,
                      save_machine_file)

#: Default snap tolerance: fits within this relative distance of the
#: prior adopt the prior bit-identically.
SNAP_RTOL = 0.05

#: Validation bound on the worst per-field least-squares misfit.
MAX_FIT_RESIDUAL = 0.02

#: The RFO verdict's band: the ratio ``striad_rmw / striad`` decides only
#: within this relative distance of 4/3 (no RFO) or of 1.0 (an RFO).
RFO_BAND = 0.05

#: Working sets of the L2 plateau's line, from L2/8 to L2/4.
L2_PLATEAU_POINTS = 16

#: Observability counters (reset with :func:`reset_counters`): ``fits``
#: counts fitted fields, ``measurements`` backend sweeps, ``cache_hits``
#: reports served from the disk cache without re-fitting.
CAL_COUNTERS = {"fits": 0, "measurements": 0, "cache_hits": 0}

#: The Table I stream kernels the card runs.  The CPU zoo's ``_nt``
#: variants have no kernel of their own: every card store writes whole
#: sectors.
STREAM_KERNELS = ("copy", "ddot", "load", "schoenauer", "store", "striad",
                  "update")
STENCIL_KERNELS = ("jacobi2d", "jacobi3d")
#: f32 sweeps: the element size of every measurement
ELEM_BYTES = 4
#: the fixed axis-0 extent R of a stencil sweep: width N runs (R, N) in
#: 2D and (R, N, N) in 3D.  64 rows keep the smallest 2D array of the
#: layer-condition sweep (N = C/72) at 3.6x the L2; 16 layers keep
#: the deepest 3D array at 9 GB.
STENCIL_ROWS = {"jacobi2d": 64, "jacobi3d": 16}

_CAL_CACHE_KIND = "calibration"


def reset_counters() -> None:
    for k in CAL_COUNTERS:
        CAL_COUNTERS[k] = 0


# ---------------------------------------------------------------------------
# Fit records
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldFit:
    """One fitted calibration field: the raw least-squares value, the
    adopted value (snapped to the prior when close enough), and the model
    residual against the measurement."""

    field: str                 # e.g. "measured_bw[copy]", "l2_bytes"
    group: str                 # bandwidth | capacity | overlap
    prior: float
    fitted: float
    adopted: float
    residual: float            # rms relative least-squares misfit (gated)
    n_points: int
    snapped: bool
    model_gap: float = 0.0     # pure-ECM vs measurement deviation (info)
    note: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class CalibrationReport:
    """The outcome of one calibration run (see :func:`calibrate`)."""

    base: str                       # prior machine's name
    machine: GPUMachineModel        # the fitted (adopted-values) machine
    fits: tuple                     # tuple[FieldFit, ...]
    measurement_hash: str           # sha256 over every measurement array
    backend: str
    snap_rtol: float
    wall_s: float
    checks: dict = field(default_factory=dict)   # RFO, knee, LC breaks
    from_cache: bool = False

    def residual_max(self, group: str | None = None) -> float:
        vals = [f.residual for f in self.fits
                if group is None or f.group == group]
        return max(vals) if vals else 0.0

    def group_summary(self) -> dict:
        out: dict = {}
        for f in self.fits:
            g = out.setdefault(f.group, {"n": 0, "n_snapped": 0,
                                         "max_residual": 0.0})
            g["n"] += 1
            g["n_snapped"] += bool(f.snapped)
            g["max_residual"] = max(g["max_residual"], f.residual)
        return out

    def provenance(self) -> dict:
        return {
            "calibrated_from": self.base,
            "backend": self.backend,
            "snap_rtol": self.snap_rtol,
            "measurement_hash": self.measurement_hash,
            "residual_max": self.residual_max(),
            "fit_wall_s": self.wall_s,
            "fits": [f.as_dict() for f in self.fits],
            "checks": dict(self.checks),
        }

    def save(self, path):
        """Write the fitted machine as a versioned machine file."""
        return save_machine_file(self.machine, path,
                                 provenance=self.provenance())

    def to_literal(self) -> dict:
        """Plain-literal form for the disk cache (see ``from_literal``)."""
        return {
            "base": self.base,
            "machine": machine_to_dict(self.machine),
            "fits": [f.as_dict() for f in self.fits],
            "measurement_hash": self.measurement_hash,
            "backend": self.backend,
            "snap_rtol": self.snap_rtol,
            "wall_s": self.wall_s,
            "checks": dict(self.checks),
        }

    @classmethod
    def from_literal(cls, doc: dict, *, from_cache: bool = False):
        return cls(
            base=doc["base"],
            machine=machine_from_dict(doc["machine"]),
            fits=tuple(FieldFit(**f) for f in doc["fits"]),
            measurement_hash=doc["measurement_hash"],
            backend=doc["backend"],
            snap_rtol=doc["snap_rtol"],
            wall_s=doc["wall_s"],
            checks=dict(doc.get("checks") or {}),
            from_cache=from_cache,
        )


# ---------------------------------------------------------------------------
# The forward model a backend answers with when given a bandwidth
# ---------------------------------------------------------------------------


def with_bandwidths(machine: GPUMachineModel, bw: dict) -> GPUMachineModel:
    """``machine`` with ``bw`` over its ``measured_bw``."""
    return dataclasses.replace(machine, measured_bw={**machine.measured_bw,
                                                     **bw})


def stream_response(machine: GPUMachineModel, kernels, sizes_bytes,
                    sustained_bw: dict) -> np.ndarray:
    """The port's model of a stream sweep at the given bandwidths:
    ``(K, S)`` cycles per 128-lane row.  The model has no L2 level, so
    every size takes the HBM prediction; the deep sweeps it answers for
    are all past L2."""
    m = with_bandwidths(machine, sustained_bw)
    pred = ECMBatch.from_models([gpu_stream_ecm(k, m) for k in kernels]
                                ).prediction(-1)
    return np.repeat(pred[:, None], len(sizes_bytes), axis=1)


def stencil_shape(name: str, n: int) -> tuple[int, ...]:
    """The array a stencil sweep runs at width ``n``: (R, n) or (R, n, n)."""
    r = STENCIL_ROWS[name]
    return (r, int(n)) if STENCILS[name].dim == 2 else (r, int(n), int(n))


def _stencil_models(machine: GPUMachineModel, name: str, ns) -> ECMBatch:
    """The Jacobi sweep's two-term model (``gpu_stencil_ecm``) at each
    width as an ECM in cycles per lattice update.  With the exposed
    fraction ``f``: ``T_OL = T_comp + f T_hbm``, ``T_nOL = f T_hbm``,
    one transfer ``(1 - f) T_hbm``, whose Eq. 1 is the step's ``t_ecm``."""
    spec = dataclasses.replace(STENCILS[name], elem_bytes=ELEM_BYTES)
    models = []
    for n in ns:
        shape = stencil_shape(name, n)
        step = gpu_stencil_ecm(spec, shape, machine, ELEM_BYTES)
        per = machine.clock_hz / math.prod(shape)
        f = step.exposed_hbm_fraction
        models.append(ECMModel(
            t_ol=(step.t_comp + f * step.t_hbm) * per,
            t_nol=f * step.t_hbm * per,
            transfers=((1 - f) * step.t_hbm * per,), levels=("REG", "HBM"),
            unit="cy/LUP", name=f"gpu-{name}"))
    return ECMBatch.from_models(models)


def stencil_response(machine: GPUMachineModel, name: str, ns,
                     sustained_bw: float) -> np.ndarray:
    """The port's model of a stencil sweep over widths ``ns`` at the
    given bandwidth: ``(S,)`` cycles per lattice update, with the layer
    condition of ``machine.l2_bytes``."""
    return _stencil_models(with_bandwidths(machine, {name: sustained_bw}),
                           name, ns).prediction(-1)


def stencil_break_width(machine: GPUMachineModel, name: str,
                        capacity: float | None = None) -> float:
    """The width at which the stencil's first layer condition breaks in a
    cache of ``capacity`` (default the L2): 3 rows (2D) or 3 layers (3D)
    of f32 times ``LC_SAFETY``."""
    c = machine.l2_bytes if capacity is None else capacity
    rows = c / (LC_SAFETY * (2 * STENCILS[name].radius + 1) * ELEM_BYTES)
    return rows if STENCILS[name].dim == 2 else math.sqrt(rows)


# ---------------------------------------------------------------------------
# Fit primitives (copied)
# ---------------------------------------------------------------------------


def _snap(fitted: float, prior: float, snap_rtol: float) -> tuple:
    """(adopted, snapped): adopt the prior when the fit confirms it."""
    if fitted == prior:
        return prior, True
    if prior != 0 and abs(fitted - prior) <= snap_rtol * abs(prior):
        return prior, True
    return fitted, False


def _rms_rel(obs: np.ndarray, pred: np.ndarray) -> float:
    obs = np.asarray(obs, dtype=float)
    pred = np.asarray(pred, dtype=float)
    return float(np.sqrt(np.mean(((obs - pred) / obs) ** 2)))


def _affine_in_inv_bw(predict, bw_lo, bw_hi):
    """Exact ECM mem-level prediction coefficients ``t(bw) = a + c/bw``
    from two probes of ``predict(bw) -> ECMBatch`` (affine while the
    transfer term sets ``T_ECM``)."""
    p_lo = predict(bw_lo).prediction(-1)
    p_hi = predict(bw_hi).prediction(-1)
    c = (p_lo - p_hi) / (1.0 / bw_lo - 1.0 / bw_hi)
    a = p_lo - c / bw_lo
    return a, c


def _bisect_bw(forward, obs: float, prior: float, *, iters: int = 52):
    """Invert a monotone-decreasing measurement response ``forward(bw)``
    for the sustained bandwidth matching ``obs`` (geometric bisection).
    Returns ``None`` when ``obs`` is outside the bracketing response."""
    lo, hi = prior / 16.0, prior * 16.0
    if not (forward(hi) <= obs <= forward(lo)):
        return None
    for _ in range(iters):
        mid = math.sqrt(lo * hi)
        if forward(mid) > obs:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def _crossings(sizes: np.ndarray, curve: np.ndarray, level: float):
    """Log-interpolated first upward crossing of ``level``, or ``None``."""
    idx = np.nonzero((curve[:-1] < level) & (curve[1:] >= level))[0]
    if not len(idx):
        return None
    i = int(idx[0])
    f = (level - curve[i]) / (curve[i + 1] - curve[i])
    return math.exp(math.log(sizes[i])
                    + f * (math.log(sizes[i + 1]) - math.log(sizes[i])))


# ---------------------------------------------------------------------------
# Field-class fitters
# ---------------------------------------------------------------------------


def deep_sizes(machine: GPUMachineModel, n: int = 4) -> np.ndarray:
    """Working sets of the deep stream sweeps: 16x to 128x the L2."""
    return np.geomspace(16.0 * machine.l2_bytes, 128.0 * machine.l2_bytes, n)


def _adopt_bw(machine: GPUMachineModel, fitted: float, prior: float,
              snap_rtol: float) -> tuple[float, bool, str]:
    """(adopted, snapped, note) of a sustained-bandwidth fit: snapped as
    :func:`_snap`, but a fit above the data sheet's ``hbm_bytes_per_s``
    is refused and the prior stays."""
    if fitted > machine.hbm_bytes_per_s:
        return prior, False, (
            f"fit {fitted:.5g} B/s above the data sheet's "
            f"{machine.hbm_bytes_per_s:.5g}: the model's traffic does not "
            "describe the sweep; prior retained")
    return (*_snap(fitted, prior, snap_rtol), "")


def _fit_stream_bandwidths(machine, backend, snap_rtol, meas, fits):
    """measured_bw[kernel] for every stream kernel, fitted jointly by
    vectorized geometric bisection."""
    kernels = list(STREAM_KERNELS)
    sizes = deep_sizes(machine)
    obs = backend.stream_sweep(kernels, sizes)          # (K, S) cy/row
    meas.append(("stream_sweep", obs))
    obs_mean = obs.mean(axis=1)
    priors = np.array([machine.sustained_bw(k, "_stream") for k in kernels])
    lo, hi = priors / 16.0, priors * 16.0
    for _ in range(52):
        mid = np.sqrt(lo * hi)
        resp = backend.stream_sweep(
            kernels, sizes,
            sustained_bw={k: float(b) for k, b in zip(kernels, mid)})
        too_slow = resp.mean(axis=1) > obs_mean         # bw guess too low
        lo = np.where(too_slow, mid, lo)
        hi = np.where(too_slow, hi, mid)
    fitted = np.sqrt(lo * hi)
    a, c = _affine_in_inv_bw(
        lambda bw: ECMBatch.from_models([
            gpu_stream_ecm(k, with_bandwidths(machine, {k: float(b)}))
            for k, b in zip(kernels, bw)]),
        priors / 2.0, priors * 2.0)
    adopted_all = {k: _adopt_bw(machine, float(fitted[i]), float(priors[i]),
                                snap_rtol)
                   for i, k in enumerate(kernels)}
    refit = backend.stream_sweep(
        kernels, sizes,
        sustained_bw={k: v[0] for k, v in adopted_all.items()})
    out = {}
    for i, k in enumerate(kernels):
        adopted, snapped, note = adopted_all[k]
        fits.append(FieldFit(
            field=f"measured_bw[{k}]", group="bandwidth",
            prior=float(priors[i]), fitted=float(fitted[i]),
            adopted=adopted, residual=_rms_rel(obs[i], refit[i]),
            n_points=obs.shape[1], snapped=snapped,
            model_gap=_rms_rel(obs[i], a[i] + c[i] / adopted), note=note))
        CAL_COUNTERS["fits"] += 1
        out[k] = adopted
    return out


def stencil_deep_widths(machine: GPUMachineModel, name: str) -> np.ndarray:
    """Widths of the deep stencil sweep: 2x to 8x the width at which the
    stencil's first layer condition breaks in the L2 (the reference
    starts at twice the break too)."""
    n = stencil_break_width(machine, name)
    return np.geomspace(2.0 * n, 8.0 * n, 3).astype(int)


def _fit_stencil_bandwidths(machine, backend, snap_rtol, meas, fits):
    out = {}
    for k in STENCIL_KERNELS:
        prior = float(machine.sustained_bw(k, "_stencil"))
        ns = stencil_deep_widths(machine, k)
        obs = backend.stencil_sweep(k, ns)
        meas.append((f"stencil_sweep[{k}]", obs))
        obs_mean = float(obs.mean())

        def forward(bw, _k=k, _ns=ns):
            return float(backend.stencil_sweep(_k, _ns,
                                               sustained_bw=bw).mean())

        fitted = _bisect_bw(forward, obs_mean, prior)
        if fitted is None:
            fits.append(FieldFit(
                field=f"measured_bw[{k}]", group="bandwidth", prior=prior,
                fitted=prior, adopted=prior, residual=0.0,
                n_points=len(ns), snapped=True,
                note="measurement response does not bracket the "
                     "observation; prior retained"))
        else:
            adopted, snapped, note = _adopt_bw(machine, fitted, prior,
                                               snap_rtol)
            refit = backend.stencil_sweep(k, ns, sustained_bw=adopted)
            a, c = _affine_in_inv_bw(
                lambda bw, _k=k, _ns=ns: _stencil_models(
                    with_bandwidths(machine, {_k: bw}), _k, _ns),
                prior / 2.0, prior * 2.0)
            fits.append(FieldFit(
                field=f"measured_bw[{k}]", group="bandwidth", prior=prior,
                fitted=fitted, adopted=adopted,
                residual=_rms_rel(obs, refit), n_points=len(ns),
                snapped=snapped, model_gap=_rms_rel(obs, a + c / adopted),
                note=note))
            out[k] = adopted
        CAL_COUNTERS["fits"] += 1
    return out


def _fit_family_fallbacks(machine, fitted_bw, snap_rtol, fits):
    """The ``_stream``/``_stencil`` family keys: the median of their
    members' adopted values (the card's prior has none, so both are
    always fitted); any other key of the prior is retained."""
    families = {
        "_stream": [k for k in STREAM_KERNELS if k in fitted_bw],
        "_stencil": [k for k in STENCIL_KERNELS if k in fitted_bw],
    }
    out = {}
    for fam, members in families.items():
        prior = float(machine.sustained_bw(fam))
        if not members:
            fitted = prior
            note = "no fitted members; prior retained"
        else:
            fitted = float(np.median([fitted_bw[k] for k in members]))
            note = f"median of {len(members)} member fits"
        adopted, snapped = _snap(fitted, prior, snap_rtol)
        fits.append(FieldFit(
            field=f"measured_bw[{fam}]", group="bandwidth", prior=prior,
            fitted=fitted, adopted=adopted, residual=0.0,
            n_points=len(members), snapped=snapped, note=note))
        CAL_COUNTERS["fits"] += 1
        out[fam] = adopted
    for k in machine.measured_bw:
        if k in fitted_bw or k in out:
            continue
        prior = float(machine.measured_bw[k])
        fits.append(FieldFit(
            field=f"measured_bw[{k}]", group="bandwidth", prior=prior,
            fitted=prior, adopted=prior, residual=0.0, n_points=0,
            snapped=True,
            note="no microbenchmark measurement for this key; prior "
                 "retained"))
        CAL_COUNTERS["fits"] += 1
    return out


def capacity_sizes(machine: GPUMachineModel, n: int = 240) -> np.ndarray:
    """Working sets of the residence-knee sweep: L2/16 to 32x L2."""
    cap = machine.l2_bytes
    return np.geomspace(max(1024.0, cap / 16.0), 32.0 * cap, n)


def l2_plateau_sizes(machine: GPUMachineModel) -> np.ndarray:
    """Working sets of the L2 plateau: L2_PLATEAU_POINTS from L2/8 to
    L2/4, resident in the L2 with room to spare (on the card, blocks of
    16 to 32 rows: an 8-row block, less than one 16-row bulk copy, runs
    faster per row than the line through the rest)."""
    return np.geomspace(machine.l2_bytes / 8, machine.l2_bytes / 4,
                        L2_PLATEAU_POINTS)


def _fit_line(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares ``(intercept, slope)`` of ``y = a + b x``."""
    b, a = np.polyfit(np.asarray(x, float), np.asarray(y, float), 1)
    return float(a), float(b)


def _knee_spread(sizes: np.ndarray, curve: np.ndarray, level: float,
                 ws: float) -> float:
    """The knee's spread over neighbouring points: the distance between
    the knees of the sweep's even and odd points, relative to ``ws``
    (1.0 where either half has none)."""
    halves = [_crossings(sizes[i::2], curve[i::2], level) for i in (0, 1)]
    if None in halves:
        return 1.0
    return abs(halves[0] - halves[1]) / ws


def _fit_capacity(machine, backend, snap_rtol, meas, fits, checks):
    """``l2_bytes`` from the residence knee of a ``copy`` sweep and
    ``l2_bytes_per_s`` from its L2 plateau, with the stencil
    layer-condition break as a recorded cross-check.  Returns the adopted
    ``(l2_bytes, l2_bytes_per_s)``."""
    prior_c = machine.l2_bytes
    sizes = capacity_sizes(machine)
    curve = backend.stream_sweep(["copy"], sizes)[0]
    l2_rows, l2_secs = backend.l2_sweep("copy", l2_plateau_sizes(machine))
    hbm_points = backend.stream_sweep(["copy"], deep_sizes(machine))[0]
    t0, per_row = _fit_line(l2_rows, l2_secs)
    plateaus = (per_row * machine.clock_hz, float(np.median(hbm_points)))
    meas.append(("capacity_sweep", curve))
    meas.append(("l2_sweep", np.stack([l2_rows, l2_secs])))
    meas.append(("hbm_plateau", hbm_points))
    # the L2 plateau, s/row -> bytes/s over copy's two streams
    row_bytes = stream_count("copy") * LANES * ELEM_BYTES
    rate = row_bytes / per_row
    prior_rate = machine.l2_bytes_per_s
    if prior_rate is None:
        adopted_rate, snapped = rate, False
    else:
        adopted_rate, snapped = _snap(rate, float(prior_rate), snap_rtol)
    fits.append(FieldFit(
        field="l2_bytes_per_s", group="bandwidth",
        prior=float(prior_rate or 0.0), fitted=rate, adopted=adopted_rate,
        residual=_rms_rel(l2_secs, t0 + per_row * np.asarray(l2_rows)),
        n_points=len(l2_secs), snapped=snapped,
        note="copy's L2 plateau" + ("" if prior_rate else "; no prior")))
    CAL_COUNTERS["fits"] += 1
    mid = (plateaus[0] + plateaus[1]) / 2.0
    ws = _crossings(sizes, curve, mid)
    checks["capacity"] = {"knee_ws_bytes": ws, "l2_bytes": prior_c,
                          "plateaus_cy_per_row": list(plateaus),
                          "l2_sweep": {"rows": np.asarray(l2_rows).tolist(),
                                       "seconds": np.asarray(l2_secs).tolist(),
                                       "intercept_s": t0}}
    if ws is None:
        fits.append(FieldFit(
            field="l2_bytes", group="capacity", prior=float(prior_c),
            fitted=float(prior_c), adopted=float(prior_c), residual=0.0,
            n_points=len(sizes), snapped=True,
            note="no residence knee found (outside the sweep); prior "
                 "retained"))
        adopted_c = prior_c
    else:
        # hit weight clamp(2C/ws - 1) is 1/2 at ws = 4C/3
        fitted = 0.75 * ws
        adopted, snapped = _snap(fitted, float(prior_c), snap_rtol)
        adopted_c = int(round(adopted))
        spread = _knee_spread(sizes, curve, mid, ws)
        fits.append(FieldFit(
            field="l2_bytes", group="capacity", prior=float(prior_c),
            fitted=fitted, adopted=float(adopted_c), residual=spread,
            n_points=len(sizes), snapped=snapped,
            model_gap=abs(fitted - adopted_c) / max(adopted_c, 1)))
        checks["capacity"]["fitted_over_l2_bytes"] = fitted / prior_c
        checks["capacity"]["knee_spread"] = spread
    CAL_COUNTERS["fits"] += 1
    checks["stencil_lc_breaks"] = _stencil_lc_breaks(machine, backend,
                                                     adopted_c, meas)
    return adopted_c, adopted_rate


def lc_widths(machine: GPUMachineModel, capacity: float,
              n: int = 64) -> np.ndarray:
    """Widths of the layer-condition sweep: a third to three times the
    2D break width in a cache of ``capacity``."""
    nb = stencil_break_width(machine, "jacobi2d", capacity)
    return np.geomspace(nb / 3.0, nb * 3.0, n).astype(int)


def _stencil_lc_breaks(machine, backend, cap, meas) -> dict:
    """Locate the jacobi2d layer-condition break in a measured sweep of
    widths; a break at ``N`` implies ``C = LC_SAFETY x 3 rows x 4 B x N``
    (f32), an independent estimate of the L2."""
    ns = lc_widths(machine, cap)
    obs = backend.stencil_sweep("jacobi2d", ns)
    meas.append(("stencil_lc[L2]", obs))
    steps = np.diff(obs) / obs[:-1]
    i = int(np.argmax(steps))
    if steps[i] <= 1e-6:
        return {"L2": {"detected": False}}
    n_star = math.sqrt(float(ns[i]) * float(ns[i + 1]))
    est = LC_SAFETY * 3 * ELEM_BYTES * n_star
    return {"L2": {"detected": True, "n_break": n_star, "step": float(steps[i]),
                   "capacity_est": est, "vs_adopted": est / cap,
                   "vs_l2_bytes": est / machine.l2_bytes}}


def rfo_verdict(ratio: float, streams: int) -> str:
    """"no RFO", "RFO" or "undetermined": ``ratio`` = ``striad_rmw /
    striad`` against the ECM's ``(streams + 1) / streams`` without an RFO
    and 1.0 with one, each within :data:`RFO_BAND`."""
    for verdict, want in (("no RFO", (streams + 1) / streams), ("RFO", 1.0)):
        if abs(ratio - want) <= RFO_BAND * want:
            return verdict
    return "undetermined"


def _check_rfo(machine, backend, meas, checks) -> str:
    """The RFO question: ``striad_rmw`` moves one stream more than
    ``striad`` (4 against 3) unless a store already reads its line first,
    in which case both move 4.  Returns the verdict (:func:`rfo_verdict`)."""
    t_striad, t_rmw = backend.rfo_pair()
    meas.append(("rfo_pair", np.array([t_striad, t_rmw])))
    ratio = t_rmw / t_striad
    streams = stream_count("striad")
    verdict = rfo_verdict(ratio, streams)
    checks["rfo"] = {"striad_s": t_striad, "striad_rmw_s": t_rmw,
                     "ratio": ratio, "ecm_ratio_no_rfo": (streams + 1) / streams,
                     "ecm_ratio_rfo": 1.0, "band": RFO_BAND,
                     "write_allocate": {"RFO": True, "no RFO": False}.get(
                         verdict, machine.write_allocate),
                     "verdict": verdict}
    return verdict


def _fit_overlap(machine, backend, rfo, snap_rtol, meas, fits):
    """The one-SM exposed-HBM fraction from the serial-vs-pipelined pair,
    where stores allocate no line (recorded in the provenance only)."""
    if rfo != "no RFO":
        return
    t_serial, t_pipelined, t_x = backend.pipeline_pair()
    meas.append(("pipeline_pair", np.array([t_serial, t_pipelined, t_x])))
    prior = float(machine.exposed_hbm_fraction)
    fitted = float(measured_overlap(t_serial, t_pipelined, t_x))
    adopted, snapped = _snap(fitted, prior, snap_rtol)
    fits.append(FieldFit(
        field="sm.exposed_hbm_fraction", group="overlap", prior=prior,
        fitted=fitted, adopted=adopted,
        residual=abs(t_pipelined + (1.0 - fitted) * t_x - t_serial) / t_serial,
        n_points=2, snapped=snapped, model_gap=abs(fitted - prior),
        note="one SM (ctas=1); not stored in the card's "
             "exposed_hbm_fraction"))
    CAL_COUNTERS["fits"] += 1


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------


def calibrate(machine: GPUMachineModel, *, backend,
              snap_rtol: float = SNAP_RTOL,
              use_cache: bool = True) -> CalibrationReport:
    """Run the full measure->fit cycle against ``machine``'s prior.

    Returns a :class:`CalibrationReport`; ``report.save(path)`` emits the
    machine file.  With the disk cache enabled, a repeat run with the same
    prior, backend and tolerance is served from disk with no measurement
    and no fit (``report.from_cache`` is set and ``CAL_COUNTERS['fits']``
    does not move).
    """
    cache_key = ("report", backend.name, float(snap_rtol))
    if use_cache:
        hit = diskcache.get(_CAL_CACHE_KIND, cache_key, machine=machine)
        if hit is not None:
            CAL_COUNTERS["cache_hits"] += 1
            return CalibrationReport.from_literal(hit, from_cache=True)

    t0 = time.perf_counter()
    fits: list = []
    meas: list = []
    checks: dict = {}
    # the RFO question first: it decides whether the overlap is fitted, and
    # both pairs are timed before the sweeps have loaded the card
    rfo = _check_rfo(machine, backend, meas, checks)
    _fit_overlap(machine, backend, rfo, snap_rtol, meas, fits)
    fitted_bw = _fit_stream_bandwidths(machine, backend, snap_rtol, meas, fits)
    fitted_bw.update(_fit_stencil_bandwidths(machine, backend, snap_rtol,
                                             meas, fits))
    fitted_bw.update(_fit_family_fallbacks(machine, fitted_bw, snap_rtol,
                                           fits))
    l2_bytes, l2_rate = _fit_capacity(machine, backend, snap_rtol, meas, fits,
                                      checks)
    checks["backend"] = backend.info()

    fitted_m = dataclasses.replace(
        machine, measured_bw={**machine.measured_bw, **fitted_bw},
        l2_bytes=l2_bytes, l2_bytes_per_s=l2_rate,
        write_allocate=checks["rfo"]["write_allocate"])
    wall = time.perf_counter() - t0
    h = hashlib.sha256()
    for label, arr in meas:
        h.update(label.encode())
        h.update(repr(np.asarray(arr).tolist()).encode())
    report = CalibrationReport(
        base=machine.name, machine=fitted_m, fits=tuple(fits),
        measurement_hash=h.hexdigest(), backend=backend.name,
        snap_rtol=snap_rtol, wall_s=wall, checks=checks)
    if use_cache:
        diskcache.put(_CAL_CACHE_KIND, cache_key, report.to_literal(),
                      machine=machine)
    return report


def format_report(report: CalibrationReport) -> str:
    """Human-readable fit table for the launch CLI."""
    lines = [
        f"calibration of {report.base!r} "
        f"(backend={report.backend}, snap_rtol={report.snap_rtol:g}"
        + (", cached" if report.from_cache else "") + ")",
        f"{'field':34s} {'prior':>12s} {'fitted':>12s} "
        f"{'adopted':>12s} {'resid':>7s} {'gap':>6s}  snap",
    ]
    for f in report.fits:
        lines.append(
            f"{f.field:34s} {f.prior:12.5g} {f.fitted:12.5g} "
            f"{f.adopted:12.5g} {f.residual:7.4f} {f.model_gap:6.3f}  "
            f"{'yes' if f.snapped else 'NO'}"
            + (f"  ({f.note})" if f.note else ""))
    rfo = report.checks.get("rfo")
    if rfo:
        lines.append(f"RFO: striad_rmw / striad = {rfo['ratio']:.4f} (ECM "
                     f"{rfo['ecm_ratio_no_rfo']:.4f} without, "
                     f"{rfo['ecm_ratio_rfo']:.4f} with): {rfo['verdict']}")
    cap = report.checks.get("capacity")
    if cap:
        lc = report.checks.get("stencil_lc_breaks", {}).get("L2", {})
        lines.append(f"L2 knee at ws {cap['knee_ws_bytes']} B beside "
                     f"l2_bytes {cap['l2_bytes']} B; layer-condition "
                     f"estimate {lc.get('capacity_est', 'not detected')} B")
    lines.append(
        f"max residual {report.residual_max():.3f}; "
        f"{sum(1 for f in report.fits if f.snapped)}/{len(report.fits)} "
        f"fields snapped to prior; wall {report.wall_s:.2f}s; "
        f"measurements sha256 {report.measurement_hash[:16]}")
    return "\n".join(lines)
