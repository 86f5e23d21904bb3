"""The Execution-Cache-Memory model of Hofmann, Eitzinger & Fey (2015), §IV.

A copy of the reference's ``ECMModel`` and ``ECMBatch``
(``repro/core/ecm.py``), limited to what the port uses: the overlap rule
(Eq. 1)::

    T_core = max(T_nOL, T_OL)
    T_ECM  = max(T_nOL + T_data, T_OL)

with ``T_data`` the sum of the transfer terms down to the level the
working set lives in, and the paper's shorthand notations
``{T_OL || T_nOL | T_1 | ...}`` (input) and ``{L1 ] L2 ] ...}``
(predictions).  :class:`ECMBatch` evaluates Eq. 1 over a batch of models
as array operations (:func:`eq1_predictions`).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np


def _fmt(x: float) -> str:
    """Format a cycle count the way the paper does (1 decimal, trim .0)."""
    r = round(x, 1)
    if abs(r - round(r)) < 1e-9:
        return str(int(round(r)))
    return f"{r:.1f}"


@dataclass(frozen=True)
class ECMModel:
    """An ECM model instance for one kernel on one machine.

    ``transfers[i]`` is the data-transfer time (cycles per unit of work)
    between hierarchy level ``i`` and level ``i+1``; ``levels`` names the
    *prediction* levels, so ``len(levels) == len(transfers) + 1``.
    """

    t_ol: float
    t_nol: float
    transfers: tuple[float, ...]
    levels: tuple[str, ...] = ("L1", "L2", "L3", "Mem")
    unit: str = "cy/CL"
    name: str = ""

    def __post_init__(self) -> None:
        if len(self.levels) != len(self.transfers) + 1:
            raise ValueError(
                f"need len(levels) == len(transfers)+1, got {len(self.levels)} "
                f"levels and {len(self.transfers)} transfers"
            )
        if self.t_ol < 0 or self.t_nol < 0 or any(t < 0 for t in self.transfers):
            raise ValueError("ECM times must be non-negative")

    @property
    def t_core(self) -> float:
        return max(self.t_nol, self.t_ol)

    def t_data(self, level: int | str) -> float:
        """Cumulative transfer time for data residing in ``level``."""
        return sum(self.transfers[:self._level_index(level)])

    def prediction(self, level: int | str) -> float:
        """``T_ECM`` for data in ``level`` (Eq. 1)."""
        return max(self.t_nol + self.t_data(level), self.t_ol)

    def predictions(self) -> tuple[float, ...]:
        return tuple(self.prediction(i) for i in range(len(self.levels)))

    def core_bound(self, level: int | str = -1) -> bool:
        """True when the in-core time alone sets ``T_ECM`` at ``level``:
        the data transfers hide completely behind ``T_OL``."""
        return self.prediction(level) <= self.t_ol + 1e-9

    def performance(self, work_per_unit: float, level: int | str,
                    clock_hz: float | None = None) -> float:
        """Performance for data in ``level``: work units per cycle, or per
        second if ``clock_hz`` is given (paper §IV-A: P = W / T_ECM)."""
        p = work_per_unit / self.prediction(level)
        return p * clock_hz if clock_hz else p

    def scaled(self, factor: float) -> "ECMModel":
        return replace(
            self,
            t_ol=self.t_ol * factor,
            t_nol=self.t_nol * factor,
            transfers=tuple(t * factor for t in self.transfers),
        )

    def _level_index(self, level: int | str) -> int:
        if isinstance(level, int):
            if level < 0:
                level += len(self.levels)
            if not 0 <= level < len(self.levels):
                raise IndexError(f"level {level} out of range")
            return level
        try:
            return self.levels.index(level)
        except ValueError:
            raise KeyError(f"unknown level {level!r}; have {self.levels}") from None

    def notation(self) -> str:
        parts = " | ".join(_fmt(t) for t in self.transfers)
        return f"{{{_fmt(self.t_ol)} || {_fmt(self.t_nol)} | {parts}}}"

    def prediction_notation(self) -> str:
        return "{" + " ] ".join(_fmt(p) for p in self.predictions()) + "}"

    @classmethod
    def parse(cls, s: str, *, levels: tuple[str, ...] | None = None,
              name: str = "") -> "ECMModel":
        """Parse the paper's input shorthand, e.g. ``{1 || 2 | 2 | 4 | 9.1}``.

        Both the ASCII ``||`` and the typographic ``‖`` separator are
        accepted.
        """
        body = s.strip()
        if body.startswith("{") and body.endswith("}"):
            body = body[1:-1]
        body = body.replace("‖", "||")
        if "||" not in body:
            raise ValueError(f"not an ECM input notation: {s!r}")
        ol_part, rest = body.split("||", 1)
        xs = [float(x) for x in rest.split("|")]
        t_nol, transfers = xs[0], tuple(xs[1:])
        lv = levels or tuple(
            ["L1"] + [f"L{i+2}" for i in range(len(transfers) - 1)] + ["Mem"]
        )
        return cls(t_ol=float(ol_part), t_nol=t_nol, transfers=transfers,
                   levels=lv, name=name)


@dataclass(frozen=True)
class ECMBatch:
    """A batch of ECM models over one shared level hierarchy, evaluated as
    NumPy array ops instead of per-model Python calls.

    All time arrays share an arbitrary leading batch shape ``B``:
    ``t_ol``/``t_nol`` are ``B``-shaped and ``transfers`` is
    ``B + (len(levels) - 1,)``.  The scalar :class:`ECMModel` API is
    available per element via :meth:`scalar`; the two agree exactly (same
    Eq. 1, same floats).
    """

    t_ol: np.ndarray
    t_nol: np.ndarray
    transfers: np.ndarray
    levels: tuple[str, ...] = ("L1", "L2", "L3", "Mem")
    names: tuple[str, ...] = ()
    unit: str = "cy/CL"

    def __post_init__(self):
        object.__setattr__(self, "t_ol", np.asarray(self.t_ol, float))
        object.__setattr__(self, "t_nol", np.asarray(self.t_nol, float))
        object.__setattr__(self, "transfers",
                           np.asarray(self.transfers, float))
        if self.transfers.shape[-1] != len(self.levels) - 1:
            raise ValueError(
                f"need transfers.shape[-1] == len(levels)-1, got "
                f"{self.transfers.shape[-1]} vs {len(self.levels)} levels")

    @classmethod
    def from_models(cls, models: "list[ECMModel] | tuple[ECMModel, ...]"
                    ) -> "ECMBatch":
        levels = models[0].levels
        for m in models:
            if m.levels != levels:
                raise ValueError(f"level mismatch: {m.levels} vs {levels}")
        return cls(
            t_ol=np.array([m.t_ol for m in models]),
            t_nol=np.array([m.t_nol for m in models]),
            transfers=np.array([m.transfers for m in models]),
            levels=levels,
            names=tuple(m.name for m in models),
            unit=models[0].unit,
        )

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return self.t_ol.shape

    def __len__(self) -> int:
        return int(np.prod(self.batch_shape)) if self.batch_shape else 1

    @property
    def t_core(self) -> np.ndarray:
        return np.maximum(self.t_nol, self.t_ol)

    def t_data(self) -> np.ndarray:
        """Cumulative transfer time per level: ``B + (L,)``, level 0 = 0."""
        zero = np.zeros(self.transfers.shape[:-1] + (1,))
        return np.concatenate(
            [zero, np.cumsum(self.transfers, axis=-1)], axis=-1)

    def predictions(self) -> np.ndarray:
        """``T_ECM`` for every batch element x level: ``B + (L,)``."""
        return eq1_predictions(self.t_ol, self.t_nol, self.transfers)

    def prediction(self, level: int | str) -> np.ndarray:
        idx = (level if isinstance(level, int)
               else self.levels.index(level))
        return self.predictions()[..., idx]

    def core_bound(self, level: int | str = -1) -> np.ndarray:
        """Vectorized :meth:`ECMModel.core_bound`: ``(B,)`` booleans."""
        return self.prediction(level) <= self.t_ol + 1e-9

    def performance(self, work_per_unit, level: int | str,
                    clock_hz: float | None = None) -> np.ndarray:
        p = np.asarray(work_per_unit, float) / self.prediction(level)
        return p * clock_hz if clock_hz else p

    def scaled(self, factor) -> "ECMBatch":
        f = np.asarray(factor, float)
        return replace(self, t_ol=self.t_ol * f, t_nol=self.t_nol * f,
                       transfers=self.transfers * f[..., None]
                       if f.ndim else self.transfers * f)

    def scalar(self, i) -> ECMModel:
        """Thin scalar view of batch element ``i`` (flat index or tuple)."""
        name = ""
        if isinstance(i, int):
            if self.names:
                name = self.names[i]
            if len(self.batch_shape) > 1:       # flat index into B dims
                i = np.unravel_index(i, self.batch_shape)
        return ECMModel(
            t_ol=float(self.t_ol[i]),
            t_nol=float(self.t_nol[i]),
            transfers=tuple(float(x) for x in self.transfers[i]),
            levels=self.levels,
            unit=self.unit,
            name=name,
        )


def eq1_predictions(t_ol, t_nol, transfers) -> np.ndarray:
    """Eq. (1) as a standalone array program: ``T_ECM`` per level.

    Shapes: ``t_ol`` and ``t_nol`` are ``B``-shaped, ``transfers`` is
    ``B + (E,)``; the result is ``B + (E + 1,)`` with level 0 carrying zero
    transfer time.
    """
    t_ol = np.asarray(t_ol, float)
    t_nol = np.asarray(t_nol, float)
    transfers = np.asarray(transfers, float)
    zero = np.zeros(transfers.shape[:-1] + (1,))
    t_data = np.concatenate([zero, np.cumsum(transfers, axis=-1)], axis=-1)
    return np.maximum(t_nol[..., None] + t_data, t_ol[..., None])
