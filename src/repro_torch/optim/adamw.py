"""AdamW with global-norm clipping and optionally int8-quantized moments
(the reference's ``repro/optim/adamw.py``).

State layout per parameter leaf:

* ``f32``/``bf16`` moments: ``mu``/``nu`` tensors of the parameter's shape.
* ``int8`` moments: a ``{"q": int8, "scale": f32}`` dict per moment, the
  scales per row over the last axis (symmetric quantization): the moment
  streams move ~2 B/param instead of 8.

All moment math happens in f32, as in the reference, with its roundings:
``b1 ** count`` in f32, the update cast to the parameter's dtype before it
is added in f32.  The leaves are visited in the reference's tree order
(sorted dict keys; an int8 moment's dict is one leaf).

The reference returns new state and lets its driver donate the old.
Eager PyTorch cannot donate, so the update writes in place:
:func:`adamw_update` consumes ``state`` (its moments and count are
overwritten, and the returned state holds the same tensors), and
:func:`adamw_step`, which the train step runs, also adds each leaf's
update into its parameter before it moves to the next leaf, under
``torch.no_grad()``.  A step then holds no second copy of the
parameters or the moments, only one leaf's f32 temporaries.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..models.common import ParamSpec, tree_leaves, tree_map
from .schedule import Schedule, constant

_STORED = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    moment_dtype: str = "f32"          # f32 | bf16 | int8
    #: the reference's optimization barriers between leaves (XLA would
    #: otherwise schedule every leaf's f32 chain at once); eager leaves are
    #: already serialized, so the field only carries configs over
    serialize_leaves: bool = True

    def validate(self) -> None:
        if self.moment_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(f"moment_dtype {self.moment_dtype!r}: one of "
                             f"f32, bf16, int8")


# ---------------------------------------------------------------------------
# int8 moment quantization (symmetric, per-row over the last axis)
# ---------------------------------------------------------------------------


def _quantize(x: torch.Tensor, row_absmax_=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Round half to even (``jnp.round``, ``torch.round``) onto [-127,
    127], the scale the row's absmax over 127 with a 1e-12 floor.  On a
    shard of a leaf split along its last dim, ``row_absmax_`` makes the
    shard's row absmax the whole row's, in place."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if row_absmax_ is not None:
        row_absmax_(absmax)
    scale = absmax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


def _moment_like(p: torch.Tensor, cfg: AdamWConfig):
    if cfg.moment_dtype == "int8":
        scale_shape = (*p.shape[:-1], 1) if p.ndim else ()
        return {"q": torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                "scale": torch.zeros(scale_shape, device=p.device)}
    return torch.zeros(p.shape, dtype=_STORED[cfg.moment_dtype],
                       device=p.device)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments beside each parameter, on its device, and a zero
    count on the first leaf's device."""
    cfg.validate()
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(lambda p: _moment_like(p, cfg), params),
        "nu": tree_map(lambda p: _moment_like(p, cfg), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def opt_state_spec(param_spec_tree, cfg: AdamWConfig) -> dict:
    """Optimizer-state ParamSpec tree mirroring the parameter specs
    (moments keep the parameter's logical axes)."""
    cfg.validate()

    def moment_spec(s: ParamSpec):
        if cfg.moment_dtype == "int8":
            scale_shape = (*s.shape[:-1], 1) if s.shape else ()
            scale_axes = (*s.axes[:-1], None) if s.axes else ()
            return {
                "q": ParamSpec(s.shape, s.axes, init="zeros", dtype=torch.int8),
                "scale": ParamSpec(scale_shape, scale_axes, init="zeros",
                                   dtype=torch.float32),
            }
        return ParamSpec(s.shape, s.axes, init="zeros",
                         dtype=_STORED[cfg.moment_dtype])

    return {
        "mu": tree_map(moment_spec, param_spec_tree),
        "nu": tree_map(moment_spec, param_spec_tree),
        "count": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def global_norm(tree) -> torch.Tensor:
    """sqrt of the per-leaf sums of squares (each a dot product of the
    leaf in f32, one read), added in tree order."""
    total = 0
    for leaf in tree_leaves(tree):
        flat = leaf.float().reshape(-1)
        total = total + torch.dot(flat, flat)
    return torch.sqrt(total)


def _moment_leaves(tree) -> list:
    """The moments in tree order, an int8 moment's ``{"q", "scale"}`` dict
    as one leaf (the reference's ``is_leaf``)."""
    if isinstance(tree, dict) and "q" not in tree:
        return [leaf for k in sorted(tree) for leaf in _moment_leaves(tree[k])]
    return [tree]


def _load_moment(m, cfg: AdamWConfig) -> torch.Tensor:
    if cfg.moment_dtype == "int8":
        return _dequantize(m["q"], m["scale"])
    return m.float()


def _store_moment_(m, x: torch.Tensor, cfg: AdamWConfig,
                   row_absmax_=None) -> None:
    """``x`` written into the stored moment ``m`` (rounded to bf16 by
    ``copy_``, as ``astype`` rounds, or quantized)."""
    if cfg.moment_dtype == "int8":
        q, scale = _quantize(x, row_absmax_)
        m["q"].copy_(q)
        m["scale"].copy_(scale)
    else:
        m.copy_(x)


@torch.no_grad()
@record_function("adamw")
def _update_leaves(grads, state: dict, params, cfg: AdamWConfig,
                   schedule: Schedule | None, take, shards=None) -> dict:
    """One AdamW step, leaf by leaf in tree order: each leaf's moments are
    written in place and its update ``u`` (the parameter's dtype) handed
    to ``take(p, u)`` before the next leaf; the count is advanced in
    place.  Returns the metrics.  ``shards`` (a
    ``dist.DataParallel``): the leaves are local shards, the norm and the
    int8 row absmax are taken over the whole leaves."""
    cfg.validate()
    schedule = schedule or constant(1e-3)
    count = state["count"] + 1
    lr = schedule(count)
    gnorm = (global_norm(grads) if shards is None
             else shards.global_norm(tree_leaves(grads)))
    clip = (torch.clamp(gnorm.new_tensor(cfg.grad_clip_norm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
            if cfg.grad_clip_norm else gnorm.new_tensor(1.0))
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for i, (g, m, v, p) in enumerate(zip(
            tree_leaves(grads), _moment_leaves(state["mu"]),
            _moment_leaves(state["nu"]), tree_leaves(params))):
        gf = g.float() * clip
        mf = b1 * _load_moment(m, cfg) + (1 - b1) * gf
        vf = b2 * _load_moment(v, cfg) + (1 - b2) * gf * gf
        step_dir = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        if cfg.weight_decay:
            step_dir = step_dir + cfg.weight_decay * p.float()
        del gf
        take(p, (-lr * step_dir).to(p.dtype))
        del step_dir
        row = (None if shards is None
               else lambda a, i=i: shards.row_absmax_(i, a))
        _store_moment_(m, mf, cfg, row)
        _store_moment_(v, vf, cfg, row)
    state["count"].copy_(count)
    return {"grad_norm": gnorm, "lr": lr}


def adamw_update(grads, state: dict, params, cfg: AdamWConfig,
                 schedule: Schedule | None = None):
    """One AdamW step.  Returns ``(updates, new_state, metrics)``; apply
    with :func:`apply_updates`.  ``state`` is consumed: its moments and
    count are updated in place and ``new_state`` is ``state``."""
    updates = []
    metrics = _update_leaves(grads, state, params, cfg, schedule,
                             lambda p, u: updates.append(u))
    it = iter(updates)
    return tree_map(lambda _: next(it), params), state, metrics


def _apply_(p: torch.Tensor, u: torch.Tensor) -> None:
    """``p = (p + u)`` in f32, rounded to p's dtype, in place."""
    if p.dtype == torch.float32:
        p.add_(u)
    else:
        p.copy_(p.float() + u.float())


@torch.no_grad()
def apply_updates(params, updates):
    """The updates added into the parameters in place (f32 sums rounded
    to each parameter's dtype, as the reference's); returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        _apply_(p, u)
    return params


def adamw_step(grads, state: dict, params, cfg: AdamWConfig,
               schedule: Schedule | None = None, *, shards=None) -> dict:
    """:func:`adamw_update` and :func:`apply_updates` fused leaf by leaf:
    each leaf's update is added into its parameter before the next leaf
    is taken, so no tree of updates exists.  The same arithmetic, so the
    same bits.  Consumes ``state`` and ``params`` in place; returns the
    metrics (``grad_norm`` before clipping, ``lr``).  ``shards``: the
    leaves are local shards of a mesh's state (``dist.DataParallel``)."""
    return _update_leaves(grads, state, params, cfg, schedule, _apply_, shards)
