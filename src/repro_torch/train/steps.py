"""Train, prefill, serve and eval steps over the uniform ArchDef API (the
reference's ``repro/train/steps.py``), eager, the gradients from
autograd.

The train state is a plain dict tree, as the reference's (easy to
checkpoint)::

    {"params": ..., "opt_state": {"mu", "nu", "count"}, "step": int32}

The parameters are f32 masters; the model casts each to the compute dtype
where it uses it (or once per step, ``cast_once``) inside the autograd
graph, so the gradients arrive in f32, as through the reference's cast
VJP.  ``train_step`` consumes the state it is given: the optimizer writes
the parameters, moments and counts in place, leaf by leaf
(``optim.adamw_step``), and the state returned holds the same tensors.
The reference's driver donates the state to its jitted step
(``donate_argnums=(0,)``) for the same reason: at internlm2-1.8b's width a
second copy of the parameters and moments is 22.75 GB.

``accum > 1`` runs the batch as ``accum`` micro-batches (the leading axis
split, as the reference's ``lax.scan`` over ``(accum, B/accum, ...)``),
adds their gradients in f32 and divides by ``accum``; the loss and the
other metrics are the micro-batches' means.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchDef
from ..dist import DataParallel, LocalBlock
from ..models.common import (ParamSpec, materialize, tree_leaves, tree_map,
                             xent_over)
from ..optim import AdamWConfig, adamw_init, adamw_step, opt_state_spec
from ..optim.schedule import Schedule

# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def init_state(arch: ArchDef, generator: torch.Generator, opt_cfg: AdamWConfig,
               *, device="cuda") -> dict:
    """Parameters drawn by ``materialize`` from ``generator`` (on
    ``device``: the card unless the caller asks for the CPU), zero moments
    and step."""
    params = materialize(arch.param_spec(), generator, device=device)
    return {
        "params": params,
        "opt_state": adamw_init(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def state_spec(arch: ArchDef, opt_cfg: AdamWConfig) -> dict:
    pspec = arch.param_spec()
    return {
        "params": pspec,
        "opt_state": opt_state_spec(pspec, opt_cfg),
        "step": ParamSpec((), (), init="zeros", dtype=torch.int32),
    }


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _split_micro(batch: dict, accum: int) -> dict:
    """Each batch array as ``(accum, B/accum, ...)``."""
    def r(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} "
                             f"micro-batches")
        return x.reshape(accum, b // accum, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def _tensor(p) -> torch.Tensor:
    """A parameter leaf's tensor: a rank's ``LocalBlock`` by its block."""
    return p.tensor if isinstance(p, LocalBlock) else p


def cast_params_for_compute(arch: ArchDef, params):
    """fp32 master / low-precision compute: the >= 2-D f32 parameters
    (tensors, or a rank's blocks) cast to the arch's compute dtype once
    at step entry (the reference's opt-in knob, default off).  Under
    autograd the cast is in the graph, so the gradients still arrive in
    f32."""
    cdt = getattr(arch.cfg, "dtype", None)
    if cdt is None:
        return params

    def cast(p):
        t = _tensor(p)
        if t.ndim < 2 or t.dtype != torch.float32:
            return p
        if isinstance(p, LocalBlock):
            return dataclasses.replace(p, tensor=t.to(cdt))
        return t.to(cdt)
    return tree_map(cast, params)


def _detached(metrics: dict) -> dict:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v
            for k, v in metrics.items()}


def _value_and_grad(arch: ArchDef, params, batch: dict, cast_once: bool,
                    xent=None, share: float = 1.0):
    leaves = [_tensor(p) for p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    try:
        with xent_over(*xent) if xent else contextlib.nullcontext():
            p = cast_params_for_compute(arch, params) if cast_once else params
            loss, metrics = arch.loss(p, batch)
            seed = None if share == 1.0 else torch.full_like(loss, share)
            grads = torch.autograd.grad(loss, leaves, seed, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), _detached(metrics), tree_map(lambda _: next(it), params)


def value_and_grad(arch: ArchDef, params, batch: dict, *, accum: int = 1,
                   cast_once: bool = False, xent: list | None = None,
                   share: float = 1.0):
    """``(loss, metrics, grads)`` of ``arch.loss`` at ``params`` (the
    reference's ``jax.value_and_grad(..., has_aux=True)``): the grads a
    tree like ``params``, zeros for a leaf the loss does not reach.  The
    parameters (tensors, or a rank's blocks) require grad for the call
    only.  ``accum > 1``: the micro-batches' gradients added in f32 in
    order and divided by ``accum``, their loss and metrics averaged.
    ``xent``: one ``(count, scale)`` a micro-batch, under which its
    masked cross entropy is normalized (``models.common.xent_over``).
    ``share``: the seed of the backward (a rank's share of a mesh step's
    mean loss, ``DataParallel.share``); the loss returned is unscaled."""
    xent = xent or [None] * accum
    if accum == 1:
        return _value_and_grad(arch, params, batch, cast_once, xent[0], share)
    micro = _split_micro(batch, accum)
    grads, runs = None, []
    for i in range(accum):
        loss, metrics, g = _value_and_grad(
            arch, params, {k: v[i] for k, v in micro.items()}, cast_once,
            xent[i], share)
        runs.append({**metrics, "loss": loss})
        if grads is None:
            grads = tree_map(lambda x: x.float().contiguous(), g)
        else:
            for a, b in zip(tree_leaves(grads), tree_leaves(g)):
                a.add_(b.float())
        del g
    for a in tree_leaves(grads):
        a.div_(accum)
    device = runs[0]["loss"].device
    means = {k: torch.stack([torch.as_tensor(r[k], dtype=torch.float32,
                                             device=device)
                             for r in runs]).mean()
             for k in runs[0]}
    return means.pop("loss"), means, grads


def make_train_step(arch: ArchDef, opt_cfg: AdamWConfig,
                    schedule: Schedule | None = None, *, accum: int = 1,
                    cast_once: bool = False, mesh=None, shardings=None,
                    batch_axes: tuple[str, ...] = ("data",)) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is consumed (updated in place) and returned.  With a ``mesh``, the
    step of :func:`make_sharded_train_step` on the state's
    ``shardings``."""
    if mesh is not None:
        return make_sharded_train_step(arch, opt_cfg, schedule, mesh=mesh,
                                       shardings=shardings,
                                       batch_axes=batch_axes, accum=accum,
                                       cast_once=cast_once)

    def train_step(state: dict, batch: dict):
        params = state["params"]
        loss, metrics, grads = value_and_grad(arch, params, batch, accum=accum,
                                              cast_once=cast_once)
        om = adamw_step(grads, state["opt_state"], params, opt_cfg, schedule)
        del grads
        state["step"].add_(1)
        return state, {**metrics, **om, "loss": loss}

    return train_step


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _xent_counts(dp: DataParallel, batch: dict, accum: int) -> list | None:
    """Per local micro-batch, the token count of the data-parallel
    micro-batch it belongs to and the data ranks (``xent_over``'s
    arguments).  Rank ``r``'s rows are the ``r``-th block of the batch,
    so its micro-batch ``i`` lies in the global micro-batch ``(r * accum
    + i) // ranks``, whose count adds the masks of the ``ranks`` local
    micro-batches there."""
    mask = batch.get("mask")
    if mask is None:
        return None
    masks = [mask] if accum == 1 else list(_split_micro({"m": mask}, accum)["m"])
    counts = dp.batch_counts(torch.stack([m.float().sum() for m in masks]))
    out = []
    for i in range(accum):
        j = (dp.rank * accum + i) // dp.ranks
        out.append((counts[j * dp.ranks:(j + 1) * dp.ranks].sum(), dp.ranks))
    return out


def make_sharded_train_step(arch: ArchDef, opt_cfg: AdamWConfig,
                            schedule: Schedule | None = None, *, mesh,
                            shardings, batch_axes: tuple[str, ...] = ("data",),
                            accum: int = 1, cast_once: bool = False
                            ) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` on a
    ``DeviceMesh``: tensor parallel over the axes that shard the
    parameters, data parallel over ``batch_axes``.

    ``state`` lives sharded at rest, each leaf a DTensor on its
    ``shardings`` leaf (``param_shardings(state_spec(...))``: parameters,
    both moments, the int8 scales, the counts); ``batch`` holds this
    rank's rows (``data.shard_batch``'s DTensors, or local tensors).  Each
    step hands the model every parameter as the rank's block
    (``LocalBlock``, the local shard; with ``cast_once`` cast inside the
    graph) and runs :func:`value_and_grad` on them and the rank's rows:
    the model computes on its heads, columns and vocabulary block, a
    weight sharded over an axis its use does not split gathered at that
    use, layer by layer, never whole for the step, the logits gathered
    over ``model`` for the one-device cross entropy (the serve steps'
    layers, ``models/common.py``).  Each collective's backward is its
    exact adjoint and the backward is seeded with the rank's share of
    the mean over the mesh (``dist/collectives.py``), so each block's
    gradient, summed over the axes that replicate its leaf
    (``dist.DataParallel.reduce_grad``, once a leaf, in tree order), is
    the leaf's local shard of the averaged gradient; the optimizer
    updates the local shards in place (``optim.adamw_step`` with the
    clipping norm and the int8 row absmax over the whole leaves).  The
    step installs ``mesh`` and ``batch_axes`` as the ambient context
    (``dist.use_mesh_context``, no profile) for the model to read.

    The masked cross entropy of each micro-batch is normalized by the
    tokens of the whole data-parallel micro-batch (``xent_over``), so the
    step equals the one-device step on the global batch however the
    mask's tokens fall to the ranks.  The MoE dispatches each data rank's
    rows alone (the capacity from its own tokens), its aux loss averaged
    over the ranks: the reference's ``shard_map`` semantics.  The
    metrics are averaged over the batch axes before they are returned.
    On a mesh whose dims all have size 1 the step is the ``mesh=None``
    step bit for bit."""
    from ..dist.sharding import use_mesh_context

    param_shardings = shardings["params"]
    dp = DataParallel(mesh, batch_axes, param_shardings)

    def train_step(state: dict, batch: dict):
        params = tree_map(lambda d: LocalBlock.of(d.detach()), state["params"])
        local = {k: _local(v) for k, v in batch.items()}
        with use_mesh_context(mesh, None, multi_pod="pod" in batch_axes):
            loss, metrics, grads = value_and_grad(
                arch, params, local, accum=accum, cast_once=cast_once,
                xent=_xent_counts(dp, local, accum), share=dp.share)
        del params
        it = iter([dp.reduce_grad(g, i)
                   for i, g in enumerate(tree_leaves(grads))])
        grads = tree_map(lambda _: next(it), state["params"])
        om = adamw_step(grads, tree_map(_local, state["opt_state"]),
                        tree_map(_local, state["params"]), opt_cfg, schedule,
                        shards=dp)
        del grads
        _local(state["step"]).add_(1)
        vals = {**metrics, "loss": loss}
        names = sorted(vals)
        mean = dp.mean(torch.stack([torch.as_tensor(vals[k], dtype=torch.float32,
                                                    device=loss.device)
                                    for k in names]))
        return state, {**dict(zip(names, mean.unbind())), **om}

    return train_step


def _tensor_parallel(params) -> bool:
    """Whether ``params`` are sharded DTensors: the steps then run tensor
    parallel."""
    return isinstance(tree_leaves(params)[0], DTensor)


def _blocks(arch: ArchDef, params, cast_once: bool):
    """Each parameter DTensor as the rank's ``LocalBlock`` (one
    ``to_local()`` a leaf); ``cast_once``: the >= 2-D f32 blocks cast to
    the compute dtype (:func:`cast_params_for_compute`)."""
    blocks = tree_map(LocalBlock.of, params)
    return cast_params_for_compute(arch, blocks) if cast_once else blocks


def _placed(b) -> DTensor:
    """A ``LocalBlock`` as the DTensor its sharding places (no copy)."""
    return DTensor.from_local(b.tensor, b.mesh, b.sharding.placements(),
                              run_check=False)


def _split_length(cache: dict) -> tuple[dict, object]:
    """A cache tree without its host ``length``, and the length."""
    return {k: v for k, v in cache.items() if k != "length"}, cache["length"]


def _all_rows(logits, batch_entry, mesh):
    """The logits of every rank's rows, gathered over the batch axes (the
    reference's serve steps return them whole: ``out_shardings=None``)."""
    from ..dist.collectives import gather_entry

    return gather_entry(logits, mesh, batch_entry, 0)


def _batch_leaf(arch: ArchDef) -> tuple[int, int]:
    """``(leaf, dim)``: the first leaf of the arch's cache tree (its host
    ``length`` left out) with a ``batch`` axis, and that axis's dim; its
    placement places the batch's rows (every family's cache has one; a
    decode's tokens may come as the rank's rows, with no placement)."""
    axes = tree_leaves(tree_map(lambda s: s.axes,
                                _split_length(arch.cache_spec(1, 1))[0]))
    for i, ax in enumerate(axes):
        if "batch" in ax:
            return i, ax.index("batch")
    raise ValueError(f"{arch.name}: no cache leaf has a batch axis")


def _prefill_cache_spec(arch: ArchDef, batch: dict, max_len: int | None):
    """The cache spec tree a prefill of ``batch`` fills: the arch's cache
    at ``max(prompt, max_len)`` positions, whisper's cross K/V at the
    frames the batch carries (not the config's ``max_frames``)."""
    tokens = batch["tokens"]
    prefix = batch.get("patch_embeds")
    seq = tokens.shape[1] + (0 if prefix is None else prefix.shape[1])
    kw = {"n_frames": batch["frames"].shape[1]} if "frames" in batch else {}
    return arch.cache_spec_fn(arch.cfg, tokens.shape[0],
                              max(seq, max_len or 0), **kw)


def make_prefill_step(arch: ArchDef, *, max_len: int | None = None,
                      cast_once: bool = False, cache_profile=None) -> Callable:
    """``prefill_step(params, batch) -> (logits, cache)``.

    On a mesh (tensor parallel; run it under ``dist.use_mesh_context``):
    ``params`` DTensors placed by ``param_shardings(...,
    ensure_model_axis=True)``, ``batch`` DTensors placed by the input
    profile ``cache_profile`` (``dist.sharding.input_profile``).  Each
    leaf's block is taken once (``to_local()``), never gathered whole;
    the model computes on the blocks and the rank's rows.  The cache is
    the arch's whole cache tree (nested dicts kept), each leaf the rank's
    zero block of its placement by ``param_shardings(cache_spec,
    mesh, cache_profile)``, which the family's ``prefill(cache=)``
    writes in place; it comes back as those DTensors with the host
    length, the logits of the whole batch gathered (the reference's
    ``out_shardings=None``)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if not _tensor_parallel(params):
            p = cast_params_for_compute(arch, params) if cast_once else params
            return arch.prefill(p, batch, max_len=max_len)
        from ..dist.collectives import spec_of
        from ..dist.sharding import mesh_device, param_shardings

        if cache_profile is None:
            raise ValueError("a prefill on a mesh places its cache by the "
                             "input profile: pass cache_profile")
        tokens = batch["tokens"]
        if not isinstance(tokens, DTensor):
            raise TypeError("a prefill on a mesh takes the batch as DTensors "
                            "placed by the input profile")
        mesh = tokens.device_mesh
        spec, _ = _split_length(_prefill_cache_spec(arch, batch, max_len))
        coord = mesh.get_coordinate()

        def zero_block(s, sh):
            shape = [sl.stop - sl.start for sl in sh.index(coord, s.shape)]
            return LocalBlock.at(torch.zeros(shape, dtype=s.dtype,
                                             device=mesh_device(mesh)),
                                 sh, s.shape)
        shardings = iter(tree_leaves(param_shardings(spec, mesh,
                                                     cache_profile)))
        cache = tree_map(lambda s: zero_block(s, next(shardings)), spec)
        logits, out = arch.prefill_fn(
            _blocks(arch, params, cast_once), arch.cfg,
            {k: _local(v) for k, v in batch.items()}, max_len=max_len,
            cache=cache)
        return (_all_rows(logits, spec_of(tokens)[0], mesh),
                {**tree_map(_placed, cache), "length": out["length"]})
    return prefill_step


def make_serve_step(arch: ArchDef, *, cast_once: bool = False) -> Callable:
    """One batched decode step: ``serve_step(params, cache, batch)``.  On
    a mesh (under ``dist.use_mesh_context``, with its ``cache_seq_axis``
    where a cache is split by sequence): the parameters and the cache
    DTensors as :func:`make_prefill_step` makes them, ``batch`` the tokens
    (the rank's rows, or DTensors); every cache leaf is handed over as
    the rank's block, which the family's decode writes in place, and the
    logits of the whole batch are returned."""
    batch_leaf = None       # (leaf, dim) of the batch's placement, found once

    @torch.no_grad()
    def serve_step(params, cache, batch):
        nonlocal batch_leaf
        if not _tensor_parallel(params):
            p = cast_params_for_compute(arch, params) if cast_once else params
            return arch.decode(p, cache, batch)
        from ..dist.collectives import spec_of

        leaves, length = _split_length(cache)
        blocks = {**tree_map(LocalBlock.of, leaves), "length": length}
        logits, out = arch.decode(_blocks(arch, params, cast_once), blocks,
                                  {k: _local(v) for k, v in batch.items()})
        if batch_leaf is None:
            batch_leaf = _batch_leaf(arch)
        leaf = tree_leaves(leaves)[batch_leaf[0]]
        return (_all_rows(logits, spec_of(leaf)[batch_leaf[1]],
                          leaf.device_mesh),
                {**leaves, "length": out["length"]})
    return serve_step


def make_eval_step(arch: ArchDef) -> Callable:
    """``eval_step(params, batch) -> metrics``, under ``torch.no_grad()``
    (so ``attn_impl="flash"`` may run the kernel, which has no
    backward)."""
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = arch.loss(params, batch)
        return metrics
    return eval_step
