"""Atomic, manifest-driven checkpointing (the reference's
``repro/ckpt/checkpoint.py``), with its directory layout, leaf paths,
file names and ``manifest.json``, so each side restores what the other
saved.

Layout (one directory per step)::

    <root>/step_00000420.tmp-<pid>/     # staging (invisible to restore)
        manifest.json                   # leaf paths, shapes, dtypes, metadata
        <leaf-path>.npy                 # one file per tree leaf
    <root>/step_00000420/               # os.replace'd into place (atomic)

Crash safety: a checkpoint is visible iff the final ``os.replace``
happened, so a failure mid-save never corrupts the latest restorable
state.  Stale ``*.tmp-*`` staging dirs are garbage-collected on the next
save.

Leaf paths are the keys from the root joined by ``/`` (the reference's jax
key paths: ``opt_state/mu/layers/wq/q``), dict keys in sorted order.  A
bf16 leaf is written as the reference writes it: its two bytes under the
``.npy`` descr ``'<V2'``, ``"bfloat16"`` in the manifest.  Restore reads
the manifest's dtype and views those bytes as ``torch.bfloat16``; the
reference cannot restore such a leaf (ROADMAP §3).

A state sharded on a mesh (DTensor leaves) is saved whole: every rank of
the process group calls :func:`save_tree`, which gathers each leaf
(``full_tensor()``), and the first rank of the leaves' mesh writes the
same files and manifest a one-device save writes; the others wait for it
at a barrier.  :func:`restore_tree` with ``shardings`` puts each leaf back
onto its placement, every rank keeping its own block of the file.  So a
one-device checkpoint restores onto a mesh and a mesh checkpoint onto one
device.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

_SEP = "/"


def _flatten_with_paths(tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """``(path, leaf)`` in tree order: dicts by sorted key, lists and
    tuples by index."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], (*prefix, str(k)))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_paths(v, (*prefix, str(i)))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in tree order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _leaf_filename(path: str) -> str:
    return path.replace(_SEP, "__") + ".npy"


def _dtensor_mesh(tree):
    """The mesh of the tree's first DTensor leaf, or None."""
    from torch.distributed.tensor import DTensor

    for _, leaf in _flatten_with_paths(tree):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _whole(leaf):
    """A DTensor leaf gathered whole (collective over its mesh)."""
    from torch.distributed.tensor import DTensor

    return leaf.full_tensor() if isinstance(leaf, DTensor) else leaf


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """The leaf as a host numpy array and its manifest dtype: a bf16
    tensor as its raw two bytes (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = _whole(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bf16 leaf's header says ``'<V2'`` as the
    reference's ml_dtypes array does."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def save_tree(root: str, step: int, tree, *, metadata: dict | None = None
              ) -> str:
    """Atomically save a tree of tensors (or arrays) as
    ``<root>/step_<step>``; a tree of DTensors is gathered on every rank
    and written by the first rank of its mesh, the others waiting at a
    barrier."""
    final = os.path.join(root, f"step_{step:08d}")
    if _dtensor_mesh(tree) is None:
        _write_tree(root, step, final, tree, metadata)
        return final
    whole = _unflatten(tree, iter([_whole(leaf) for _, leaf in
                                   _flatten_with_paths(tree)]))
    if _writes(tree):
        _write_tree(root, step, final, whole, metadata)
    dist.barrier()
    return final


def _writes(tree) -> bool:
    """Whether this rank writes ``tree``: any rank for a tree of whole
    tensors, the first rank of the mesh for DTensors."""
    mesh = _dtensor_mesh(tree)
    return mesh is None or dist.get_rank() == mesh.mesh.reshape(-1)[0].item()


def _write_tree(root: str, step: int, final: str, tree,
                metadata: dict | None) -> None:
    os.makedirs(root, exist_ok=True)
    staging = f"{final}.tmp-{os.getpid()}"
    # GC stale staging dirs from crashed saves
    for d in os.listdir(root):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    os.makedirs(staging, exist_ok=True)

    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for path, leaf in _flatten_with_paths(tree):
        arr, dtype = _host_array(leaf)
        fn = _leaf_filename(path)
        _save_leaf(os.path.join(staging, fn), arr, dtype)
        manifest["leaves"][path] = {
            "file": fn, "shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(staging, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(staging, final)


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        if d.startswith("step_") and ".tmp-" not in d and os.path.exists(
                os.path.join(root, d, "manifest.json")):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_tree(root: str, step: int, like_tree, *, device="cuda",
                 shardings=None):
    """Restore into the structure of ``like_tree`` (tensors or specs),
    each leaf by the manifest's dtype, onto ``device`` (the card unless
    the caller asks for another), or, given ``shardings`` (a tree of
    ``dist.NamedSharding`` like ``like_tree``), as a DTensor on its
    sharding's mesh and placements.  Returns ``(tree, metadata)``."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    placed = (iter(s for _, s in _flatten_with_paths(shardings))
              if shardings is not None else None)
    out = []
    for path, _ in _flatten_with_paths(like_tree):
        ent = manifest["leaves"][path]
        leaf = _load_leaf(os.path.join(d, ent["file"]), ent["dtype"])
        out.append(leaf.to(device) if placed is None
                   else next(placed).distribute(leaf))
    return _unflatten(like_tree, iter(out)), manifest["metadata"]


def prune(root: str, keep_last: int) -> None:
    steps = list_steps(root)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


class CheckpointManager:
    """Synchronous manager: save every ``interval`` steps, keep the last N."""

    def __init__(self, root: str, *, interval: int = 100, keep_last: int = 3):
        self.root = root
        self.interval = interval
        self.keep_last = keep_last

    def maybe_save(self, step: int, tree, metadata: dict | None = None
                   ) -> str | None:
        if step % self.interval:
            return None
        path = save_tree(self.root, step, tree, metadata=metadata)
        if _writes(tree):
            prune(self.root, self.keep_last)
        return path

    def restore_latest(self, like_tree, device="cuda", shardings=None):
        s = latest_step(self.root)
        if s is None:
            return None, None, None
        tree, meta = restore_tree(self.root, s, like_tree, device=device,
                                  shardings=shardings)
        return s, tree, meta


class AsyncCheckpointer:
    """Background-thread checkpointing: the training loop hands off a
    host-transferred copy and keeps stepping (compute/IO overlap — the same
    overlap-of-contributions idea the ECM model formalizes, applied to the
    checkpoint stream)."""

    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._err: Exception | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, meta = item
            try:
                save_tree(self.root, step, tree, metadata=meta)
                prune(self.root, self.keep_last)
            # noqa rationale: the worker must never die silently — any
            # write failure is captured and re-raised on submit/close
            except Exception as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree, metadata: dict | None = None) -> None:
        """Queue a host copy of ``tree``: every tensor copied (from the
        card, or cloned on the CPU, where ``.cpu()`` would return the same
        storage), so the in-place optimizer cannot change a snapshot that
        waits in the queue.  DTensor leaves are gathered here, on every
        rank, and queued on the first rank of their mesh alone."""
        if self._err:
            raise self._err
        host_tree = _unflatten(tree, iter(
            _whole(leaf).detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else np.array(leaf)
            for _, leaf in _flatten_with_paths(tree)))
        if _writes(tree):
            self._q.put((step, host_tree, metadata))

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue and stop the worker.

        Raises ``RuntimeError`` if the worker is still alive after
        ``timeout`` seconds — a wedged writer (dead filesystem, stuck
        I/O) must be loud, not silently leaked as a daemon thread with
        a checkpoint possibly half-written.  Any error the worker
        recorded is surfaced too (chained when both happen).
        """
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(
                f"checkpoint writer thread failed to stop within "
                f"{timeout:.0f}s; a write to {self.root!r} may be "
                f"wedged or half-finished") from self._err
        if self._err:
            raise self._err
