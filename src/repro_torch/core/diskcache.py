"""On-disk persistence for fitted calibrations.

A copy of the reference's ``repro/core/diskcache.py``: a small
content-addressed JSON cache that survives a process restart.

* **Keying.**  Every entry is keyed by ``(machine fingerprint, payload
  key)``.  The machine fingerprint is a stable sha256 over every field of
  the :class:`~.machine.GPUMachineModel`, so any calibration change (a new
  ``measured_bw``, a fitted capacity) changes the fingerprint and the old
  entry simply never matches again.
* **Safety.**  Values round-trip through ``repr``/``ast.literal_eval``,
  exact for the plain-Python dicts (floats, ints, bools, tuples) that JSON
  would mangle.  Corrupted files, schema mismatches and foreign
  fingerprints are misses, never crashes: the cache is an accelerator, not
  a source of truth.

The cache is opt-in: set ``REPRO_TORCH_CACHE_DIR`` (or call
:func:`set_cache_dir`) to enable it.  It reads its own variable, so the
port and the reference never share entries.  With no directory every
``get`` misses and every ``put`` is a no-op.  The port has no machine
registry, so the reference's registry invalidation hooks have no
counterpart; content hashing alone invalidates.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
from dataclasses import fields, is_dataclass
from pathlib import Path

from .machine import GPUMachineModel

#: Cache-file schema version; files written by a different schema are
#: treated as misses (and left in place for the version that owns them).
CACHE_SCHEMA = 1

#: Environment variable naming the cache directory (enables the cache).
CACHE_DIR_ENV = "REPRO_TORCH_CACHE_DIR"

#: Observability counters for tests and the smoke test.
COUNTERS = {"hits": 0, "misses": 0, "puts": 0, "rejected": 0}

_state: dict = {"dir": None, "from_env": True}
_MEMO: dict = {}


def reset_counters() -> None:
    for k in COUNTERS:
        COUNTERS[k] = 0


def cache_dir() -> Path | None:
    """The active cache directory, or ``None`` when the cache is disabled."""
    if _state["from_env"]:
        env = os.environ.get(CACHE_DIR_ENV)
        return Path(env) if env else None
    return _state["dir"]


def enabled() -> bool:
    return cache_dir() is not None


def set_cache_dir(path: "str | os.PathLike | None"):
    """Point the cache at ``path`` (``None`` disables it); returns the
    previous setting for :func:`restore_cache_dir`.  Overrides the
    ``REPRO_TORCH_CACHE_DIR`` environment variable until restored."""
    prev = (_state["dir"], _state["from_env"])
    _state["dir"] = Path(path) if path is not None else None
    _state["from_env"] = False
    _MEMO.clear()
    return prev


def restore_cache_dir(prev) -> None:
    """Undo :func:`set_cache_dir` with its return value."""
    _state["dir"], _state["from_env"] = prev
    _MEMO.clear()


def clear_memo() -> None:
    _MEMO.clear()


def stable_form(obj):
    """Reduce ``obj`` to a deterministic, ``repr``-stable literal form:
    recursive field equality, the same form (and so the same cache file
    name) in every process."""
    if obj is None or type(obj) in (bool, int, float, str, bytes):
        return obj
    if is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__module__, type(obj).__qualname__) + tuple(
            (f.name, stable_form(getattr(obj, f.name))) for f in fields(obj))
    if isinstance(obj, dict):
        return ("dict",) + tuple(
            (k, stable_form(v)) for k, v in sorted(obj.items()))
    if isinstance(obj, (tuple, list)):
        return (type(obj).__name__,) + tuple(stable_form(v) for v in obj)
    if hasattr(obj, "tolist"):                      # numpy array / scalar
        return ("array", stable_form(obj.tolist()))
    raise TypeError(f"no stable cache form for {type(obj)!r}")


def _digest(obj) -> str:
    return hashlib.sha256(repr(stable_form(obj)).encode()).hexdigest()


def machine_fingerprint(machine: GPUMachineModel) -> str:
    """Stable content hash over every field of a machine."""
    if not isinstance(machine, GPUMachineModel):
        raise TypeError(f"machine_fingerprint takes a GPUMachineModel, got "
                        f"{type(machine)!r}")
    return _digest(machine)


def _pyify(value):
    """Coerce numpy scalars/arrays inside ``value`` to plain literals so the
    stored ``repr`` survives ``ast.literal_eval``."""
    if value is None or type(value) in (bool, int, float, str, bytes):
        return value
    if isinstance(value, dict):
        return {k: _pyify(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return tuple(_pyify(v) for v in value)
    if isinstance(value, list):
        return [_pyify(v) for v in value]
    if hasattr(value, "item") and not hasattr(value, "shape"):
        return value.item()
    if hasattr(value, "tolist"):
        return value.tolist()
    if isinstance(value, (bool, int, float)):       # numpy bool_/int_/float_
        return value
    try:                                            # np.float64 etc.
        return value.item()
    except AttributeError:
        raise TypeError(f"cannot cache a value of type {type(value)!r}")


def _entry_path(kind: str, machine_fp: str, key_digest: str) -> Path:
    d = cache_dir()
    assert d is not None
    return d / kind / f"{machine_fp[:16]}-{key_digest[:24]}.json"


def get(kind: str, key, machine: GPUMachineModel | None = None):
    """Look up a cached value; ``None`` on any miss (including corrupted or
    foreign-schema files, which count in ``COUNTERS['rejected']``)."""
    if not enabled():
        COUNTERS["misses"] += 1
        return None
    fp = machine_fingerprint(machine) if machine is not None else "nomachine"
    kd = _digest((CACHE_SCHEMA, kind, stable_form(key)))
    memo_key = (kind, fp, kd)
    if memo_key in _MEMO:
        COUNTERS["hits"] += 1
        return _MEMO[memo_key]
    path = _entry_path(kind, fp, kd)
    try:
        doc = json.loads(path.read_text())
    except FileNotFoundError:
        COUNTERS["misses"] += 1
        return None
    except (OSError, ValueError):
        COUNTERS["rejected"] += 1
        COUNTERS["misses"] += 1
        return None
    try:
        if (not isinstance(doc, dict)
                or doc.get("schema") != CACHE_SCHEMA
                or doc.get("kind") != kind
                or doc.get("machine_fp") != fp):
            raise ValueError("cache envelope mismatch")
        value = ast.literal_eval(doc["value"])
    except (KeyError, ValueError, SyntaxError, TypeError, MemoryError):
        COUNTERS["rejected"] += 1
        COUNTERS["misses"] += 1
        return None
    _MEMO[memo_key] = value
    COUNTERS["hits"] += 1
    return value


def put(kind: str, key, value, machine: GPUMachineModel | None = None
        ) -> Path | None:
    """Persist ``value`` under ``(kind, machine, key)``; no-op when the
    cache is disabled.  Returns the file path written."""
    if not enabled():
        return None
    value = _pyify(value)
    fp = machine_fingerprint(machine) if machine is not None else "nomachine"
    kd = _digest((CACHE_SCHEMA, kind, stable_form(key)))
    path = _entry_path(kind, fp, kd)
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {
        "schema": CACHE_SCHEMA,
        "kind": kind,
        "machine_fp": fp,
        "machine": getattr(machine, "name", machine),
        "key": repr(stable_form(key)),
        "value": repr(value),
    }
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    os.replace(tmp, path)
    _MEMO[(kind, fp, kd)] = value
    COUNTERS["puts"] += 1
    return path
