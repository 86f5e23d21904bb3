"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries go
into ``kernels/build/`` (listed in ``.gitignore``) under a name that
carries the hash of the sources and flags, so an edit to any source or
header triggers a rebuild and nothing stale is ever loaded.  Sources come
from this package alone.

Every C entry returns ``cudaGetLastError()`` after its launches; a
:class:`Kernel` raises when that is not 0 and counts a launch only when
it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...]) -> dict[str, Path]:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the libraries."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, t in todo.items():
        tmp = t.with_suffix(f".{os.getpid()}.tmp")
        log = open(t.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        try:
            rc = proc.wait(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        finally:
            log.close()
        if rc == 0:
            os.replace(tmp, todo[n])
        else:
            failed.append(f"{n}.cu (exit {rc}, see {todo[n].with_suffix('.log')})")
    if failed:
        raise RuntimeError("nvcc failed: " + "; ".join(failed))
    return targets


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)' for '(\w+)'")
_PTXAS_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")


def ptxas_report(name: str) -> list[dict]:
    """What ``-Xptxas -v`` said of each kernel of ``csrc/<name>.cu`` in its
    build log: ``{"kernel", "registers", "spill_stores", "spill_loads",
    "stack_bytes"}`` per entry, the name demangled where ``c++filt``
    exists.  The library must be built."""
    entries, cur = [], None
    for line in _target(name).with_suffix(".log").read_text().splitlines():
        if m := _PTXAS_ENTRY.search(line):
            cur = {"kernel": m.group(1)}
            entries.append(cur)
        elif cur is not None and (m := _PTXAS_STACK.search(line)):
            cur |= {"stack_bytes": int(m.group(1)), "spill_stores": int(m.group(2)),
                    "spill_loads": int(m.group(3))}
        elif cur is not None and (m := _PTXAS_USED.search(line)):
            cur["registers"] = int(m.group(1))
    if shutil.which("c++filt") and entries:
        names = subprocess.run(["c++filt"], input="\n".join(e["kernel"] for e in entries),
                               capture_output=True, text=True, check=True).stdout.split("\n")
        for e, d in zip(entries, names):
            e["kernel"] = d.replace("(anonymous namespace)::", "")
    return entries


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build((name,))[name]))
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


class Kernel:
    """One C entry of a built library, with the count of its launches.

    ``argtypes`` must give ``ctypes.c_void_p`` for every pointer and for
    the stream, or ctypes would pass them as 32-bit ints.  An entry with
    several device routes behind it names them in ``routes``; each launch
    then names its route, counted in ``launches_by_route``.  Routes with
    C entries of their own give ``symbol`` and ``argtypes`` as dicts by
    route.
    """

    route = "cuda"

    def __init__(self, name: str, source: str, symbol: str | dict[str, str],
                 argtypes: list | dict[str, list],
                 replaces: str, routes: tuple[str, ...] = ()):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.routes = routes
        self._fns = {}
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        self.launches_by_route = dict.fromkeys(self.routes, 0)

    @property
    def source_path(self) -> str:
        return f"src/repro_torch/kernels/csrc/{self.source}.cu"

    def launch(self, *args, route: str | None = None) -> None:
        if route not in (self.routes or (None,)):
            raise ValueError(f"{self.symbol}: route {route!r}, not one of "
                             f"{self.routes}")
        fn = self._fns.get(route)
        if fn is None:
            by_route = isinstance(self.symbol, dict)
            fn = getattr(library(self.source),
                         self.symbol[route] if by_route else self.symbol)
            fn.argtypes = self.argtypes[route] if by_route else self.argtypes
            fn.restype = ctypes.c_int
            self._fns[route] = fn
        rc = fn(*args)
        if rc != 0:
            msg = library(self.source).rt_error_string(rc).decode()
            raise RuntimeError(f"{fn.__name__}: CUDA error {rc}: {msg}")
        self.launches += 1
        if route is not None:
            self.launches_by_route[route] += 1
