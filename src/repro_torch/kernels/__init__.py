"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``csrc/`` holds the CUDA C++ sources (built by :mod:`._build` at first
use), :mod:`.pipeline` the multi-buffered pipeline engine and its host
contract, :mod:`.stream` the paper's stream ops, :mod:`.stencil` the
Jacobi stencils, :mod:`.matmul` the blocked matmul and :mod:`.attention`
flash attention (two kernels: the attention kernel and the split-KV
decode's combine).  :data:`KERNELS` lists every kernel wrapper; each counts
its launches.
"""
from . import attention, matmul, pipeline, stencil, stream
from .attention.kernel import FLASH_ATTENTION, FLASH_COMBINE
from .matmul.kernel import MATMUL
from .pipeline import HALO_PIPELINE, MAP_PIPELINE, REDUCE_PIPELINE
from .stencil.kernel import JACOBI2D_GRID, JACOBI3D_GRID
from .stream.kernel import GRID_MAP, GRID_REDUCE

KERNELS = (MAP_PIPELINE, REDUCE_PIPELINE, GRID_MAP, GRID_REDUCE,
           HALO_PIPELINE, JACOBI2D_GRID, JACOBI3D_GRID, MATMUL, FLASH_ATTENTION,
           FLASH_COMBINE)

#: the CUDA sources, one library each
SOURCES = tuple(sorted({k.source for k in KERNELS}))


def reset_launches() -> None:
    for k in KERNELS:
        k.reset()
