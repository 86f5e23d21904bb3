"""Data pipeline (the reference's ``repro/data``): deterministic synthetic
streams and memmap token files, numpy batches bit for bit the
reference's.

Determinism contract (fault tolerance): ``batch(step)`` is a pure function
of ``(seed, step)``, so after a checkpoint restart the pipeline resumes at
the restored step with the same batches and no iterator state to save.
``make_global_array`` and ``shard_batch`` place a batch on a
``DeviceMesh``, each rank building its own rows alone;
``convert.batch_from_numpy`` moves a batch to one device.
"""
from .arch_data import ArchSyntheticDataset
from .pipeline import (
    DataConfig,
    SyntheticLMDataset,
    TokenFileDataset,
    make_global_array,
    shard_batch,
)

__all__ = [
    "ArchSyntheticDataset",
    "DataConfig",
    "SyntheticLMDataset",
    "TokenFileDataset",
    "make_global_array",
    "shard_batch",
]
