"""Checkpointing substrate: atomic, restartable, in the reference's
on-disk format."""
from .checkpoint import (
    AsyncCheckpointer,
    CheckpointManager,
    latest_step,
    restore_tree,
    save_tree,
)

__all__ = [
    "AsyncCheckpointer",
    "CheckpointManager",
    "latest_step",
    "restore_tree",
    "save_tree",
]
