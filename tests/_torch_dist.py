"""Spawned gloo ranks for the port's mesh tests (tests/test_torch_mesh.py,
test_torch_train_mesh.py; pytest does not collect this module).

:func:`spawn` starts ``world`` CPU processes, joins them into one gloo
process group through a ``FileStore`` under the test's ``tmp_path``
(loopback only), runs ``fn(rank, *args)`` on each and waits, failing the
test if a rank raises or the ranks outlive ``timeout``.  The ranks write
their results under ``tmp_path`` for the test to read.  This module
imports torch and the port only (each rank imports it anew).
"""
import os
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank: int, fn, world: int, store: str, args: tuple) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, timeout: float = 240.0) -> None:
    ctx = mp.start_processes(_entry, args=(fn, world, str(tmp_path / "store"),
                                           args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks still running after "
                               f"{timeout} s")
