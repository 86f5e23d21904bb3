"""Fault-tolerant training driver (the reference's
``repro/train/driver.py``).

Failure model and the response here:

* **Process crash / preemption**: training state lives in the newest
  atomic checkpoint (``repro_torch.ckpt``); on restart the driver
  restores the latest step and the deterministic data pipeline resumes
  bit-identically (batches are a pure function of step).  Simulated in
  tests by raising ``InjectedFailure`` mid-run and running a fresh
  driver.
* **Node loss (shrink)**: ``train.elastic`` builds a smaller mesh and
  moves the live state onto it; the caller makes a new driver there.
* **Stragglers**: a synchronous data-parallel step runs at the speed of
  the slowest rank.  The driver keeps each step's wall time, from before
  ``dataset.batch(step)`` to after ``float(metrics["loss"])`` (which
  waits for the device); a step slower than ``straggler_factor`` times
  the median of the last ``straggler_window`` steps (once 5 are in) is a
  straggler event: logged and counted.

The state lives on ``mesh`` (a ``DeviceMesh``, each leaf a DTensor on
``param_shardings(state_spec(...))``) or, with ``mesh=None``, whole on
``device`` (the card unless the caller asks for the CPU).  On a mesh the
step runs under the driver's ``use_mesh_context`` and computes tensor
parallel on each rank's parameter blocks (``train/steps.py``
``make_sharded_train_step``).  The step consumes its state, as the
reference's jitted step donates it.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..ckpt import CheckpointManager
from ..configs.base import ArchDef
from ..convert import batch_from_numpy
from ..data.pipeline import shard_batch
from ..dist.sharding import (
    ShardingProfile,
    param_shardings,
    use_mesh_context,
)
from ..models.common import tree_leaves, tree_map
from ..optim import AdamWConfig
from ..optim.schedule import Schedule
from .steps import init_state, make_train_step, state_spec


class InjectedFailure(RuntimeError):
    """Raised by test hooks to simulate a process crash."""


@dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_interval: int = 50
    keep_last: int = 3
    log_interval: int = 10
    accum: int = 1
    straggler_factor: float = 3.0
    straggler_window: int = 20
    seed: int = 0
    multi_pod: bool = False


@dataclass
class StepEvent:
    step: int
    loss: float
    wall_s: float
    straggler: bool = False


class Trainer:
    """Checkpoint-restart training loop over an ArchDef.  After
    :meth:`run`, ``state`` holds the final state."""

    def __init__(self, arch: ArchDef, dataset, mesh, profile: ShardingProfile,
                 opt_cfg: AdamWConfig, schedule: Schedule,
                 cfg: TrainerConfig,
                 hooks: dict[int, Callable] | None = None, *,
                 device: str = "cuda"):
        self.arch = arch
        self.dataset = dataset
        self.mesh = mesh
        self.profile = profile
        self.opt_cfg = opt_cfg
        self.schedule = schedule
        self.cfg = cfg
        self.hooks = hooks or {}
        self.device = mesh.device_type if mesh is not None else device
        self.ckpt = CheckpointManager(cfg.ckpt_dir,
                                      interval=cfg.ckpt_interval,
                                      keep_last=cfg.keep_last)
        self.events: list[StepEvent] = []
        self.straggler_events: list[int] = []
        self.state = None
        self._spec = state_spec(arch, opt_cfg)

    # ------------------------------------------------------------------
    def _shardings(self):
        if self.mesh is None:
            return None
        return param_shardings(self._spec, self.mesh, self.profile)

    def _init_or_restore(self):
        shardings = self._shardings()
        step0, state, _ = self.ckpt.restore_latest(
            self._spec, device=self.device, shardings=shardings)
        if state is not None:
            return int(step0), state
        generator = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed)
        state = init_state(self.arch, generator, self.opt_cfg,
                           device=self.device)
        if shardings is not None:
            leaves = iter(tree_leaves(state))
            state = tree_map(lambda s: s.distribute(next(leaves)), shardings)
        return 0, state

    def _batch_axes(self):
        return ("pod", "data") if self.cfg.multi_pod else ("data",)

    def _place(self, batch: dict) -> dict:
        if self.mesh is None:
            return batch_from_numpy(batch, device=self.device)
        return shard_batch(batch, self.mesh, self._batch_axes())

    # ------------------------------------------------------------------
    def run(self) -> dict:
        cfg = self.cfg
        with use_mesh_context(self.mesh, self.profile,
                              multi_pod=cfg.multi_pod):
            start, state = self._init_or_restore()
            step_fn = make_train_step(self.arch, self.opt_cfg, self.schedule,
                                      accum=cfg.accum, mesh=self.mesh,
                                      shardings=self._shardings(),
                                      batch_axes=self._batch_axes())
            window: list[float] = []
            losses = []
            for step in range(start, cfg.total_steps):
                if step in self.hooks:
                    self.hooks[step](self, step, state)
                t0 = time.perf_counter()   # data time counts: a slow host
                batch = self.dataset.batch(step)   # stalls the sync step
                state, metrics = step_fn(state, self._place(batch))
                loss = float(metrics["loss"])
                wall = time.perf_counter() - t0
                straggler = False
                if len(window) >= 5:
                    med = statistics.median(window[-cfg.straggler_window:])
                    if wall > cfg.straggler_factor * med:
                        straggler = True
                        self.straggler_events.append(step)
                window.append(wall)
                losses.append(loss)
                self.events.append(StepEvent(step, loss, wall, straggler))
                self.ckpt.maybe_save(step + 1, state,
                                     metadata={"loss": loss})
        self.state = state
        return {
            "final_step": cfg.total_steps,
            "final_loss": losses[-1] if losses else float("nan"),
            "losses": losses,
            "stragglers": self.straggler_events,
        }
