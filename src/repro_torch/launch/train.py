"""Training launcher (the reference's ``repro/launch/train.py``):

    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 6 \\
        --batch 2 --seq 16 --ckpt-dir results/ckpt [--device cpu]

drives the arch end to end through the fault-tolerant driver
(``train.driver.Trainer``): the state sharded on a mesh, the
deterministic data pipeline, checkpoints every ``--ckpt-interval`` steps
under ``--ckpt-dir/<arch>`` (a later run resumes from the newest), then
prints the reference's JSON: ``arch``, ``steps``, ``first_loss``,
``final_loss``, ``stragglers``.  It runs on the card unless ``--device
cpu`` is passed, and raises without one.  ``--mesh host`` builds a mesh
over the ranks of the process group (one process: a one-rank group of
its own, NCCL on the card, gloo on the CPU; under ``torchrun``, its
ranks); ``single-pod`` and ``multi-pod`` need a world of 256 or 512 ranks
and raise on any other.  On the mesh the step is tensor parallel over
``model`` and data parallel over the batch axes (``train/steps.py``
``make_sharded_train_step``).  ``--smoke`` (the
default, as in the reference) takes the arch's reduced config,
``--no-smoke`` its full one.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, get_arch
from ..configs.base import ShapeSpec
from ..data.arch_data import ArchSyntheticDataset
from ..dist.sharding import get_profile
from ..optim import AdamWConfig
from ..optim.schedule import linear_warmup_cosine
from ..train.driver import Trainer, TrainerConfig
from .mesh import make_host_mesh, make_production_mesh


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_NAMES, default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (CPU scale); --no-smoke for full")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--mesh", default="host",
                    choices=("host", "single-pod", "multi-pod"))
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--moment-dtype", default="f32",
                    choices=("f32", "bf16", "int8"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the state and the steps run (default: cuda)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    arch = get_arch(args.arch, smoke=args.smoke)
    started = not dist.is_initialized()
    try:
        if args.mesh == "host":
            mesh = make_host_mesh(model=1, device=args.device)
            multi_pod = False
        else:
            multi_pod = args.mesh == "multi-pod"
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device=args.device)
        profile = get_profile(arch.profile, multi_pod=multi_pod)
        shape = ShapeSpec("cli_train", seq_len=args.seq,
                          global_batch=args.batch, kind="train")
        data = ArchSyntheticDataset(arch, shape, seed=args.seed)
        opt = AdamWConfig(moment_dtype=args.moment_dtype)
        sched = linear_warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
        trainer = Trainer(
            arch, data, mesh, profile, opt, sched,
            TrainerConfig(total_steps=args.steps,
                          ckpt_dir=os.path.join(args.ckpt_dir, arch.name),
                          ckpt_interval=args.ckpt_interval,
                          accum=args.accum, seed=args.seed,
                          multi_pod=multi_pod))
        out = trainer.run()
        rank = dist.get_rank()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if rank:
        return 0
    print(json.dumps({"arch": arch.name,
                      "steps": out["final_step"],
                      "first_loss": out["losses"][0],
                      "final_loss": out["final_loss"],
                      "stragglers": out["stragglers"]}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
