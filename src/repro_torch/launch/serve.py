"""Serving launcher: batched prefill + decode with a KV or state cache,
or the continuous-batching engine over a synthetic trace (the
reference's ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch internlm2-1.8b --batch 4 \\
        --prompt-len 16 --gen 8 [--no-smoke] [--device cuda]

materializes the arch's parameters from ``--seed`` on the device, casts
them once to the compute dtype (:func:`~repro_torch.models.common.cast_params`:
the same bits as the reference's cast at every use), runs prefill on the
reference's synthetic prompt batch (every array ``ArchDef.make_batch``
draws: the tokens, pixtral's patch embeddings, whisper's frames) and decodes
``--gen`` tokens greedily (argmax over the unpadded vocabulary), then
prints the reference's JSON: ``arch``, ``prefill_s``, ``decode_s_per_tok``
and ``tokens``.  It runs on the card unless ``--device cpu`` is passed.
``--smoke`` (the default, as in the reference) takes the arch's reduced
config, ``--no-smoke`` its full one.  An encoder-only arch
(``has_decoder`` false) is skipped, as the reference skips it.

Every arch with a decoder is served on a mesh, as the reference serves
it: ``--mesh host`` is ``make_host_mesh(model=1)`` over the ranks of the
process group (one process: a one-rank group of its own, NCCL on the
card, gloo on the CPU, started and stopped here), ``single-pod`` and
``multi-pod`` the ``(16, 16)`` and ``(2, 16, 16)`` production meshes,
which raise on a world that is not 256 or 512 ranks.  The parameters are
placed by ``param_shardings(..., ensure_model_axis=True)`` under the
arch's profile, the prompt and the cache by the input profile, and the
steps run tensor parallel under ``use_mesh_context`` (:func:`serve` with
``mesh``); rank 0 prints the JSON.

    python -m repro_torch.launch.serve --continuous [--requests 64] \\
        [--faults none|device_loss|slow_step|kv_corruption] [--device cuda]

runs the model-guided continuous-batching engine (``repro_torch.serve``)
over a synthetic trace of ``--requests`` requests drawn from ``--seed``:
requests arrive, are admitted against their ECM-predicted finish times,
and the summary JSON reports throughput and latency on the engine's
virtual clock plus the event counts; it exits 1 when a request is lost.
The buckets rank on the card's model (``GPUMachineModel.from_device``),
or on the data sheet's H100 SXM (``H100_SXM``) with ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..configs import get_arch
from ..configs.base import ArchDef, ShapeSpec
from ..dist.sharding import (get_profile, input_profile, kv_divisible,
                             param_shardings, serving_profile,
                             use_mesh_context)
from ..models.common import cast_params, materialize, tree_leaves, tree_map
from ..train.steps import make_prefill_step, make_serve_step
from .mesh import make_host_mesh, make_production_mesh


@dataclass
class Served:
    """One static serve: the times (s), the tokens the decode steps chose
    ``(B, gen)``, the tokens fed to them ``(B, gen)`` (the first is the
    prefill's choice), the prefill's last-position logits and each decode
    step's logits (``(B, 1, vocab_padded)``), and the final cache."""

    prefill_s: float
    decode_s: float
    tokens: torch.Tensor
    fed: torch.Tensor
    prefill_logits: torch.Tensor
    step_logits: list
    cache: dict

    def report(self, arch: str) -> dict:
        """The reference launcher's JSON.  ``--gen 0`` is a prefill-only
        run: no decode steps happened, so a per-token decode time does not
        exist (it is null, not 0/0)."""
        gen = self.tokens.shape[1]
        return {
            "arch": arch,
            "prefill_s": round(self.prefill_s, 4),
            "decode_s_per_tok": round(self.decode_s / gen, 4) if gen else None,
            "tokens": self.tokens.tolist() if gen else [],
        }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _on_mesh(arch: ArchDef, params, prompt: dict, mesh, multi_pod: bool,
             max_len: int):
    """The prefill and decode of :func:`serve` on ``mesh``: the parameters
    placed by the arch's profile (``ensure_model_axis``), the prompt by
    the input profile; returns ``run_prefill()`` and ``run_decode(cache,
    tok)`` (``tok`` the whole batch's tokens), each under its serving
    profile."""
    profile = get_profile(arch.profile, multi_pod=multi_pod)
    kv_div = kv_divisible(arch.cfg, mesh)
    in_prof = input_profile(multi_pod=multi_pod, kv_divisible=kv_div,
                            batch_axes=profile.activation_rules.get("batch"))
    psh = param_shardings(arch.param_spec(), mesh, profile,
                          ensure_model_axis=True)
    placed = iter([sh.distribute(t) for t, sh in
                   zip(tree_leaves(params), tree_leaves(psh))])
    params = tree_map(lambda _: next(placed), params)
    shape = ShapeSpec("cli_prefill", seq_len=prompt["tokens"].shape[1],
                      global_batch=prompt["tokens"].shape[0], kind="prefill")
    bsh = param_shardings(arch.batch_spec(shape), mesh, in_prof)
    prompt = {k: bsh[k].distribute(v) for k, v in prompt.items()}
    rows = bsh["tokens"].index(mesh.get_coordinate(),
                               prompt["tokens"].shape)[0]
    prefill = make_prefill_step(arch, max_len=max_len, cache_profile=in_prof)
    step = make_serve_step(arch)

    def run_prefill():
        with use_mesh_context(mesh, serving_profile(profile, "prefill",
                                                    kv_divisible=kv_div),
                              multi_pod=multi_pod):
            return prefill(params, prompt)

    def run_decode(cache, tok):
        with use_mesh_context(mesh, serving_profile(profile, "decode",
                                                    kv_divisible=kv_div),
                              multi_pod=multi_pod,
                              cache_seq_axis=None if kv_div else "model"):
            return step(params, cache, {"tokens": tok[rows]})
    return run_prefill, run_decode


def serve(arch: ArchDef, params, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, mesh=None, multi_pod: bool = False) -> Served:
    """Prefill a ``batch x prompt_len`` prompt of ``arch.make_batch`` drawn
    from ``seed`` (every array it draws), then ``gen`` greedy decode steps,
    on the device the parameters lie on, with a cache of ``prompt_len +
    gen + 8`` positions (the reference's).  The times run from a device
    sync to a device sync.  On ``mesh`` (``params`` whole, the same on
    every rank): each rank keeps its blocks of the parameters
    and serves tensor parallel, the logits and tokens of the whole batch
    on every rank, the cache as DTensors."""
    device = tree_leaves(params)[0].device
    vocab = arch.cfg.vocab
    shape = ShapeSpec("cli_prefill", seq_len=prompt_len, global_batch=batch,
                      kind="prefill")
    prompt = {k: torch.from_numpy(v).to(device)
              for k, v in arch.make_batch(shape, seed=seed).items()}
    max_len = prompt_len + gen + 8
    if mesh is None:
        def run_prefill():
            return arch.prefill(params, prompt, max_len=max_len)

        def run_decode(cache, tok):
            return arch.decode(params, cache, {"tokens": tok})
    else:
        run_prefill, run_decode = _on_mesh(arch, params, prompt, mesh,
                                           multi_pod, max_len)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = run_prefill()
    _sync(device)
    prefill_s = time.perf_counter() - t0

    prefill_logits, fed, toks, steps = logits, [], [], []
    tok = logits[:, -1, :vocab].argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(gen):
        fed.append(tok)
        logits, cache = run_decode(cache, tok)
        steps.append(logits)
        tok = logits[:, -1, :vocab].argmax(-1)[:, None]
        toks.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    empty = torch.zeros((batch, 0), dtype=torch.long, device=device)
    return Served(prefill_s, decode_s,
                  torch.cat(toks, 1).cpu() if toks else empty.cpu(),
                  torch.cat(fed, 1) if fed else empty,
                  prefill_logits, steps, cache)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--mesh", default="host",
                    choices=("host", "single-pod", "multi-pod"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="run the ECM-guided continuous-batching engine "
                         "over a synthetic trace (repro_torch.serve)")
    ap.add_argument("--requests", type=int, default=64,
                    help="trace length for --continuous")
    ap.add_argument("--faults", default="none",
                    help="fault plan for --continuous "
                         "(none/device_loss/slow_step/kv_corruption)")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: cuda)")
    return ap


def _continuous(args) -> int:
    """Trace-driven engine mode on a virtual clock; the buckets rank on
    the card's model, or the data sheet's with ``--device cpu``."""
    from ..core.machine import H100_SXM, GPUMachineModel
    from ..serve import (EngineConfig, FaultInjector, ServeEngine,
                         TraceConfig, fault_plan, synthetic_trace)

    device = _device(args.device)
    machine = (H100_SXM if device.type == "cpu"
               else GPUMachineModel.from_device(device))
    engine = ServeEngine(EngineConfig(machine=machine, seed=args.seed))
    trace = synthetic_trace(
        TraceConfig(n_requests=args.requests), seed=args.seed)
    summary = engine.run(trace, FaultInjector(fault_plan(args.faults)))
    print(json.dumps(summary, indent=1, default=str))
    return 0 if summary["lost"] == 0 else 1


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to serve on "
                           "the CPU")
    return device


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.continuous:
        return _continuous(args)
    try:
        arch = get_arch(args.arch, smoke=args.smoke)
    except KeyError as e:
        ap.error(str(e))
    if not arch.has_decoder:
        print(f"{arch.name}: encoder-only, nothing to serve")
        return 0
    device = _device(args.device)
    multi_pod = args.mesh == "multi-pod"
    started = not dist.is_initialized()
    try:
        mesh = (make_host_mesh(model=1, device=device.type)
                if args.mesh == "host" else
                make_production_mesh(multi_pod=multi_pod, device=device.type))
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = cast_params(materialize(arch.param_spec(), gen,
                                         device=device), arch.cfg.dtype)
        served = serve(arch, params, batch=args.batch,
                       prompt_len=args.prompt_len, gen=args.gen,
                       seed=args.seed, mesh=mesh, multi_pod=multi_pod)
        rank = dist.get_rank()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(served.report(arch.name), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
