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

    python -m repro_torch.launch.serve --continuous [--requests 64] \\
        [--faults none|device_loss|slow_step|kv_corruption] [--device cuda]

runs the model-guided continuous-batching engine (``repro_torch.serve``)
over a synthetic trace of ``--requests`` requests drawn from ``--seed``:
requests arrive, are admitted against their ECM-predicted finish times,
and the summary JSON reports throughput and latency on the engine's
virtual clock plus the event counts; it exits 1 when a request is lost.
The buckets rank on the card's model (``GPUMachineModel.from_device``),
or on the data sheet's H100 SXM (``H100_SXM``) with ``--device cpu``.
A ``--mesh`` other than ``host`` (serving on a mesh, ROADMAP §1 item 5c)
is not ported and raises.
"""
from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass

import torch

from ..configs import get_arch
from ..configs.base import ArchDef, ShapeSpec
from ..models.common import cast_params, materialize, tree_leaves


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


def serve(arch: ArchDef, params, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0) -> Served:
    """Prefill a ``batch x prompt_len`` prompt of ``arch.make_batch`` drawn
    from ``seed`` (every array it draws), then ``gen`` greedy decode steps,
    on the device the parameters lie on, with a cache of ``prompt_len +
    gen + 8`` positions (the reference's).  The times run from a device
    sync to a device sync."""
    device = tree_leaves(params)[0].device
    vocab = arch.cfg.vocab
    shape = ShapeSpec("cli_prefill", seq_len=prompt_len, global_batch=batch,
                      kind="prefill")
    prompt = {k: torch.from_numpy(v).to(device)
              for k, v in arch.make_batch(shape, seed=seed).items()}
    max_len = prompt_len + gen + 8

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = arch.prefill(params, prompt, max_len=max_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    prefill_logits, fed, toks, steps = logits, [], [], []
    tok = logits[:, -1, :vocab].argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(gen):
        fed.append(tok)
        logits, cache = arch.decode(params, cache, {"tokens": tok})
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
    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: serving on a mesh is "
                                  f"not ported yet (ROADMAP §1 item 5c)")
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
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = cast_params(materialize(arch.param_spec(), gen, device=device),
                         arch.cfg.dtype)
    served = serve(arch, params, batch=args.batch, prompt_len=args.prompt_len,
                   gen=args.gen, seed=args.seed)
    print(json.dumps(served.report(arch.name), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
