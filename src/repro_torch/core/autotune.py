"""Rank the tilings of the compute-bound kernels by the GPU model, and the
meshes of a model config.

The port's copy of the two compute objectives of the reference's
``repro/core/autotune.py`` ``rank`` (``objective="matmul"`` and
``"attention"``) and of its mesh axis (``mesh=``, ``core/mesh.py``
``rank_meshes``).  Candidates are the tilings the CUDA kernels are
compiled for (``kernels/matmul/kernel.py`` ``TILINGS`` of the operands'
route, and ``kernels/attention/kernel.py`` ``TILINGS``) that the kernel
takes for the problem, so nothing it would refuse is offered: matmul
tilings and attention's one-row (split-route) tilings that divide it, and
every attention prefill tiling, whose kernel masks the ragged edge; the
reference's enumeration of power-of-two divisors has no counterpart.  On this card a
tile lives in shared memory and registers, not in the reference's largest
cache level (``max(capacities)``), so a tiling whose shared memory
exceeds the card's ``smem_per_block_optin`` is no candidate at all, where
the reference ranks a tile that overflows its reuse level last.

Tilings are ranked by the ``t_ecm`` of their ``StepECM``
(``core/gpu_ecm.py``; an attention tile is modelled at its blocks clamped
to the sequence lengths, as the op clamps them), then at equal
predictions by the scores a ragged attention tiling computes and masks
(``ceil(sq / bq) bq x ceil(skv / bkv) bkv``: the one-row tiling first for
a single query row), then by the reference's tie-break: the largest
output tile first (fewer grid steps and less re-streaming than the
light-speed model charges for), and among equal tiles the order of the
kernel's ``TILINGS``.
"""
from __future__ import annotations

import torch

from .gpu_ecm import gpu_attention_ecm, gpu_matmul_ecm
from .workload import AttentionWorkload, MatmulWorkload

#: the matmul operand dtype of an element size (the kernel's routes)
_MATMUL_DTYPES = {4: torch.float32, 2: torch.bfloat16}


def matmul_block_candidates(m: int, n: int, k: int, machine, *,
                            elem_bytes: int) -> list[tuple[int, int, int]]:
    """The compiled ``(bm, bn, bk)`` of the route of ``elem_bytes``-byte
    operands (4: f32 on FFMA, 2: bf16 on wgmma) that divide ``(m, n, k)``
    and whose ring fits the card's shared memory."""
    from ..kernels.matmul import kernel as K

    dtype = _MATMUL_DTYPES[elem_bytes]
    return [t for t in K.TILINGS[K.route_of(dtype)]
            if m % t[0] == 0 and n % t[1] == 0 and k % t[2] == 0
            and K.smem_bytes(*t, dtype) <= machine.smem_per_block_optin]


def attention_block_candidates(sq: int, skv: int, d: int, machine
                               ) -> list[tuple[int, int]]:
    """The compiled ``(bq, bkv)`` at the compiled head dim that runs ``d``
    (``d`` itself, or the one the op pads it to) whose buffers fit the
    card's shared memory: every prefill tiling (the kernel masks the ragged
    edge), the one-row tilings only where they divide ``skv``."""
    from ..kernels.attention import kernel as K

    d = K.PADDED_HEAD_DIMS.get(d, d)
    if d not in K.HEAD_DIMS:
        return []
    return [t for t in K.TILINGS
            if (t[0] > 1 or skv % t[1] == 0)
            and K.smem_bytes(*t, d) <= machine.smem_per_block_optin]


def rank(dims, machine=None, *, objective: str | None = None,
         causal: bool = True, elem_bytes: int = 4, mesh=None, **mesh_opts
         ) -> list[dict]:
    """Rank the candidate tilings of ``dims`` on the card ``machine`` (a
    ``GPUMachineModel``), best first; or, with ``mesh``, the meshes of a
    model config.

    ``rank(config, machine, mesh=n)``: the joint ``(mesh shape, sharding
    profile)`` ranking of ``config`` (an arch name, an ``ArchDef`` or a
    raw config) at ``n`` cards, ``core/mesh.py`` ``rank_meshes``'s rows
    (``machine`` defaults to ``H100_SXM``).  ``mesh`` may also be a dict
    of ``rank_meshes``'s options with ``n_chips`` among them (default
    256, the reference's); further keywords pass through.  Those keywords
    without ``mesh`` raise ``TypeError``.

    ``objective="matmul"``: ``dims`` is ``(m, n, k)``, blocks
    ``(bm, bn, bk)``.  ``objective="attention"``: ``dims`` is
    ``(sq, skv, d)`` of one head (heads multiply every candidate's time
    alike), blocks ``(bq, bkv)``, ``causal`` as the kernel's.
    ``elem_bytes`` is the element size of the operands.  Returns dicts
    ``{"block", "t_ecm" (seconds), "smem_bytes"}``; raises ``ValueError``
    when no compiled tiling fits.
    """
    if mesh is not None:
        from .machine import H100_SXM
        from .mesh import rank_meshes

        opts = dict(mesh) if hasattr(mesh, "keys") else {"n_chips": mesh}
        n = int(opts.pop("n_chips", 256))
        return rank_meshes(dims, n, machine or H100_SXM,
                           **opts | mesh_opts)
    if mesh_opts:
        raise TypeError(f"unexpected keyword arguments without mesh=: "
                        f"{sorted(mesh_opts)}")
    if objective == "matmul":
        from ..kernels.matmul.kernel import smem_bytes

        m, n, k = dims
        cands = matmul_block_candidates(m, n, k, machine, elem_bytes=elem_bytes)
        steps = [gpu_matmul_ecm(MatmulWorkload(m, n, k, bm, bn, elem_bytes),
                                machine) for bm, bn, _ in cands]
        smem = [smem_bytes(*b, _MATMUL_DTYPES[elem_bytes]) for b in cands]
        computed = [0] * len(cands)  # every matmul candidate divides
    elif objective == "attention":
        from ..kernels.attention import kernel as K
        from ..kernels.attention.kernel import smem_bytes

        sq, skv, d = dims
        cands = attention_block_candidates(sq, skv, d, machine)
        steps = [gpu_attention_ecm(
            AttentionWorkload(sq, skv, d, min(bq, sq), min(bkv, skv), causal,
                              elem_bytes),
            machine, batch_heads=1) for bq, bkv in cands]
        smem = [smem_bytes(*b, K.PADDED_HEAD_DIMS.get(d, d)) for b in cands]
        computed = [-(-sq // bq) * bq * -(-skv // bkv) * bkv for bq, bkv in cands]
    else:
        raise ValueError(f"objective must be 'matmul' or 'attention', got "
                         f"{objective!r}")
    if not cands:
        raise ValueError(f"no compiled {objective} tiling fits {tuple(dims)}")
    order = sorted(range(len(cands)),
                   key=lambda i: (steps[i].t_ecm, computed[i],
                                  -cands[i][0] * cands[i][1]))
    return [{"block": cands[i], "t_ecm": steps[i].t_ecm,
             "smem_bytes": smem[i]} for i in order]
