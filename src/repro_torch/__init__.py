"""PyTorch/CUDA port of the ECM reproduction, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package stands beside it
and imports nothing of it (nor of JAX).  It holds its own copies of the
pieces of the analytic model it needs (:mod:`.core`), the paper's stream
kernels and the Jacobi stencils as hand-written CUDA C++ for ``sm_90a``
with a plain PyTorch version beside each (:mod:`.kernels`), the state
converters that carry the reference's inputs across (:mod:`.convert`),
and the stream-ECM and stencil loops on the card
(:mod:`.benchmarks.gpu_stream_ecm`, :mod:`.benchmarks.gpu_stencil_ecm`).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
CPU tensor a kernel wrapper computes its plain version, on a CUDA tensor
it launches the kernel or raises.
"""
