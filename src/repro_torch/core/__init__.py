"""The port's copy of the analytic ECM model it needs: :mod:`.ecm` (Eq. 1
and the paper's notation), :mod:`.kernel_spec` (the Table I stream
counts), :mod:`.layer_condition` (the stencils' reuse conditions),
:mod:`.machine` (the GPU machine constants) and :mod:`.gpu_ecm` (overlap
calibration, the two-term step model and the stencil sweep's model, and
the three-term model of a step on a mesh of cards).

The multi-card side: :mod:`.hlo` (the resources of a traced step),
:mod:`.mesh` (the parallelism model and the ranked meshes) and
:func:`gpu_dp_scaling` (Eq. 2 over cards, the reference's
``tpu_dp_scaling``)."""
from .scaling import gpu_dp_scaling

__all__ = ["gpu_dp_scaling"]
