"""The port's copy of the analytic ECM model it needs: :mod:`.ecm` (Eq. 1
and the paper's notation), :mod:`.kernel_spec` (the Table I stream
counts), :mod:`.layer_condition` (the stencils' reuse conditions),
:mod:`.machine` (the GPU machine constants) and :mod:`.gpu_ecm` (overlap
calibration, the two-term step model and the stencil sweep's model)."""
