"""Training and serving steps (the reference's ``repro/train``): the
train state, the eager train step on autograd and the prefill, serve and
eval steps.  The reference's fault-tolerant driver and elastic re-mesh
(``driver.py``, ``elastic.py``) need the port's mesh and wait for
ROADMAP §1 item 5."""
from .steps import (
    init_state,
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    state_spec,
)

__all__ = [
    "init_state",
    "make_eval_step",
    "make_prefill_step",
    "make_serve_step",
    "make_train_step",
    "state_spec",
]
