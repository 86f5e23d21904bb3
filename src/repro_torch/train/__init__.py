"""Training (the reference's ``repro/train``): the train state, the
eager train step on autograd (on one device, or data parallel on a
``DeviceMesh``), the prefill, serve and eval steps, the fault-tolerant
driver and the elastic re-mesh."""
from .driver import InjectedFailure, StepEvent, Trainer, TrainerConfig
from .elastic import remesh_state, shrink_mesh
from .steps import (
    init_state,
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_sharded_train_step,
    make_train_step,
    state_spec,
)

__all__ = [
    "InjectedFailure",
    "StepEvent",
    "Trainer",
    "TrainerConfig",
    "init_state",
    "make_eval_step",
    "make_prefill_step",
    "make_serve_step",
    "make_sharded_train_step",
    "make_train_step",
    "remesh_state",
    "shrink_mesh",
    "state_spec",
]
