"""The port's train step on the MoE family (granite-moe-1b-a400m,
qwen3-moe-235b-a22b; the other families are tests/test_torch_train.py
and test_torch_train_hybrid.py, the shared cases tests/_torch_train.py):
``remat`` full against none, the reference's oracles
``test_train_step_smoke`` and ``test_loss_decreases_smoke``
(tests/test_archs_smoke.py), and the MoE dispatches' gradients against
the dense dispatch's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_train import (  # noqa: E402
    check_loss_decreases_smoke, check_remat_gives_the_same_grads,
    check_train_step_smoke, family_archs, port_batch, port_state, variant)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train.steps import value_and_grad  # noqa: E402

ARCHS = family_archs("moe")
REMAT = {"granite-moe-1b-a400m": ("full",)}
_batch, _state = port_batch, port_state


@pytest.mark.parametrize("name", REMAT)
def test_remat_gives_the_same_grads(name):
    check_remat_gives_the_same_grads(name, REMAT[name])


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_smoke(name):
    check_train_step_smoke(name)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_decreases_smoke(name):
    check_loss_decreases_smoke(name)


@pytest.mark.parametrize("impl", ["scatter", "shard_map"])
def test_moe_dispatch_grads_match_dense(impl):
    """The MoE dispatches' in-place ops (``index_add_`` into a fresh
    buffer, the k rows added into zeros, the counts' ``scatter_add_``)
    carry gradients: at a capacity where nothing drops, the scatter and
    one-shard ``shard_map`` dispatches give the dense all-experts
    dispatch's gradients (f32, 1e-5 of each leaf's largest)."""
    base = get_arch("granite-moe-1b-a400m", smoke=True)
    moe = base.cfg.moe
    moe = dataclasses.replace(moe, capacity_factor=moe.n_experts / moe.top_k)
    archs = {i: variant(base, moe=dataclasses.replace(moe, impl=i))
             for i in ("ref", impl)}
    state = _state(archs["ref"], seed=9)
    batch = _batch(archs["ref"], seed=9)
    _, _, want = value_and_grad(archs["ref"], state["params"], batch)
    _, _, got = value_and_grad(archs[impl], state["params"], batch)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert float(got["layers"]["moe"]["router"].abs().max()) > 0
