"""The port's gradients and train step (``repro_torch/train/steps.py``)
against the reference's on the seven decoder-LM smoke archs (dense, MoE,
multimodal): a state of the reference's layout drawn in numpy (the
attention projections at their contracted fan-in) and carried across,
the same numpy batch, f32, the port with ``remat="full"`` and chunked attention
(chunk 8: every layer and KV tile checkpointed), the reference at its
smoke settings.  The loss within 1e-5; each gradient leaf within 2e-3 of
its largest |g| against ``jax.value_and_grad(arch.loss)``; after one
``make_train_step`` step each parameter within 1e-3 * lr of the
reference's update on its own gradients (``adamw_update`` and
``apply_updates`` jitted, as its train step runs them) where the two
first moments agree within 1e-4 (tests/_torch_train.py says why; the
gradients are held leaf by leaf above), the moments within 2e-3 of
their largest, the grad norm within 1e-4.  The reference's whole jitted
``make_train_step`` is held in tests/test_torch_train.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_train import (  # noqa: E402
    GRAD_RTOL, SMOKE_TRAIN, archs, grads_close, port_inputs, ref_state,
    reference_grads, reference_update, step_close)
from repro_torch.models import lm  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.steps import make_train_step, value_and_grad  # noqa: E402

LM_ARCHS = tuple(n for n in ARCH_NAMES
                 if isinstance(get_arch(n, smoke=True).cfg, lm.LMConfig))


def check_against_reference(name: str, seed: int):
    rarch, parch = archs(name)
    state = ref_state(rarch)
    batch = parch.make_batch(SMOKE_TRAIN, seed=seed)
    loss, grads = reference_grads(rarch, state["params"], batch)
    new_params, new_opt, metrics = reference_update(state, grads)
    pstate, pbatch = port_inputs(state, batch)
    ploss, _, pgrads = value_and_grad(parch, pstate["params"], pbatch)
    np.testing.assert_allclose(float(ploss), loss, rtol=1e-5)
    assert not grads_close(pgrads, grads)
    pstate, pmetrics = make_train_step(parch, AdamWConfig())(pstate, pbatch)
    bad, masked = step_close(pstate["params"], new_params,
                             pstate["opt_state"]["mu"], new_opt["mu"])
    assert not bad, (bad, masked)
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(pstate["opt_state"][key]),
                        jax.tree.leaves(new_opt[key])):
            assert float(np.abs(a.numpy() - b).max()) <= GRAD_RTOL * max(
                float(np.abs(b).max()), 1e-30)
    assert int(pstate["opt_state"]["count"]) == 1 and int(pstate["step"]) == 1
    np.testing.assert_allclose(float(pmetrics["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(pmetrics["loss"]), loss, rtol=1e-5)
    assert float(pmetrics["lr"]) == float(metrics["lr"])


@pytest.mark.parametrize("name", LM_ARCHS)
def test_grads_and_step_match_reference(name):
    check_against_reference(name, seed=LM_ARCHS.index(name))
