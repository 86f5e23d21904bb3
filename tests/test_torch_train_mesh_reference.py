"""The port's tensor- and data-parallel train step against the
reference's sharded train step: internlm2-1.8b (smoke, f32) on a
``(2, 2)`` ``("data", "model")`` mesh under ``tp_dp``, one step from the
same state on the same batch (tests/_torch_train_mesh.py's masked rows,
so the ranks' token counts differ).

* the reference: its ``make_train_step`` and ``jax.value_and_grad`` of
  its loss, jitted with GSPMD shardings on four fake host devices in a
  subprocess (``_torch_train_mesh.reference_step``);
* the port: ``make_train_step(..., mesh=)`` on four spawned gloo ranks
  (``_torch_train_mesh.run_cases``), the gradients as the step hands
  them to the optimizer, gathered whole.

The state is tests/_torch_train.py's ``ref_state`` (the attention
projections at their contracted fan-in), carried across in an ``.npz``.
The gates are tests/test_torch_train_lm.py's: the loss within 1e-5, each
gradient leaf within 2e-3 of its largest, after the step each parameter
within 1e-3 * lr and an ulp where the two first moments agree within
1e-4, the moments within 2e-3 of their largest, the grad norm within
1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from _torch_dist import spawn  # noqa: E402
from _torch_serve_mesh import finish, flat, unflat  # noqa: E402
from _torch_train import GRAD_RTOL, archs, ref_state, step_close  # noqa: E402
from _torch_train_mesh import (WORLD, batch_of,  # noqa: E402
                               run_cases, start_reference_step)
from repro_torch.models.common import tree_leaves  # noqa: E402

NAME = "internlm2-1.8b"
#: name -> (arch, moments, profile, mesh shape, multi-pod, accum)
CASES = {"internlm2-tp": (NAME, "f32", "tp_dp", (2, 2), False, 1)}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh_reference")
    rarch, parch = archs(NAME)
    state_path, batch_path = out / "state.npz", out / "batch.npz"
    np.savez(state_path, **flat(ref_state(rarch)))
    np.savez(batch_path, **batch_of(parch, 0))
    ref = start_reference_step([NAME, [2, 2], "tp_dp", str(state_path),
                                str(batch_path), str(out / "ref.npz")],
                               timeout=300)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spawn(run_cases, WORLD, out, str(out), CASES, str(state_path),
              timeout=300)
    finally:
        torch.set_num_threads(threads)
    finish(ref)
    arrays = dict(np.load(out / "ref.npz"))
    want = {pre: unflat({k[len(pre) + 1:]: v for k, v in arrays.items()
                         if k.startswith(pre + "/")})
            for pre in ("grad", "state", "metric")}
    return torch.load(out / "internlm2-tp-rank0.pt", weights_only=False), \
        float(arrays["loss"]), want


def test_grads_and_step_match_the_reference_sharded_step(sides):
    got, loss, want = sides
    metrics, state, grads = got["metrics"][0], got["states"][0], got["grads"][0]
    np.testing.assert_allclose(metrics["loss"], loss, rtol=1e-5)
    for i, (a, b) in enumerate(zip(grads, jax.tree.leaves(want["grad"]),
                                   strict=True)):
        err = float(np.abs(a.numpy() - b).max())
        assert err <= GRAD_RTOL * max(float(np.abs(b).max()), 1e-30), (i, err)
    bad, masked = step_close(state["params"], want["state"]["params"],
                             state["opt_state"]["mu"],
                             want["state"]["opt_state"]["mu"])
    assert not bad, (bad, masked)
    for key in ("mu", "nu"):
        for a, b in zip(tree_leaves(state["opt_state"][key]),
                        jax.tree.leaves(want["state"]["opt_state"][key]),
                        strict=True):
            assert float(np.abs(a.numpy() - b).max()) <= GRAD_RTOL * max(
                float(np.abs(b).max()), 1e-30)
    assert int(state["opt_state"]["count"]) == 1 and int(state["step"]) == 1
    np.testing.assert_allclose(metrics["grad_norm"],
                               float(want["metric"]["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(metrics["loss"], float(want["metric"]["loss"]),
                               rtol=1e-5)
    assert metrics["lr"] == float(want["metric"]["lr"])
