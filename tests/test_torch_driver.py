"""The port's fault-tolerant driver (``repro_torch/train/driver.py``):
the reference's tests/test_driver.py restated on the port, with
``mesh=None`` and with a one-rank host mesh (gloo, in this process),
internlm2-1.8b's smoke config on the CPU:

* a crash injected at step 12, then a fresh ``Trainer`` resumes from
  checkpoint 10 and ends bit-equal to an uninterrupted run (every state
  leaf and the losses; the reference asks rel 1e-5 of the final loss);
* an injected sleep at step 10 (1.2 s before the step's timer, 1.0 s
  inside it, as the reference's test, or 6 times the median step where
  a loaded machine makes steps slower than 0.2 s) is flagged as a
  straggler;
* the mean of the last 5 losses falls below the first 5's over 30
  steps (at lr 3e-3: at the reference's 1e-2 this smoke model does not
  descend, see the test);
* the one-rank mesh's run equals ``mesh=None``'s bit for bit.

The reference's own ``Trainer`` fails these (ROADMAP §3 item 4), so each
of the driver's steps is held against the reference's jitted
``make_train_step`` without a mesh instead, from the same state on the
same batch, as tests/test_torch_train_lm.py holds one step.
"""
import statistics
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data import ArchSyntheticDataset  # noqa: E402
from repro_torch.dist import get_profile  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import AdamWConfig, constant  # noqa: E402
from repro_torch.train import InjectedFailure, Trainer, TrainerConfig  # noqa: E402

NAME = "internlm2-1.8b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke steps are tiny: one intra-op thread keeps them from
    oversubscribing a machine that runs other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model=1, device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(params=["none", "host"])
def mesh(request):
    return None if request.param == "none" else request.getfixturevalue(
        "host_mesh")


def _mk(tmp_path, total_steps, mesh, hooks=None, interval=5, lr=1e-3,
        arch=None):
    arch = arch or get_arch(NAME, smoke=True)
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    data = ArchSyntheticDataset(arch, shape, seed=3)
    cfg = TrainerConfig(total_steps=total_steps, ckpt_dir=str(tmp_path),
                        ckpt_interval=interval, straggler_factor=5.0)
    return Trainer(arch, data, mesh, get_profile(arch.profile), AdamWConfig(),
                   constant(lr), cfg, hooks=hooks, device="cpu")


def _whole(state) -> list:
    from torch.distributed.tensor import DTensor

    return [x.full_tensor() if isinstance(x, DTensor) else x
            for x in tree_leaves(state)]


def test_checkpoint_restart_bit_identical(tmp_path, mesh):
    """Crash at step 12, restart, the final state equals an
    uninterrupted run's bit for bit."""
    ref = _mk(tmp_path / "ref", 20, mesh)
    ref_out = ref.run()

    def crash(trainer, step, state):
        raise InjectedFailure(f"injected at {step}")

    broken = _mk(tmp_path / "ft", 20, mesh, hooks={12: crash})
    with pytest.raises(InjectedFailure):
        broken.run()
    resumed = _mk(tmp_path / "ft", 20, mesh)
    out = resumed.run()
    assert len(out["losses"]) == 10                 # resumed from step 10
    assert [e.step for e in resumed.events] == list(range(10, 20))
    assert out["losses"] == ref_out["losses"][10:]
    assert out["final_loss"] == ref_out["final_loss"]
    for a, b in zip(_whole(resumed.state), _whole(ref.state), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_straggler_detection(tmp_path, mesh):
    def slow(trainer, step, state):
        time.sleep(1.2)

    t = _mk(tmp_path, 14, mesh, hooks={10: slow})
    # the hook sleeps before the step's timer; the batch's sleep counts:
    # the reference's 1.0 s, or 6 times the median step so far where a
    # loaded machine makes a step slower than 0.2 s (the rule's factor is
    # 5)
    orig_batch = t.dataset.batch

    def batch_with_sleep(step):
        if step == 10:
            time.sleep(max(1.0, 6 * statistics.median(
                e.wall_s for e in t.events)))
        return orig_batch(step)

    t.dataset.batch = batch_with_sleep
    out = t.run()
    assert 10 in out["stragglers"], (out["stragglers"],
                                     [e.wall_s for e in t.events])
    assert [e.step for e in t.events if e.straggler] == out["stragglers"]


def test_loss_decreases_over_run(tmp_path, mesh):
    """The reference's window means over 30 fresh batches, at lr 3e-3:
    at its 1e-2 this smoke model does not descend (first five 6.62, last
    five 6.61-6.63 with the intra-op thread count: the batches' noise,
    sigma ~0.15, is the trend), and neither does the reference's own
    jitted step from its own init; at 3e-3 both fall
    (:func:`test_reference_step_descends_at_the_same_lr`)."""
    t = _mk(tmp_path, 30, mesh, lr=3e-3)
    out = t.run()
    first = sum(out["losses"][:5]) / 5
    last = sum(out["losses"][-5:]) / 5
    assert last < first, (first, last, out["losses"])


def test_host_mesh_equals_one_device_bit_for_bit(tmp_path, host_mesh):
    runs = []
    for mesh in (None, host_mesh):
        t = _mk(tmp_path / str(mesh is None), 6, mesh, interval=4)
        runs.append((t.run()["losses"], _whole(t.state)))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1], strict=True):
        assert torch.equal(a, b)


def test_driver_steps_match_reference_jitted(tmp_path):
    """Each of two driver steps (f32, remat full, chunked attention)
    against the reference's jitted ``make_train_step`` from the state the
    driver held before it, on the batch the driver drew."""
    from _torch_train import archs, reference_step, step_close

    rarch, parch = archs(NAME)
    before = []

    def keep(trainer, step, state):
        before.append(tree_map(lambda t: t.numpy().copy(), state))

    t = _mk(tmp_path, 2, None, hooks={0: keep, 1: keep}, arch=parch)
    out = t.run()
    after = [tree_map(torch.from_numpy, before[1]), t.state]
    for k in range(2):
        batch = t.dataset.batch(k)
        want, metrics = reference_step(rarch, before[k], batch)
        got = after[k]
        bad, masked = step_close(got["params"], want["params"],
                                 got["opt_state"]["mu"],
                                 want["opt_state"]["mu"])
        assert not bad, (k, bad, masked)
        np.testing.assert_allclose(out["losses"][k], float(metrics["loss"]),
                                   rtol=1e-5)
        assert int(got["step"]) == int(want["step"]) == k + 1


def test_reference_step_descends_at_the_same_lr(tmp_path):
    """The reference's jitted ``make_train_step`` from its own init
    (``jax.random.key(0)``) on the same 30 batches at lr 3e-3: its last
    five losses' mean below its first five's too."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_arch
    from repro.optim import AdamWConfig as RefAdamW
    from repro.optim.schedule import constant as ref_constant
    from repro.train.steps import init_state, make_train_step

    arch = ref_arch(NAME, smoke=True)
    data = _mk(tmp_path, 30, None).dataset
    state = init_state(arch, jax.random.key(0), RefAdamW())
    step = jax.jit(make_train_step(arch, RefAdamW(), ref_constant(3e-3)))
    losses = []
    for i in range(30):
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in data.batch(i).items()})
        losses.append(float(metrics["loss"]))
    assert sum(losses[-5:]) < sum(losses[:5]), losses
