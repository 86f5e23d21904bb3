"""The tensor- and data-parallel train step on a mesh
(``train/steps.py`` ``make_sharded_train_step``: each rank computes on
its parameter blocks, each collective's backward its adjoint) against
the port's one-device step on the same global batch, at the smoke
configs (f32, ``remat="full"``, chunked attention at chunk 8) from the
state ``init_state`` draws, on four spawned gloo ranks
(tests/_torch_dist.py; one spawn for the module):

* internlm2-1.8b on a ``(2, 2)`` ``("data", "model")`` mesh over 3
  steps, with f32 moments under ``tp_dp``, bf16 and int8 under
  ``tp_fsdp`` (the embed axis over ``data``, so the gradients are
  reduce-scattered and the int8 row absmax is all-reduced where the
  last dim is sharded), int8 under ``tp_dp`` (the last dim over
  ``model``) and ``accum=2``; on the multi-pod ``(2, 1, 2)`` mesh over
  ``("pod", "data")``; and zamba2-1.2b (the hybrid family) on ``(2, 2)``;
* granite-moe-1b-a400m on a ``(1, 4)`` mesh under ``moe_ep`` (each
  model rank computes its experts; one data rank, so the MoE's dispatch
  and aux loss are the one-device step's).

Every batch's mask leaves a different number of tokens in each row, so
the ranks' token counts differ and the loss's normalization over the
whole batch is tested.  The loss within 1e-5, the grad norm within
1e-4, every parameter within 1e-3 * lr per step taken and an ulp where
the two sides' first moments agree within 1e-4 (tests/_torch_train.py's
gates), the moments within 2e-3 of their largest (int8: and a step of
the row's scale), the optimizer alone against the one-device optimizer
on the same gradients; the gates that hold at another draw only
(``_torch_train_mesh.check_case``) are held by
tests/test_torch_train_mesh_contracted.py.  On a one-rank mesh (in this
process, gloo) the step and the driver equal ``mesh=None`` bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_train_mesh import (LM_CASES, LR, STEPS, WORLD,  # noqa: E402
                               arch_of, batch_of, check_case, init, run_cases)

CASES = LM_CASES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke steps are tiny: one intra-op thread keeps them from
    oversubscribing a machine that runs other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh")
    spawn(run_cases, WORLD, out, str(out), CASES, timeout=420)
    return {case: [torch.load(out / f"{case}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)] for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_one_device(case, ranks):
    """Each sharded step against the one-device step
    (``_torch_train_mesh.check_case``)."""
    check_case(ranks[case], CASES[case])


@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_one_rank_mesh_equals_one_device_bit_for_bit(moments, one_rank_mesh):
    from repro_torch.convert import batch_from_numpy
    from repro_torch.data import shard_batch
    from repro_torch.dist import get_profile, param_shardings
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import make_train_step, state_spec

    mesh = one_rank_mesh
    assert tuple(mesh.shape) == (1, 1)
    arch, opt = arch_of("internlm2-1.8b"), AdamWConfig(moment_dtype=moments)
    shardings = param_shardings(state_spec(arch, opt), mesh, get_profile("tp_dp"))
    leaves = iter(tree_leaves(init(arch, opt)))
    sharded = tree_map(lambda s: s.distribute(next(leaves)), shardings)
    plain = init(arch, opt)
    on_mesh = make_train_step(arch, opt, constant(LR), accum=2, mesh=mesh,
                              shardings=shardings)
    alone = make_train_step(arch, opt, constant(LR), accum=2)
    for i in range(STEPS):
        batch = batch_of(arch, i)
        sharded, got = on_mesh(sharded, shard_batch(batch, mesh, ("data",)))
        plain, want = alone(plain, batch_from_numpy(batch, device="cpu"))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}
    for a, b in zip(tree_leaves(sharded), tree_leaves(plain)):
        assert torch.equal(a.full_tensor(), b)
