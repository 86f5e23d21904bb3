"""The data-parallel train step on a mesh
(``train/steps.py`` ``make_sharded_train_step``) against the port's
one-device step on the same global batch, at the smoke configs (f32,
``remat="full"``, chunked attention at chunk 8), on four spawned gloo
ranks (tests/_torch_dist.py; one spawn for the module):

* internlm2-1.8b on a ``(2, 2)`` ``("data", "model")`` mesh over 3
  steps, with f32 moments under ``tp_dp``, bf16 and int8 under
  ``tp_fsdp`` (the embed axis over ``data``, so the gradients are
  reduce-scattered and the int8 row absmax is all-reduced where the
  last dim is sharded), int8 under ``tp_dp`` (the last dim over
  ``model``) and ``accum=2``; on the multi-pod ``(2, 1, 2)`` mesh over
  ``("pod", "data")``; and zamba2-1.2b (the hybrid family) on ``(2, 2)``;
* granite-moe-1b-a400m on a ``(1, 4)`` mesh under ``moe_ep`` (the
  experts' storage over ``model``; one data rank, so the MoE's dispatch
  and aux loss are the one-device step's).

Every batch's mask leaves a different number of tokens in each row, so
the ranks' token counts differ and the loss's normalization over the
whole batch is tested.  The loss within 1e-5, the grad norm within
1e-4, every parameter within 1e-3 * lr per step taken and an ulp where
the two sides' first moments agree within 1e-4 (tests/_torch_train.py's
gates; at most 5 % of a leaf's entries left out), the moments within
2e-3 of their largest (int8: and a step of the row's scale).  On a one-rank mesh (in this process, gloo) the
step and the driver equal ``mesh=None`` bit for bit.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402

WORLD = 4
STEPS = 3
LR = 1e-3
SHAPE = ("mesh_train", 32, 4)
#: name -> (arch, moments, profile, mesh shape, multi-pod, accum)
CASES = {
    "internlm2-f32": ("internlm2-1.8b", "f32", "tp_dp", (2, 2), False, 1),
    "internlm2-bf16": ("internlm2-1.8b", "bf16", "tp_fsdp", (2, 2), False, 1),
    "internlm2-int8": ("internlm2-1.8b", "int8", "tp_fsdp", (2, 2), False, 1),
    "internlm2-int8-tp": ("internlm2-1.8b", "int8", "tp_dp", (2, 2), False, 1),
    "internlm2-accum2": ("internlm2-1.8b", "f32", "tp_fsdp", (2, 2), False, 2),
    "internlm2-pods": ("internlm2-1.8b", "f32", "tp_dp", (2, 1, 2), True, 1),
    "zamba2": ("zamba2-1.2b", "f32", "tp_dp", (2, 2), False, 1),
    "granite-moe": ("granite-moe-1b-a400m", "f32", "moe_ep", (1, 4), False, 1),
}
#: tokens masked out at the start of each row: the ranks' counts differ
MASKED = (0, 5, 20, 11)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke steps are tiny: one intra-op thread keeps them from
    oversubscribing a machine that runs other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arch(name: str):
    from repro_torch.configs import get_arch

    arch = get_arch(name, smoke=True)
    cfg = arch.cfg
    kw = {"dtype": torch.float32, "remat": "full"}
    if hasattr(cfg, "attn_impl"):
        kw |= {"attn_impl": "chunked", "attn_chunk": 8}
    return dataclasses.replace(arch, cfg=dataclasses.replace(cfg, **kw))


def _batch(arch, step: int) -> dict:
    from repro_torch.configs import ShapeSpec

    batch = arch.make_batch(ShapeSpec(*SHAPE, "train"), seed=step)
    for row, n in enumerate(MASKED):
        batch["mask"][row, :n] = 0.0
    return batch


def _init(arch, opt):
    from repro_torch.train import init_state

    return init_state(arch, torch.Generator().manual_seed(1), opt, device="cpu")


def _one_device_step(case: str, state, step: int):
    """The one-device gradients and step ``step`` from ``state``
    (consumed): the grads, the new state and the metrics."""
    from repro_torch.convert import batch_from_numpy
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import value_and_grad

    name, moments, _, _, _, accum = CASES[case]
    arch, opt = _arch(name), AdamWConfig(moment_dtype=moments)
    batch = batch_from_numpy(_batch(arch, step), device="cpu")
    grads = tree_leaves(value_and_grad(arch, state["params"], batch,
                                       accum=accum)[2])
    state, m = make_train_step(arch, opt, constant(LR), accum=accum)(state,
                                                                    batch)
    return grads, state, {k: float(v) for k, v in m.items()}


def _ranks(rank: int, out: str) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    from torch.distributed.tensor import DTensor

    from repro_torch.data import shard_batch
    from repro_torch.dist import DataParallel, get_profile, param_shardings
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import make_train_step, state_spec

    # each step's averaged gradients, as the step hands them to the
    # optimizer, gathered whole after the step
    reduced, reduce_grad = [], DataParallel.reduce_grad

    def keep(self, grad, index):
        out = reduce_grad(self, grad, index)
        reduced.append(DTensor.from_local(out, self.mesh, self.placements[index],
                                          run_check=False))
        return out

    DataParallel.reduce_grad = keep
    for case, (name, moments, prof, shape, multi_pod, accum) in CASES.items():
        names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                          mesh_dim_names=names)
        arch, opt = _arch(name), AdamWConfig(moment_dtype=moments)
        shardings = param_shardings(state_spec(arch, opt), mesh,
                                    get_profile(prof, multi_pod=multi_pod))
        leaves = iter(tree_leaves(_init(arch, opt)))
        state = tree_map(lambda s: s.distribute(next(leaves)), shardings)
        axes = ("pod", "data") if multi_pod else ("data",)
        step = make_train_step(arch, opt, constant(LR), accum=accum, mesh=mesh,
                               shardings=shardings, batch_axes=axes)
        states, metrics, grads = [], [], []
        for i in range(STEPS):
            state, m = step(state, shard_batch(_batch(arch, i), mesh, axes))
            # a replicated leaf's full_tensor() is its local tensor, which
            # the next step updates in place
            states.append(tree_map(lambda d: d.full_tensor().clone(), state))
            grads.append([g.full_tensor().clone() for g in reduced])
            reduced.clear()
            metrics.append({k: float(v) for k, v in m.items()})
        torch.save({"states": states if rank == 0 else None,
                    "grads": grads if rank == 0 else None,
                    "metrics": metrics,
                    "sharded": [str(s.placements()) for s in
                                tree_leaves(shardings)]},
                   os.path.join(out, f"{case}-rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh")
    spawn(_ranks, WORLD, out, str(out), timeout=420)
    return {case: [torch.load(out / f"{case}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)] for case in CASES}


def _moment(m) -> torch.Tensor:
    if isinstance(m, dict):
        return m["q"].float() * m["scale"]
    return m.float()


def _params_close(params, want, grads, want_grads):
    """Leaves off by more than 1e-3 * lr and an ulp where the two sides'
    gradients agree within 1e-4, and each leaf's share left out."""
    from _torch_train import AGREE_REL, STEP_ATOL_LR
    from repro_torch.models.common import tree_leaves

    bad, shares = [], []
    for i, (p, w, g, wg) in enumerate(zip(tree_leaves(params), tree_leaves(want),
                                          grads, want_grads)):
        keep = (g - wg).abs() <= AGREE_REL * wg.abs()
        shares.append(1.0 - float(keep.double().mean()))
        err = (p - w).abs() - torch.finfo(w.dtype).eps * w.abs()
        if keep.any() and float(err[keep].max()) > STEP_ATOL_LR * LR:
            bad.append(f"leaf {i}: {float(err[keep].max())}")
    return bad, shares


def _moment_leaves(tree) -> list:
    if isinstance(tree, dict) and "q" not in tree:
        return [leaf for k in sorted(tree) for leaf in _moment_leaves(tree[k])]
    return [tree]


def _optimizer_close(state, before, grads, moments: str) -> list[str]:
    """The one-device optimizer (``adamw_step``) from ``before`` on the
    sharded step's own averaged gradients against the sharded step's
    state: the parameters within 1e-6 of each leaf's largest update, the
    f32 and bf16 moments within 1e-6 of their largest (bf16: an ulp),
    int8's ``q`` equal and its scales within 1e-6 relative.  Only the
    clipping norm's summation order and the int8 row absmax's all-reduce
    part them."""
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_step, constant

    want = tree_map(lambda t: t.clone(), before)
    it = iter(grads)
    adamw_step(tree_map(lambda _: next(it), want["params"]), want["opt_state"],
               want["params"], AdamWConfig(moment_dtype=moments), constant(LR))
    bad = []
    for i, (p, w, b) in enumerate(zip(tree_leaves(state["params"]),
                                      tree_leaves(want["params"]),
                                      tree_leaves(before["params"]))):
        err = (p - w).abs() - torch.finfo(w.dtype).eps * w.abs()
        if float(err.max()) > 1e-6 * float((w - b).abs().max()):
            bad.append(f"param {i}")
    for key in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(_moment_leaves(state["opt_state"][key]),
                                       _moment_leaves(want["opt_state"][key]))):
            if isinstance(b, dict):
                if not torch.equal(a["q"], b["q"]) or not torch.allclose(
                        a["scale"], b["scale"], rtol=1e-6, atol=0):
                    bad.append(f"{key} {i} (int8)")
                continue
            tol = 1e-6 if b.dtype == torch.float32 else 2 ** -8
            if float((a.float() - b.float()).abs().max()) > tol * float(
                    b.float().abs().max()):
                bad.append(f"{key} {i}")
    return bad


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_one_device(case, ranks):
    """Each of the 3 sharded steps against the one-device step from the
    same state (the sharded state before it, gathered) on the same
    global batch: the gradients each leaf within 2e-3 of its largest, the
    loss, grad norm and aux loss, the parameters at tests/_torch_train.py's
    gate where the two gradients agree within 1e-4 (at most 5 % of a
    leaf's entries left out), the moments within 2e-3 of their largest;
    and the optimizer alone (:func:`_optimizer_close`).

    int8 moments past the first step are held by the optimizer check
    alone: where a small entry's ``nu`` rounded to 0 at the step before
    (below half a step of its row's scale), its update ``mf /
    sqrt(vf)`` is up to ~200 * lr and moves with the gradient's last
    digits, so a 1e-4 gradient difference moves the parameter by more
    than 1e-3 * lr on one device too."""
    from _torch_train import GRAD_RTOL
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig

    name, moments = CASES[case][:2]
    recs = ranks[case]
    for r in recs[1:]:
        assert r["metrics"] == recs[0]["metrics"]
    if CASES[case][3] != (1, 4):
        assert any("Shard" in p for p in recs[0]["sharded"])
    before = _init(_arch(name), AdamWConfig(moment_dtype=moments))
    for k, (got, state, grads) in enumerate(zip(
            recs[0]["metrics"], recs[0]["states"], recs[0]["grads"])):
        bad = _optimizer_close(state, before, grads, moments)
        assert not bad, (k, bad)
        want_grads, want_state, want = _one_device_step(case, before, k)
        for i, (g, wg) in enumerate(zip(grads, want_grads, strict=True)):
            err = float((g - wg).abs().max())
            assert err <= GRAD_RTOL * float(wg.abs().max()), (k, i, err)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["aux_loss"], want["aux_loss"],
                                   rtol=1e-5, atol=1e-7)
        assert got["lr"] == want["lr"]
        if moments != "int8" or k == 0:
            bad, shares = _params_close(state["params"], want_state["params"],
                                        grads, want_grads)
            assert not bad, (k, bad)
            assert max(shares) <= 0.05, (k, shares)
        for key in ("mu", "nu"):
            for a, b in zip(_moment_leaves(state["opt_state"][key]),
                            _moment_leaves(want_state["opt_state"][key])):
                # int8: a q may round one step apart (its row's scale)
                step = b["scale"] if isinstance(b, dict) else 0.0
                a, b = _moment(a), _moment(b)
                assert bool(((a - b).abs() <= step + GRAD_RTOL * max(
                    float(b.abs().max()), 1e-30)).all()), (k, key)
        assert int(state["step"]) == int(want_state["step"]) == k + 1
        assert int(state["opt_state"]["count"]) == k + 1
        before = tree_map(lambda t: t.clone(), state)


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
    arch, opt = _arch("internlm2-1.8b"), AdamWConfig(moment_dtype=moments)
    shardings = param_shardings(state_spec(arch, opt), mesh, get_profile("tp_dp"))
    leaves = iter(tree_leaves(_init(arch, opt)))
    sharded = tree_map(lambda s: s.distribute(next(leaves)), shardings)
    plain = _init(arch, opt)
    on_mesh = make_train_step(arch, opt, constant(LR), accum=2, mesh=mesh,
                              shardings=shardings)
    alone = make_train_step(arch, opt, constant(LR), accum=2)
    for i in range(STEPS):
        batch = _batch(arch, i)
        sharded, got = on_mesh(sharded, shard_batch(batch, mesh, ("data",)))
        plain, want = alone(plain, batch_from_numpy(batch, device="cpu"))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}
    for a, b in zip(tree_leaves(sharded), tree_leaves(plain)):
        assert torch.equal(a.full_tensor(), b)
