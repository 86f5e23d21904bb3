"""The tensor- and data-parallel train step on four gloo ranks against
the one-device step: the cases, the ranks' body and the checks shared by
tests/test_torch_train_mesh.py and test_torch_train_mesh_families.py
(pytest does not collect this module; the ranks import it and the port
only).

A case is ``(arch, moments, profile, mesh shape, multi-pod, accum)``: the
smoke arch in f32 with ``remat="full"`` and chunked attention at chunk 8,
its state drawn by ``init_state`` (the ``"real"`` draw) or with the
attention projections then rescaled to the fan-in they contract over
(the ``"contracted"`` draw, :func:`init`), STEPS steps at
``constant(LR)`` on batches of SHAPE whose masks leave a different
number of tokens in each row (MASKED), so the ranks' token counts differ
and the loss's normalization over the whole batch is tested.
"""
import dataclasses
import os

import numpy as np
import torch

WORLD = 4
STEPS = 3
LR = 1e-3
SHAPE = ("mesh_train", 32, 4)
#: tokens masked out at the start of each row: the ranks' counts differ
MASKED = (0, 5, 20, 11)
#: name -> (arch, moments, profile, mesh shape, multi-pod, accum): the
#: LM, hybrid and MoE cases
LM_CASES = {
    "internlm2-f32": ("internlm2-1.8b", "f32", "tp_dp", (2, 2), False, 1),
    "internlm2-bf16": ("internlm2-1.8b", "bf16", "tp_fsdp", (2, 2), False, 1),
    "internlm2-int8": ("internlm2-1.8b", "int8", "tp_fsdp", (2, 2), False, 1),
    "internlm2-int8-tp": ("internlm2-1.8b", "int8", "tp_dp", (2, 2), False, 1),
    "internlm2-accum2": ("internlm2-1.8b", "f32", "tp_fsdp", (2, 2), False, 2),
    "internlm2-pods": ("internlm2-1.8b", "f32", "tp_dp", (2, 1, 2), True, 1),
    "zamba2": ("zamba2-1.2b", "f32", "tp_dp", (2, 2), False, 1),
    "granite-moe": ("granite-moe-1b-a400m", "f32", "moe_ep", (1, 4), False, 1),
}


def arch_of(name: str):
    from repro_torch.configs import get_arch

    arch = get_arch(name, smoke=True)
    cfg = arch.cfg
    kw = {"dtype": torch.float32, "remat": "full"}
    if hasattr(cfg, "attn_impl"):
        kw |= {"attn_impl": "chunked", "attn_chunk": 8}
    return dataclasses.replace(arch, cfg=dataclasses.replace(cfg, **kw))


def batch_of(arch, step: int) -> dict:
    from repro_torch.configs import ShapeSpec

    batch = arch.make_batch(ShapeSpec(*SHAPE, "train"), seed=step)
    for row, n in enumerate(MASKED):
        batch["mask"][row, :n] = 0.0
    return batch


#: the attention projections' fan-in: what they contract over
_CONTRACTED = {"wq": lambda s: s[-3], "wk": lambda s: s[-3],
               "wv": lambda s: s[-3], "wo": lambda s: s[-3] * s[-2]}


def _contracted(tree, path=()):
    """The attention projections of a parameter tree rescaled in place
    from ``materialize``'s fan-in (axis -2) to the fan-in they contract
    over, as tests/_torch_train.py draws them (ROADMAP §3 item 5: at the
    other the scores' softmax is near one-hot, and a relative change of
    6e-8 in the parameters moves the one-device gradients by 2.4e-4 of
    their largest)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _contracted(v, (*path, k))
    elif len(path) > 1 and "attn" in path[-2] and path[-1] in _CONTRACTED:
        s = tree.shape
        tree.mul_((s[-2] / _CONTRACTED[path[-1]](s)) ** 0.5)


def init(arch, opt, draw: str = "real"):
    """The state ``init_state`` draws from seed 1 (``"real"``), or with
    the attention projections at their contracted fan-in
    (``"contracted"``), or a reference state saved by
    tests/test_torch_train_mesh_reference.py (the ``.npz``'s path)."""
    from repro_torch.train import init_state

    if draw.endswith(".npz"):
        from _torch_serve_mesh import unflat
        from repro_torch.convert import state_from_numpy

        return state_from_numpy(unflat(dict(np.load(draw))), device="cpu")
    state = init_state(arch, torch.Generator().manual_seed(1), opt,
                       device="cpu")
    if draw == "contracted":
        _contracted(state["params"])
    return state


def one_device_step(spec: tuple, state, step: int):
    """The one-device gradients and step ``step`` from ``state``
    (consumed): the grads, the new state and the metrics."""
    from repro_torch.convert import batch_from_numpy
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import value_and_grad

    name, moments, _, _, _, accum = spec
    arch, opt = arch_of(name), AdamWConfig(moment_dtype=moments)
    batch = batch_from_numpy(batch_of(arch, step), device="cpu")
    grads = tree_leaves(value_and_grad(arch, state["params"], batch,
                                       accum=accum)[2])
    state, m = make_train_step(arch, opt, constant(LR), accum=accum)(state,
                                                                    batch)
    return grads, state, {k: float(v) for k, v in m.items()}


def run_cases(rank: int, out: str, cases: dict, draw: str = "real") -> None:
    """A rank's body: each case's STEPS sharded steps from :func:`init`,
    its metrics, and on rank 0 its states and the gradients the step
    handed ``DataParallel.reduce_grad``'s caller, gathered whole, saved
    to ``out/<case>-rank<rank>.pt``."""
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
    for case, (name, moments, prof, shape, multi_pod, accum) in cases.items():
        names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
        mesh = DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                          mesh_dim_names=names)
        arch, opt = arch_of(name), AdamWConfig(moment_dtype=moments)
        shardings = param_shardings(state_spec(arch, opt), mesh,
                                    get_profile(prof, multi_pod=multi_pod))
        leaves = iter(tree_leaves(init(arch, opt, draw)))
        state = tree_map(lambda s: s.distribute(next(leaves)), shardings)
        axes = ("pod", "data") if multi_pod else ("data",)
        step = make_train_step(arch, opt, constant(LR), accum=accum, mesh=mesh,
                               shardings=shardings, batch_axes=axes)
        states, metrics, grads = [], [], []
        for i in range(STEPS):
            state, m = step(state, shard_batch(batch_of(arch, i), mesh, axes))
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


def check_case(recs: list, spec: tuple, draw: str = "real") -> None:
    """Each of the STEPS sharded steps of the case ``spec`` (its ranks'
    records ``recs``, from the state :func:`init` draws by ``draw``)
    against the one-device step from the same state (the sharded state
    before it, gathered) on the same global batch: the metrics equal on
    every rank; the gradients each leaf within 2e-3 of its largest, the
    loss, grad norm and aux loss, the parameters at tests/_torch_train.py's
    gate where the two gradients agree within 1e-4, the moments within
    2e-3 of their largest (int8: and a step of the row's scale).

    Two gates hold at one draw only, and one at neither:

    * the optimizer alone (:func:`_optimizer_close`) at the real draw: it
      replays the one-device optimizer on the sharded step's gradients,
      so the draw does not change what it holds, and at the contracted
      draw the one-device clipping norm's summation order puts one int8
      ``q`` of ``internlm2-int8-tp`` at a half-way tie in step 1;
    * at most 5 % of a leaf's entries left out of the parameter gate, at
      the contracted draw: at the real draw the scores' softmax is near
      one-hot, and the tensor-parallel step's summation order, correct
      but not the one-device one, leaves 6.25-18 % of some leaf's
      gradient entries more than 1e-4 apart (0.5-3.1 % at the contracted
      draw);
    * bf16 moments are held by the optimizer check and the gradients,
      not against the one-device step's: one bf16 ulp of an entry above
      half the largest is more than 2e-3 of the largest, and the two
      sides' gradients, 1e-6 (contracted) to 3e-5 (real draw) of their
      largest apart, round a few entries to neighbouring bf16 numbers
      (real draw: 2, 6 and 13 entries in steps 0-2; contracted: 2 in
      step 1).

    int8 moments past the first step are held by the optimizer check
    alone: where a small entry's ``nu`` rounded to 0 at the step before
    (below half a step of its row's scale), its update ``mf /
    sqrt(vf)`` is up to ~200 * lr and moves with the gradient's last
    digits, so a 1e-4 gradient difference moves the parameter by more
    than 1e-3 * lr on one device too."""
    from _torch_train import GRAD_RTOL
    from repro_torch.models.common import tree_map
    from repro_torch.optim import AdamWConfig

    name, moments = spec[:2]
    for r in recs[1:]:
        assert r["metrics"] == recs[0]["metrics"]
    if spec[3] != (1, 4):
        assert any("Shard" in p for p in recs[0]["sharded"])
    before = init(arch_of(name), AdamWConfig(moment_dtype=moments), draw)
    for k, (got, state, grads) in enumerate(zip(
            recs[0]["metrics"], recs[0]["states"], recs[0]["grads"])):
        if draw == "real":
            bad = _optimizer_close(state, before, grads, moments)
            assert not bad, (k, bad)
        want_grads, want_state, want = one_device_step(spec, before, k)
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
            if draw == "contracted":
                assert max(shares) <= 0.05, (k, shares)
        for key in ("mu", "nu") if moments != "bf16" else ():
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


# ---------------------------------------------------------------------------
# the reference's sharded train step, in a subprocess with four fake devices
# ---------------------------------------------------------------------------


def reference_step(name: str, mesh_shape: list, profile_name: str,
                   state_path: str, batch_path: str, out_path: str) -> None:
    """One step of the reference's ``make_train_step`` jitted as its
    dry-run jits it (the state on ``param_shardings(state_spec(...),
    ensure_model_axis=True)``, the batch on the input profile, under
    ``use_mesh_context``) on a plain ``jax.sharding.Mesh`` of ``WORLD``
    host devices (tests/_torch_serve_mesh.py says why not
    ``make_host_mesh``), from the state and on the batch saved as
    ``.npz``; and its gradients, ``jax.value_and_grad(arch.loss)`` jitted
    on the same shardings.  Writes the loss, the gradients
    (``grad/<path>``), the new state (``state/<path>``) and the metrics
    (``metric/<name>``)."""
    import jax

    assert len(jax.devices()) == WORLD, jax.devices()
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from _torch_serve_mesh import flat, unflat
    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.dist.sharding import (get_profile, param_shardings,
                                     use_mesh_context)
    from repro.launch.dryrun import _input_profile, _kv_divisible
    from repro.optim import AdamWConfig
    from repro.optim.schedule import constant
    from repro.train.steps import make_train_step, state_spec

    arch = get_arch(name, smoke=True)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype=jnp.float32))
    mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape), ("data", "model"))
    profile = get_profile(profile_name)
    opt = AdamWConfig()
    in_prof = _input_profile(arch, mesh, multi_pod=False,
                             kv_divisible=_kv_divisible(arch, mesh),
                             batch_axes=profile.activation_rules["batch"])
    state = jax.tree.map(jnp.asarray, unflat(dict(np.load(state_path))))
    batch = {k: jnp.asarray(v) for k, v in np.load(batch_path).items()}
    state_sh = param_shardings(state_spec(arch, opt), mesh, profile,
                               ensure_model_axis=True)
    batch_sh = param_shardings(arch.batch_spec(ShapeSpec(*SHAPE, "train")),
                               mesh, in_prof)
    with use_mesh_context(mesh, profile):
        grad = jax.jit(jax.value_and_grad(arch.loss, has_aux=True),
                       in_shardings=(state_sh["params"], batch_sh))
        (loss, _), grads = grad(state["params"], batch)
        step = jax.jit(make_train_step(arch, opt, constant(LR)),
                       in_shardings=(state_sh, batch_sh),
                       out_shardings=(state_sh, None))
        new, metrics = step(state, batch)
    out = {"loss": np.asarray(loss)}
    for pre, tree in (("grad", grads), ("state", new)):
        for k, v in flat(jax.tree.map(np.asarray, tree)).items():
            out[f"{pre}/{k}"] = v
    for k, v in metrics.items():
        out[f"metric/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


def start_reference_step(args: list, timeout: float):
    """:func:`reference_step` in a subprocess with ``WORLD`` fake host
    devices (``_torch_serve_mesh.finish`` waits for it)."""
    import json
    import subprocess
    import sys

    from _torch_serve_mesh import ROOT

    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "PATH": os.environ.get("PATH", ""), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
           "OMP_NUM_THREADS": "1"}
    code = ("import _torch_train_mesh as m, json, sys; "
            "m.reference_step(*json.loads(sys.argv[1]))")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(args)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), timeout
