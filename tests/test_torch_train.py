"""The port's train, eval, prefill and serve steps
(``repro_torch/train/steps.py``) beyond one step per arch
(tests/test_torch_train_lm.py, test_torch_train_families.py):

* the reference's whole jitted ``make_train_step`` on internlm2-1.8b's
  smoke config, at ``accum`` 1 and 2 and with ``cast_once`` (bf16 compute
  from f32 masters), against the port's (f32: the tolerances of
  tests/_torch_train.py; ``cast_once``: the loss at 2e-3, the reference's
  attention tolerance, and the grad norm at 2e-2, as bf16 rounds the
  forward and the backward);
* the port alone: ``accum=2`` against ``accum=1`` on the same batch, and
  ``remat`` none, full and dots giving the same gradients (zamba2,
  xlstm-125m and whisper-base with remat full against none too); the
  gradients leave the parameters not requiring grad; the MoE's scatter and
  one-shard ``shard_map`` dispatches giving the dense dispatch's
  gradients where nothing drops; the reference's own
  oracles ``test_train_step_smoke`` and ``test_loss_decreases_smoke``
  (tests/test_archs_smoke.py) on all ten archs;
* ``make_eval_step`` (under no grad, so flash attention runs), the
  prefill and serve steps against the model functions they wrap, and the
  state's spec against ``init_state``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_train import (  # noqa: E402
    SMOKE_TRAIN, archs, port_inputs, ref_state, reference_step, step_close,
    variant)
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.train.steps import state_spec as ref_state_spec  # noqa: E402
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_arch  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.models.common import ParamSpec, tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig, constant  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    init_state,
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    state_spec,
    value_and_grad,
)

NAME = "internlm2-1.8b"
#: remat settings held equal on each family: the LM has all three
REMAT = {"internlm2-1.8b": ("full", "dots"), "granite-moe-1b-a400m": ("full",),
         "zamba2-1.2b": ("full",), "xlstm-125m": ("full",),
         "whisper-base": ("full",)}


def _batch(arch, seed: int, shape=SMOKE_TRAIN) -> dict:
    return batch_from_numpy(arch.make_batch(shape, seed=seed), device="cpu")


def _state(arch, seed: int = 0, opt=None) -> dict:
    return init_state(arch, torch.Generator().manual_seed(seed),
                      opt or AdamWConfig(), device="cpu")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference_jitted(accum):
    rarch, parch = archs(NAME)
    state = ref_state(rarch, seed=3)
    batch = parch.make_batch(SMOKE_TRAIN, seed=3)
    new_state, metrics = reference_step(rarch, state, batch, accum=accum)
    pstate, pbatch = port_inputs(state, batch)
    pstate, pm = make_train_step(parch, AdamWConfig(), accum=accum)(pstate,
                                                                   pbatch)
    bad, masked = step_close(pstate["params"], new_state["params"],
                             pstate["opt_state"]["mu"],
                             new_state["opt_state"]["mu"])
    assert not bad, (bad, masked)
    assert int(pstate["step"]) == int(new_state["step"]) == 1
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(pm[key]), float(metrics[key]),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=1e-4)


def test_cast_once_matches_reference_jitted():
    """bf16 compute (the config's dtype) from f32 masters, the cast once
    at step entry, inside the graph: the grads are f32."""
    rarch, parch = archs(NAME)
    rarch = dataclasses.replace(rarch, cfg=dataclasses.replace(
        rarch.cfg, dtype=jnp.bfloat16))
    parch = variant(get_arch(NAME, smoke=True), dtype=torch.bfloat16)
    state = ref_state(rarch, seed=4)
    batch = parch.make_batch(SMOKE_TRAIN, seed=4)
    new_state, metrics = reference_step(rarch, state, batch, cast_once=True)
    pstate, pbatch = port_inputs(state, batch)
    _, _, grads = value_and_grad(parch, pstate["params"], pbatch,
                                 cast_once=True)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    pstate, pm = make_train_step(parch, AdamWConfig(), cast_once=True)(
        pstate, pbatch)
    np.testing.assert_allclose(float(pm["loss"]), float(metrics["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(metrics["grad_norm"]), rtol=2e-2)
    assert all(p.dtype == torch.float32 for p in tree_leaves(pstate["params"]))


def test_accum_matches_one_batch():
    parch = variant(get_arch(NAME, smoke=True))
    batch = _batch(parch, seed=5, shape=ShapeSpec("t", 32, 4, "train"))
    runs = []
    for accum in (1, 2):
        state = _state(parch, seed=5)
        loss, _, grads = value_and_grad(parch, state["params"], batch,
                                        accum=accum)
        runs.append((float(loss), tree_leaves(grads)))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for a, b in zip(runs[1][1], runs[0][1]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("name", REMAT)
def test_remat_gives_the_same_grads(name):
    base = variant(get_arch(name, smoke=True), remat="none")
    state = _state(base, seed=6)
    batch = _batch(base, seed=6)
    _, _, want = value_and_grad(base, state["params"], batch)
    for remat in REMAT[name]:
        arch = dataclasses.replace(base, cfg=dataclasses.replace(
            base.cfg, remat=remat))
        _, _, got = value_and_grad(arch, state["params"], batch)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert not any(p.requires_grad for p in tree_leaves(state["params"]))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_train_step_smoke(name):
    """The reference's oracle (tests/test_archs_smoke.py) on the port:
    one step at the config's own dtype, finite, near log(vocab), the
    parameters moved and finite."""
    arch = get_arch(name, smoke=True)
    state = _state(arch, seed=0, opt=AdamWConfig(weight_decay=0.0))
    first = tree_leaves(state["params"])[0].clone()
    state2, metrics = make_train_step(arch, AdamWConfig(weight_decay=0.0))(
        state, _batch(arch, seed=1))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{name}: non-finite loss {loss}"
    assert int(state2["step"]) == 1
    assert loss < np.log(arch.cfg.vocab_padded) + 2.0, (name, loss)
    assert not torch.allclose(first, tree_leaves(state2["params"])[0])
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(state2["params"]))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_decreases_smoke(name):
    """The reference's oracle: four steps on one structured batch lower
    the loss."""
    arch = get_arch(name, smoke=True)
    opt = AdamWConfig(weight_decay=0.0, grad_clip_norm=0.0)
    state = _state(arch, seed=0, opt=opt)
    batch = _batch(arch, seed=2)
    step = make_train_step(arch, opt, constant(3e-3))
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], (name, losses)


def test_eval_step_runs_flash_under_no_grad():
    """The eval step takes the kernel's path (its plain version on the
    CPU), which refuses a grad, so it runs with grad off: the loss equals
    the chunked path's within the attention tolerance."""
    arch = variant(get_arch(NAME, smoke=True))
    state = _state(arch, seed=7)
    batch = _batch(arch, seed=7)
    want = make_eval_step(arch)(state["params"], batch)
    flash = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, attn_impl="flash"))
    for p in tree_leaves(state["params"]):
        p.requires_grad_(True)
    got = make_eval_step(flash)(state["params"], batch)
    assert not got["loss"].requires_grad
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=2e-3)
    with pytest.raises(RuntimeError, match="no backward"):
        flash.loss(state["params"], batch)


@pytest.mark.parametrize("cast_once", [False, True])
def test_prefill_and_serve_steps_wrap_the_model(cast_once):
    arch = get_arch(NAME, smoke=True)
    state = _state(arch, seed=8)
    params = state["params"]
    toks = _batch(arch, seed=8, shape=ShapeSpec("p", 8, 2, "prefill"))
    logits, cache = make_prefill_step(arch, max_len=12, cast_once=cast_once)(
        params, toks)
    want, wcache = arch.prefill(params, toks, max_len=12)
    torch.testing.assert_close(logits, want, rtol=2e-2, atol=2e-2)
    tok = {"tokens": logits[:, -1, :arch.cfg.vocab].argmax(-1)[:, None]}
    got, cache = make_serve_step(arch, cast_once=cast_once)(params, cache, tok)
    want, _ = arch.decode(params, wcache, tok)
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)
    assert cache["length"] == 9
    if not cast_once:
        assert torch.equal(logits, arch.prefill(params, toks, max_len=12)[0])


@pytest.mark.parametrize("moments", ["f32", "bf16", "int8"])
def test_state_spec_matches_init_state(moments):
    arch = get_arch(NAME, smoke=True)
    opt = AdamWConfig(moment_dtype=moments)
    state = _state(arch, opt=opt)
    spec = state_spec(arch, opt)
    leaves = tree_leaves(state)
    specs = tree_leaves(spec)
    assert len(leaves) == len(specs)
    for t, s in zip(leaves, specs):
        assert isinstance(s, ParamSpec)
        assert tuple(t.shape) == s.shape and t.dtype == s.dtype
    ref = jax.tree.leaves(ref_state_spec(ref_arch(NAME, smoke=True),
                                         RefAdamW(moment_dtype=moments)))
    assert [tuple(s.shape) for s in ref] == [s.shape for s in specs]


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
