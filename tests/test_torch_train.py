"""The port's train, eval, prefill and serve steps
(``repro_torch/train/steps.py``) beyond one step per arch
(tests/test_torch_train_lm.py, test_torch_train_families.py), on the
dense and multimodal families (the MoE family is
tests/test_torch_train_moe.py, the hybrid, recurrent and
encoder-decoder ones tests/test_torch_train_hybrid.py; the shared cases
tests/_torch_train.py):

* the reference's whole jitted ``make_train_step`` on internlm2-1.8b's
  smoke config, at ``accum`` 1 and 2 and with ``cast_once`` (bf16 compute
  from f32 masters), against the port's (f32: the tolerances of
  tests/_torch_train.py; ``cast_once``: the loss at 2e-3, the reference's
  attention tolerance, and the grad norm at 2e-2, as bf16 rounds the
  forward and the backward);
* the port alone: ``accum=2`` against ``accum=1`` on the same batch, and
  ``remat`` none, full and dots giving the same gradients; the
  gradients leave the parameters not requiring grad; the reference's own
  oracles ``test_train_step_smoke`` and ``test_loss_decreases_smoke``
  (tests/test_archs_smoke.py) on the family's archs;
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
    SMOKE_TRAIN, archs, check_loss_decreases_smoke,
    check_remat_gives_the_same_grads,
    check_train_step_smoke, family_archs, port_batch, port_inputs, port_state,
    ref_state, reference_step, step_close, variant)
from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.train.steps import state_spec as ref_state_spec  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.models.common import ParamSpec, tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    make_eval_step,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    state_spec,
    value_and_grad,
)

NAME = "internlm2-1.8b"
#: this file's families
ARCHS = family_archs("dense", "vlm")
#: remat settings held equal on the family: the LM has all three
REMAT = {"internlm2-1.8b": ("full", "dots")}
_batch, _state = port_batch, port_state


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
    check_remat_gives_the_same_grads(name, REMAT[name])


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_smoke(name):
    check_train_step_smoke(name)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_decreases_smoke(name):
    check_loss_decreases_smoke(name)


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
