"""Shared cases of the port's train tests (tests/test_torch_train*.py): a
smoke arch in f32 on both sides, the port's with ``remat="full"`` and,
where the arch has attention, ``attn_impl="chunked"`` at chunk 8 (4 KV
tiles at the smoke length, the causal skip taken), so its gradients run
through every checkpoint the port places, the reference's at its own
smoke settings (dense attention: the same function); a state of the
reference's layout drawn in numpy, carried across with
``convert.state_from_numpy``; and the comparisons at the stated
tolerances."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_arch
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_update, apply_updates
from repro.models.common import ParamSpec as RefParamSpec
from repro.train.steps import make_train_step as ref_train_step
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_arch
from repro_torch.convert import batch_from_numpy, state_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig, constant
from repro_torch.train.steps import init_state, make_train_step, value_and_grad

SMOKE_TRAIN = ShapeSpec("smoke_train", seq_len=32, global_batch=2, kind="train")
#: gradients: each leaf within GRAD_RTOL of its largest |g| (the
#: reference's attention tolerance, tests/test_kernels.py:102)
GRAD_RTOL = 2e-3
#: after one AdamW step: within STEP_ATOL_LR * lr of the reference, and
#: one rounding of the parameter (p + u rounds to its f32 neighbours), where
#: the two sides' first moments (count 1: (1 - b1) * clip * g) agree within
#: AGREE_REL of the reference's.  A first step moves each entry by lr * g /
#: (|g| + eps), so where g is rounding noise (a sum that cancels, or |g|
#: near AdamW's eps) the step follows its last digits; there the gradient
#: is held by the gradient comparison instead.  Where the moments agree
#: within 1e-4 the step can move by no more than 1e-4 * lr
STEP_ATOL_LR = 1e-3
AGREE_REL = 1e-4
LR = 1e-3


def variant(arch, **kw):
    """The port's ``arch`` in f32 with remat="full" and, where it has
    attention, chunked attention at chunk 8."""
    cfg = arch.cfg
    extra = {"dtype": torch.float32, "remat": "full"}
    if hasattr(cfg, "attn_impl"):
        extra |= {"attn_impl": "chunked", "attn_chunk": 8}
    return dataclasses.replace(arch, cfg=dataclasses.replace(cfg, **(extra | kw)))


def archs(name: str, **kw):
    """(reference arch at its smoke settings, port arch :func:`variant`),
    both f32."""
    rarch = ref_arch(name, smoke=True)
    return (dataclasses.replace(rarch, cfg=dataclasses.replace(
        rarch.cfg, dtype=jnp.float32)),
        variant(get_arch(name, smoke=True), **kw))


#: the attention projections' fan-in: what they contract over
_CONTRACTED = {"wq": lambda s: s[-3], "wk": lambda s: s[-3],
               "wv": lambda s: s[-3], "wo": lambda s: s[-3] * s[-2]}


def ref_state(rarch, seed: int = 0) -> dict:
    """A train state of the reference's layout (its ``state_spec``) as
    numpy: the parameters drawn by numpy from ``seed`` as the reference's
    ``materialize`` draws them (zeros, ones, or a normal at the spec's
    scale or 1/sqrt(fan-in over axis -2)), but the attention projections
    at the fan-in they contract over (ROADMAP §3 item 5: under the
    reference's rule the scores' softmax is near one-hot, and rounding
    moves the gradients by ~2e-4 of their largest); zero f32 moments and
    counts.  Drawing in numpy costs no JAX compile per leaf."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        if s.init in ("zeros", "ones"):
            return np.full(s.shape, float(s.init == "ones"), np.float32)
        name = str(path[-1].key)
        fan_in = (_CONTRACTED[name](s.shape) if name in _CONTRACTED
                  and len(s.shape) >= 3 else
                  s.shape[-2] if len(s.shape) >= 2 else s.shape[-1])
        std = s.scale if s.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(
        draw, rarch.param_spec(), is_leaf=lambda x: isinstance(x, RefParamSpec))
    zeros = jax.tree.map(np.zeros_like, params)
    count = np.zeros((), np.int32)
    return {"params": params,
            "opt_state": {"mu": zeros, "nu": jax.tree.map(np.copy, zeros),
                          "count": count},
            "step": count.copy()}


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def reference_grads(rarch, params: dict, batch: dict):
    """The reference's loss and gradients (``jax.value_and_grad`` of its
    ``arch.loss``, jitted) as numpy."""
    (loss, _), grads = jax.jit(jax.value_and_grad(rarch.loss, has_aux=True))(
        jnp_tree(params), jnp_tree(batch))
    return float(loss), jax.tree.map(np.asarray, grads)


def reference_update(state: dict, grads, opt=None):
    """The reference's update on its own gradients, jitted, as its
    ``make_train_step`` runs it after ``value_and_grad``: the new
    parameters and optimizer state and the update's metrics."""
    def update(st, g):
        upd, opt_state, om = adamw_update(g, st["opt_state"], st["params"],
                                          opt or RefAdamW())
        return apply_updates(st["params"], upd), opt_state, om
    return jax.tree.map(np.asarray, jax.jit(update)(jnp_tree(state),
                                                     jnp_tree(grads)))


def reference_step(rarch, state: dict, batch: dict, opt=None, **kw):
    """The reference's jitted ``make_train_step`` (``kw``: ``accum``,
    ``cast_once``): its new state and metrics as numpy."""
    step = jax.jit(ref_train_step(rarch, opt or RefAdamW(), **kw))
    return jax.tree.map(np.asarray, step(jnp_tree(state), jnp_tree(batch)))


def port_inputs(state: dict, batch: dict):
    return state_from_numpy(state, device="cpu"), batch_from_numpy(batch,
                                                                   device="cpu")


def grads_close(got, want) -> list[str]:
    """Leaves whose largest difference exceeds GRAD_RTOL of the
    reference's largest |g|."""
    bad = []
    for i, (a, b) in enumerate(zip(tree_leaves(got), jax.tree.leaves(want))):
        b = np.asarray(b, np.float32)
        err = float(np.abs(a.float().numpy() - b).max())
        if err > GRAD_RTOL * max(float(np.abs(b).max()), 1e-30):
            bad.append(f"leaf {i}: {err} of max {np.abs(b).max()}")
    return bad


def step_close(params, want_params, mu, want_mu, lr: float = LR):
    """Leaves where a parameter after the step is off the reference's by
    more than STEP_ATOL_LR * lr and an ulp where the first moments ``mu`` (the
    port's) and ``want_mu`` (the reference's) agree within AGREE_REL; and
    the count of entries left out."""
    bad, masked = [], 0
    for i, (p, w, m, wm) in enumerate(zip(
            tree_leaves(params), jax.tree.leaves(want_params),
            tree_leaves(mu), jax.tree.leaves(want_mu))):
        wm = np.asarray(wm, np.float32)
        keep = np.abs(m.float().numpy() - wm) <= AGREE_REL * np.abs(wm)
        masked += int((~keep).sum())
        w = np.asarray(w, np.float32)
        err = np.abs(p.float().numpy() - w) - np.spacing(np.abs(w))
        if keep.any() and float(err[keep].max()) > STEP_ATOL_LR * lr:
            bad.append(f"leaf {i}: {float(err[keep].max())}")
    return bad, masked


# ---------------------------------------------------------------------------
# the port alone, per arch (tests/test_torch_train*.py, one file a family)
# ---------------------------------------------------------------------------


def family_archs(*families: str) -> tuple[str, ...]:
    """The registry's archs of these families, in its order."""
    return tuple(n for n in ARCH_NAMES
                 if get_arch(n, smoke=True).family in families)


def port_batch(arch, seed: int, shape=SMOKE_TRAIN) -> dict:
    return batch_from_numpy(arch.make_batch(shape, seed=seed), device="cpu")


def port_state(arch, seed: int = 0, opt=None) -> dict:
    return init_state(arch, torch.Generator().manual_seed(seed),
                      opt or AdamWConfig(), device="cpu")


def check_remat_gives_the_same_grads(name: str, modes: tuple[str, ...]):
    """``remat`` in each of ``modes`` gives the gradients of ``"none"``
    within 1e-6 of each leaf's largest, and leaves the parameters not
    requiring grad."""
    base = variant(get_arch(name, smoke=True), remat="none")
    state = port_state(base, seed=6)
    batch = port_batch(base, seed=6)
    _, _, want = value_and_grad(base, state["params"], batch)
    for remat in modes:
        arch = dataclasses.replace(base, cfg=dataclasses.replace(
            base.cfg, remat=remat))
        _, _, got = value_and_grad(arch, state["params"], batch)
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert not any(p.requires_grad for p in tree_leaves(state["params"]))


def check_train_step_smoke(name: str):
    """The reference's oracle (tests/test_archs_smoke.py) on the port:
    one step at the config's own dtype, finite, near log(vocab), the
    parameters moved and finite."""
    arch = get_arch(name, smoke=True)
    state = port_state(arch, seed=0, opt=AdamWConfig(weight_decay=0.0))
    first = tree_leaves(state["params"])[0].clone()
    state2, metrics = make_train_step(arch, AdamWConfig(weight_decay=0.0))(
        state, port_batch(arch, seed=1))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{name}: non-finite loss {loss}"
    assert int(state2["step"]) == 1
    assert loss < np.log(arch.cfg.vocab_padded) + 2.0, (name, loss)
    assert not torch.allclose(first, tree_leaves(state2["params"])[0])
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(state2["params"]))


def check_loss_decreases_smoke(name: str):
    """The reference's oracle: four steps on one structured batch lower
    the loss."""
    arch = get_arch(name, smoke=True)
    opt = AdamWConfig(weight_decay=0.0, grad_clip_norm=0.0)
    state = port_state(arch, seed=0, opt=opt)
    batch = port_batch(arch, seed=2)
    step = make_train_step(arch, opt, constant(3e-3))
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], (name, losses)
