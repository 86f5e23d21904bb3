"""Shared cases of the port's decoder-LM tests against the reference
(tests/test_torch_lm.py in f32, tests/test_torch_lm_bf16.py in bf16;
pytest does not collect this module): the reference's parameters of
each smoke config (its ``materialize``), the tokens, and the reference's
logits of the full forward, the prefill and each decode step, jitted
once per config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as ref_arch
from repro.models import lm as jlm
from repro.models.common import materialize as ref_materialize
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.kernels.check import compare
from repro_torch.models import lm

#: port dtype, reference dtype, tolerance
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-3),
          "bf16": (torch.bfloat16, jnp.bfloat16, 6e-2)}
PROMPT, STEPS, MAX_LEN = 8, 3, 16
#: the archs of this module, those built on ``lm.LMConfig`` (zamba2,
#: xlstm-125m and whisper-base have their own: test_torch_zamba2.py,
#: test_torch_xlstm.py, test_torch_whisper.py)
LM_ARCHS = tuple(n for n in ARCH_NAMES
                 if isinstance(get_arch(n, smoke=True).cfg, lm.LMConfig))
#: the reference's forward, compiled once per config (static)
_REF = {"hidden_states": jax.jit(jlm.hidden_states, static_argnums=1),
        "logits_fn": jax.jit(jlm.logits_fn, static_argnums=1),
        "prefill": jax.jit(jlm.prefill, static_argnums=1,
                           static_argnames="max_len"),
        "decode_step": jax.jit(jlm.decode_step, static_argnums=1)}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def reference_params() -> dict:
    """The reference's parameters of each smoke config, as numpy (f32)."""
    return {n: jax.tree.map(np.asarray, ref_materialize(
        ref_arch(n, smoke=True).param_spec(), jax.random.key(0)))
        for n in LM_ARCHS}


def _tokens(cfg, seed: int, n: int = PROMPT + STEPS) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, n)).astype(np.int32)


def reference_runs(ref_params: dict, dt: str) -> dict:
    """Per (arch, ``dt``): the configs, the tokens, and the reference's
    logits of the full forward, the prefill and each decode step."""
    out = {}
    for i, name in enumerate(LM_ARCHS):
        for tdt, jdt, _ in (DTYPES[dt],):
            jcfg = dataclasses.replace(ref_arch(name, smoke=True).cfg, dtype=jdt)
            cfg = dataclasses.replace(get_arch(name, smoke=True).cfg, dtype=tdt)
            p = jax.tree.map(jnp.asarray, ref_params[name])
            toks = _tokens(cfg, seed=i)
            h, aux = _REF["hidden_states"](p, jcfg, jnp.asarray(toks))
            full = _f32(_REF["logits_fn"](p, jcfg, h))
            logits, cache = _REF["prefill"](
                p, jcfg, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                max_len=MAX_LEN)
            steps = [_f32(logits)]
            for t in range(PROMPT, PROMPT + STEPS):
                logits, cache = _REF["decode_step"](
                    p, jcfg, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
                steps.append(_f32(logits))
            out[name, dt] = {"cfg": cfg, "tokens": toks, "full": full,
                             "aux": float(aux), "steps": steps, "cache": jax.tree.map(np.asarray, cache)}
    return out


def _close(got: torch.Tensor, want: np.ndarray, tol: float):
    ok, err, bound = compare(got.float(), torch.from_numpy(np.array(want)),
                            tol=(tol, tol))
    assert ok, (err, bound)


def _prefill_decode(params, cfg, toks):
    """The port's prefill and STEPS decode steps; their logits and the
    final cache."""
    logits, cache = lm.prefill(params, cfg,
                               {"tokens": torch.from_numpy(toks[:, :PROMPT])},
                               max_len=MAX_LEN)
    steps = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = lm.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        steps.append(logits)
    return steps, cache
