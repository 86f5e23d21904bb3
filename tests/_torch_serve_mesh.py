"""The port's serving on a mesh against the reference's sharded serve, for
tests/test_torch_serve_mesh.py, test_torch_moe_mesh.py and
test_torch_serve_mesh_{zamba2,whisper,xlstm}.py (pytest does not collect
this module).

Both sides serve one smoke arch from the same parameters (the
reference's ``materialize``, carried across in an ``.npz``) on the same
mesh shapes over four ranks:

* the reference: :func:`reference`, run in a subprocess with four fake
  host devices (``XLA_FLAGS``), each mesh a plain
  ``jax.sharding.Mesh`` (``make_host_mesh`` builds ``Explicit`` axes on
  this jax, and its embedding gather raises: ROADMAP §3 item 4).  Its
  steps are the dry-run's: ``make_prefill_step`` and ``make_serve_step``
  jitted with the parameters on ``param_shardings(...,
  ensure_model_axis=True)``, the batch and the cache on the input
  profile, under ``use_mesh_context`` with the serving profiles and, for
  a decode whose cache is split by sequence, ``cache_seq_axis="model"``;
* the port: :func:`port_ranks` on four spawned gloo ranks
  (``tests/_torch_dist.py``), the same meshes as ``DeviceMesh``es, the
  parameters placed by the port's ``param_shardings`` and served by its
  steps on a mesh.

Each case is a prefill of ``BATCH x PROMPT`` then ``GEN`` decode steps:
greedy in f32 (the tokens are compared), fed fixed tokens in bf16 (so the
logits compare step by step).  The reference writes its logits, tokens
and every leaf of its final cache tree (``flat``'s paths: ``k``,
``layer_0/c``, ...); each port rank writes its logits, tokens, its
blocks of every final cache leaf with their indices, and the head count
of each SSD call it made (a Mamba2 mixer's width on the rank).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

BATCH, PROMPT, GEN = 4, 8, 4
MAX_LEN = PROMPT + GEN + 8          # the launcher's cache length (divides 4)
WORLD = 4
#: f32 and bf16 tolerances of the model slices (ROADMAP conventions)
TOL = {"f32": 2e-3, "bf16": 6e-2}
ROOT = Path(__file__).resolve().parents[1]


def _cfg_replace(cfg, dtype, impl):
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if impl is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               impl=impl))
    return cfg


def fixed_tokens(vocab: int) -> np.ndarray:
    """The tokens fed to the bf16 decode steps, ``(GEN, BATCH, 1)``."""
    return np.random.default_rng(7).integers(0, vocab, (GEN, BATCH, 1),
                                             dtype=np.int32)


def flat(tree, prefix="", leaf=np.asarray):
    """A tree of nested dicts as ``{"a/b": leaf(v)}``, keys in sorted
    order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def unflat(arrays) -> dict:
    tree: dict = {}
    for key, v in arrays.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# the reference, in a subprocess with four fake devices
# ---------------------------------------------------------------------------


def reference(name: str, impl, params_path: str, out_path: str,
              cases) -> None:
    import jax

    assert len(jax.devices()) == WORLD, jax.devices()
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_arch
    from repro.configs.base import ShapeSpec
    from repro.dist.sharding import (get_profile, param_shardings,
                                     use_mesh_context)
    # the dry-run module sets XLA_FLAGS on import: the backend is up already
    from repro.launch.dryrun import _input_profile, _kv_divisible

    params = jax.tree.map(jnp.asarray, unflat(dict(np.load(params_path))))
    out = {}
    for mesh_shape, dtype in cases:
        arch = get_arch(name, smoke=True)
        arch = dataclasses.replace(arch, cfg=_cfg_replace(
            arch.cfg, jnp.float32 if dtype == "f32" else jnp.bfloat16, impl))
        mesh = Mesh(np.array(jax.devices()).reshape(mesh_shape),
                    ("data", "model"))
        profile = get_profile(arch.profile)
        kv_div = _kv_divisible(arch, mesh)
        in_prof = _input_profile(arch, mesh, multi_pod=False,
                                 kv_divisible=kv_div,
                                 batch_axes=profile.activation_rules["batch"])
        pre_prof = dataclasses.replace(profile, activation_rules={
            **profile.activation_rules, "seq": "model"})
        dec_prof = profile if kv_div else dataclasses.replace(
            profile, activation_rules={**profile.activation_rules,
                                       "heads": None})
        params_sh = param_shardings(arch.param_spec(), mesh, profile,
                                    ensure_model_axis=True)
        cache_sh = param_shardings(arch.cache_spec(BATCH, MAX_LEN), mesh,
                                   in_prof)
        shape = ShapeSpec("cli_prefill", PROMPT, BATCH, "prefill")
        batch = {k: jnp.asarray(v) for k, v in arch.make_batch(shape).items()}
        batch_sh = param_shardings(arch.batch_spec(shape), mesh, in_prof)
        tok_sh = param_shardings(
            arch.batch_spec(ShapeSpec("d", PROMPT, BATCH, "decode")), mesh,
            in_prof)
        from repro.train.steps import make_prefill_step, make_serve_step

        with use_mesh_context(mesh, pre_prof):
            prefill = jax.jit(make_prefill_step(arch, max_len=MAX_LEN),
                              in_shardings=(params_sh, batch_sh),
                              out_shardings=(None, cache_sh))
            logits, cache = prefill(params, batch)
        tag = f"{mesh_shape[0]}x{mesh_shape[1]}_{dtype}"
        out[f"{tag}/prefill"] = np.asarray(logits.astype(jnp.float32))
        fixed = fixed_tokens(arch.cfg.vocab)
        tok = jnp.argmax(logits[:, -1, :arch.cfg.vocab], -1)[:, None]
        with use_mesh_context(mesh, dec_prof,
                              cache_seq_axis=None if kv_div else "model"):
            step = jax.jit(make_serve_step(arch),
                           in_shardings=(params_sh, cache_sh, tok_sh),
                           out_shardings=(None, cache_sh))
            toks = []
            for i in range(GEN):
                fed = tok if dtype == "f32" else jnp.asarray(fixed[i])
                logits, cache = step(params, cache,
                                     {"tokens": fed.astype(jnp.int32)})
                out[f"{tag}/step{i}"] = np.asarray(logits.astype(jnp.float32))
                tok = jnp.argmax(logits[:, -1, :arch.cfg.vocab], -1)[:, None]
                toks.append(np.asarray(tok[:, 0]))
        out[f"{tag}/tokens"] = np.stack(toks, 1)
        leaves = flat(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                                   {k: v for k, v in cache.items()
                                    if k != "length"}))
        for key, v in leaves.items():
            out[f"{tag}/cache/{key}"] = v
        out[f"{tag}/length"] = np.asarray(cache["length"])
    np.savez(out_path, **out)


def start_reference(name: str, impl, params_path, out_path, cases,
                    timeout: float):
    """The reference in a subprocess with ``WORLD`` fake host devices."""
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                          str(ROOT / "tests")]),
           "PATH": os.environ.get("PATH", ""), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={WORLD}",
           "OMP_NUM_THREADS": "1"}
    code = ("import _torch_serve_mesh as m, json, sys; "
            "m.reference(*json.loads(sys.argv[1]))")
    args = json.dumps([name, impl, str(params_path), str(out_path),
                       [[list(s), d] for s, d in cases]])
    return subprocess.Popen([sys.executable, "-c", code, args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), timeout


def finish(proc_and_timeout) -> None:
    proc, timeout = proc_and_timeout
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]


# ---------------------------------------------------------------------------
# the port, on spawned gloo ranks
# ---------------------------------------------------------------------------


def port_ranks(rank: int, name: str, impl, params_path: str, out: str,
               cases) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.collectives import LocalBlock
    from repro_torch.dist.sharding import (get_profile, input_profile,
                                           kv_divisible, param_shardings,
                                           serving_profile, use_mesh_context)
    from repro_torch.models import mamba2
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    full = params_from_numpy(unflat(dict(np.load(params_path))), device="cpu")
    ssd, ssd_heads = mamba2._ssd_chunked, []

    def counted_ssd(cfg, x, *args):
        ssd_heads.append(x.shape[2])
        return ssd(cfg, x, *args)
    mamba2._ssd_chunked = counted_ssd
    res = {}
    for mesh_shape, dtype in cases:
        mesh_shape = tuple(mesh_shape)
        arch = get_arch(name, smoke=True)
        arch = dataclasses.replace(arch, cfg=_cfg_replace(
            arch.cfg, torch.float32 if dtype == "f32" else torch.bfloat16,
            impl))
        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        profile = get_profile(arch.profile)
        kv_div = kv_divisible(arch.cfg, mesh)
        in_prof = input_profile(multi_pod=False, kv_divisible=kv_div,
                                batch_axes=profile.activation_rules["batch"])
        psh = param_shardings(arch.param_spec(), mesh, profile,
                              ensure_model_axis=True)
        placed = iter([sh.distribute(t) for t, sh in
                       zip(tree_leaves(full), tree_leaves(psh))])
        params = tree_map(lambda _: next(placed), full)
        shape = ShapeSpec("cli_prefill", PROMPT, BATCH, "prefill")
        bsh = param_shardings(arch.batch_spec(shape), mesh, in_prof)
        batch = {k: bsh[k].distribute(torch.as_tensor(v))
                 for k, v in arch.make_batch(shape).items()}
        with use_mesh_context(mesh, serving_profile(profile, "prefill",
                                                    kv_divisible=kv_div)):
            logits, cache = make_prefill_step(
                arch, max_len=MAX_LEN, cache_profile=in_prof)(params, batch)
        tag = f"{mesh_shape[0]}x{mesh_shape[1]}_{dtype}"
        res[f"{tag}/prefill"] = logits.float().numpy()
        tsh = bsh["tokens"]
        fixed = fixed_tokens(arch.cfg.vocab)
        tok = logits[:, -1, :arch.cfg.vocab].argmax(-1)[:, None]
        step = make_serve_step(arch)
        toks = []
        with use_mesh_context(mesh, serving_profile(profile, "decode",
                                                    kv_divisible=kv_div),
                              cache_seq_axis=None if kv_div else "model"):
            for i in range(GEN):
                fed = tok if dtype == "f32" else torch.as_tensor(fixed[i])
                rows = fed[tsh.index(mesh.get_coordinate(), fed.shape)[0]]
                logits, cache = step(params, cache, {"tokens": rows})
                res[f"{tag}/step{i}"] = logits.float().numpy()
                tok = logits[:, -1, :arch.cfg.vocab].argmax(-1)[:, None]
                toks.append(tok[:, 0].numpy())
        res[f"{tag}/tokens"] = np.stack(toks, 1)
        leaves = flat(tree_map(LocalBlock.of, {k: v for k, v in cache.items()
                                               if k != "length"}),
                      leaf=lambda b: b)
        for key, blk in leaves.items():
            res[f"{tag}/cache/{key}"] = blk.tensor.float().numpy()
            res[f"{tag}/cache_index/{key}"] = np.array(
                [[s.start, s.stop] for s in blk.index])
        res[f"{tag}/length"] = np.asarray(cache["length"])
        res[f"{tag}/ssd_heads"] = np.array(ssd_heads, dtype=np.int64)
        ssd_heads.clear()
    np.savez(f"{out}/rank{rank}.npz", **res)


#: the archs of the one-rank check: (name, MoE impl)
ONE_RANK = (("internlm2-1.8b", None), ("granite-moe-1b-a400m", "shard_map"),
            ("qwen1.5-110b", None), ("pixtral-12b", None))


def _cache_leaves(cache) -> list:
    """A served cache's leaves but its length, whole tensors, in tree
    order."""
    from repro_torch.models.common import tree_leaves

    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for t in tree_leaves({k: v for k, v in cache.items()
                                  if k != "length"})]


def one_rank(rank: int, out: str, archs=ONE_RANK) -> None:
    """On a one-rank ``(1, 1)`` gloo mesh: each of ``archs`` served through
    ``launch/serve.py`` ``serve`` with and without the mesh, f32 and bf16;
    writes whether the logits, tokens and caches (every leaf) are
    bit-equal."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    from repro_torch.models.common import materialize

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    res = {}
    for name, impl in archs:
        for dtype in (torch.float32, torch.bfloat16):
            arch = get_arch(name, smoke=True)
            arch = dataclasses.replace(arch, cfg=_cfg_replace(arch.cfg, dtype,
                                                              impl))
            params = materialize(arch.param_spec(),
                                 torch.Generator().manual_seed(0), device="cpu")
            runs = [serve(arch, params, batch=BATCH, prompt_len=PROMPT,
                          gen=GEN, mesh=m) for m in (None, mesh)]
            a, b = runs
            res[f"{name} {dtype}"] = {
                "logits": all(torch.equal(x, y) for x, y in zip(
                    [a.prefill_logits, *a.step_logits],
                    [b.prefill_logits, *b.step_logits])),
                "tokens": torch.equal(a.tokens, b.tokens),
                "cache": all(torch.equal(x, y) for x, y in zip(
                    _cache_leaves(a.cache), _cache_leaves(b.cache), strict=True)),
                "length": a.cache["length"] == b.cache["length"]}
    with open(f"{out}/one_rank.json", "w") as f:
        json.dump(res, f)


def run(name: str, impl, cases, tmp_path, *, timeout: float = 110.0):
    """Both sides on ``cases`` (``[((data, model), dtype), ...]``): the
    reference's results and each port rank's."""
    import jax

    from repro.configs import get_arch as ref_arch
    from repro.models.common import materialize
    from _torch_dist import spawn

    params_path = tmp_path / "params.npz"
    np.savez(params_path, **flat(jax.tree.map(
        np.asarray, materialize(ref_arch(name, smoke=True).param_spec(),
                                jax.random.key(0)))))
    ref_out = tmp_path / "reference.npz"
    proc = start_reference(name, impl, params_path, ref_out, cases, timeout)
    try:
        spawn(port_ranks, WORLD, tmp_path, name, impl, str(params_path),
              str(tmp_path), cases, timeout=timeout)
    finally:
        finish(proc)
    ref = dict(np.load(ref_out))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
    return ref, ranks


def _close(got: np.ndarray, want: np.ndarray, tol: float, where) -> None:
    """The repo's NaN-safe check at ``(rtol, atol) = (tol, tol)``, as the
    model slices compare (``tests/_torch_lm.py``)."""
    import torch

    from repro_torch.kernels.check import compare as check

    assert got.shape == want.shape, (where, got.shape, want.shape)
    ok, err, bound = check(torch.from_numpy(got), torch.from_numpy(want),
                           tol=(tol, tol))
    assert ok, (where, err, bound)


def compare(ref: dict, ranks: list, cases) -> None:
    """Every rank's logits, tokens and cache blocks against the
    reference's."""
    for mesh_shape, dtype in cases:
        tag = f"{mesh_shape[0]}x{mesh_shape[1]}_{dtype}"
        tol = TOL[dtype]
        for r, got in enumerate(ranks):
            where = f"{tag} rank {r}"
            for key in ["prefill"] + [f"step{i}" for i in range(GEN)]:
                _close(got[f"{tag}/{key}"], ref[f"{tag}/{key}"], tol,
                       (where, key))
            if dtype == "f32":
                assert (got[f"{tag}/tokens"] == ref[f"{tag}/tokens"]).all(), \
                    where
            assert int(got[f"{tag}/length"]) == int(ref[f"{tag}/length"])
            leaves = [k.split("/cache/", 1)[1] for k in ref
                      if k.startswith(f"{tag}/cache/")]
            assert leaves and sorted(leaves) == sorted(
                k.split("/cache/", 1)[1] for k in got
                if k.startswith(f"{tag}/cache/")), (where, leaves)
            for k in leaves:
                idx = tuple(slice(a, b) for a, b in
                            got[f"{tag}/cache_index/{k}"])
                _close(got[f"{tag}/cache/{k}"], ref[f"{tag}/cache/{k}"][idx],
                       tol, (where, k))
