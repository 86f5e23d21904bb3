"""The port's sharding rules (``repro_torch/dist/sharding.py``) against
the reference's (``repro/dist/sharding.py``).

* Every arch of the registry at full size (spec trees only, nothing
  materialized), its train state's specs at each moment dtype, under
  the four profiles in both pod modes, on meshes ``(1, 1)``, ``(2, 2)``,
  ``(4, 2)``, ``(16, 16)`` and ``(2, 16, 16)``, with and without
  ``ensure_model_axis``: the port's spec equals the reference's
  ``logical_to_pspec`` (and ``_ensure_model``) entry for entry.  Both
  read only a mesh's axis names and sizes, so each side gets a
  duck-typed mesh and no device is needed.
* The block each mesh coordinate holds (``NamedSharding.index``) equals
  JAX's ``NamedSharding.devices_indices_map`` on 8 host devices (in a
  subprocess: the device count is fixed before JAX starts), tuple groups
  in and out of mesh order; the DTensor placements refuse a tuple out of
  mesh order.
* tests/test_sharding.py's cases, restated on the port.
"""
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.dist import sharding as rsh  # noqa: E402
from repro.models.common import is_spec  # noqa: E402
from repro.optim import AdamWConfig as RefAdamW  # noqa: E402
from repro.train.steps import state_spec as ref_state_spec  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_arch  # noqa: E402
from repro_torch.dist import sharding as psh  # noqa: E402
from repro_torch.models.common import ParamSpec, tree_leaves  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.steps import state_spec  # noqa: E402

import jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (4, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
MOMENTS = ("f32", "bf16", "int8")


def _ref_mesh(shape, names):
    """What the reference's rules read of a mesh."""
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _mesh(shape, names):
    """What the port's rules read of a mesh."""
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _ref_pspec(spec, profile, mesh, ensure: bool):
    p = rsh.logical_to_pspec(spec.axes, profile.rules, spec.shape, mesh)
    if ensure:
        p = rsh._ensure_model(spec, p, rsh._axis_sizes(mesh), 1 << 16)
    return tuple(p)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_equal_reference_everywhere(name):
    compared = 0
    for moments in MOMENTS:
        ref = jax.tree.leaves(ref_state_spec(ref_arch(name),
                                             RefAdamW(moment_dtype=moments)),
                              is_leaf=is_spec)
        port = state_spec(get_arch(name), AdamWConfig(moment_dtype=moments))
        assert [tuple(s.shape) for s in ref] == [s.shape for s in
                                                 tree_leaves(port)]
        for prof in psh.profile_names():
            for multi_pod in (False, True):
                rprof = rsh.get_profile(prof, multi_pod=multi_pod)
                pprof = psh.get_profile(prof, multi_pod=multi_pod)
                for shape, names in MESHES.items():
                    rmesh, pmesh = _ref_mesh(shape, names), _mesh(shape, names)
                    for ensure in (False, True):
                        got = psh.param_shardings(port, pmesh, pprof,
                                                  ensure_model_axis=ensure)
                        want = [_ref_pspec(s, rprof, rmesh, ensure) for s in ref]
                        assert [g.spec for g in tree_leaves(got)] == want, (
                            moments, prof, multi_pod, shape, ensure)
                        compared += len(want)
    assert compared > 1000


def test_profiles_equal_reference():
    assert psh.profile_names() == rsh.profile_names()
    for name in psh.profile_names():
        for multi_pod in (False, True):
            got = psh.get_profile(name, multi_pod=multi_pod)
            want = rsh.get_profile(name, multi_pod=multi_pod)
            assert (got.name, got.rules, got.activation_rules) == (
                want.name, want.rules, want.activation_rules)
    with pytest.raises(KeyError, match="unknown sharding profile"):
        psh.get_profile("nope")


_JAX_BLOCKS = """
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import json
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

out = []
for shape, names, spec, dims in json.loads(os.environ['CASES']):
    mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(names))
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    got = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(dims))
    blocks = {}
    for dev, idx in got.items():
        coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
        blocks[json.dumps(coord)] = [[s.start or 0, s.stop or n]
                                     for s, n in zip(idx, dims)]
    out.append(blocks)
print(json.dumps(out))
"""

#: (mesh shape, axis names, spec, tensor shape): tuple groups in and
#: out of mesh order
BLOCK_CASES = [
    ((2, 2, 2), ("pod", "data", "model"), [["pod", "data"], None], (8, 3)),
    ((2, 2, 2), ("pod", "data", "model"), [["data", "pod"], "model"], (8, 4)),
    ((2, 1, 4), ("pod", "data", "model"), ["model", ["pod", "data"]], (8, 6)),
    ((2, 4), ("data", "model"), [None, ["model", "data"]], (2, 16)),
    ((2, 4), ("data", "model"), ["data", "model"], (4, 8)),
    ((4, 2), ("data", "model"), [["data", "model"]], (16,)),
]


def test_blocks_equal_jax_named_sharding():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "CASES": json.dumps(BLOCK_CASES)}
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKS], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    for (shape, names, spec, dims), want in zip(BLOCK_CASES,
                                                json.loads(r.stdout)):
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        sharding = psh.NamedSharding(_mesh(shape, names), spec)
        assert len(want) == int(np.prod(shape))
        for coord, block in want.items():
            got = sharding.index(json.loads(coord), dims)
            assert [[s.start, s.stop] for s in got] == block, (spec, coord)


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    got = psh.NamedSharding(mesh, (("pod", "data"), "model")).placements()
    assert got == (Shard(0), Shard(0), Shard(1))
    assert psh.NamedSharding(mesh, (None, "data")).placements() == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        psh.NamedSharding(mesh, (("data", "pod"), None)).placements()


# tests/test_sharding.py's cases on the port


def test_logical_to_pspec_basic():
    rules = {"embed": None, "mlp": "model", "batch": ("data",)}
    assert psh.logical_to_pspec(("embed", "mlp"), rules) == (None, "model")


def test_duplicate_mesh_axis_deduped():
    rules = {"embed": "model", "mlp": "model"}
    assert psh.logical_to_pspec(("embed", "mlp"), rules) == ("model", None)


def test_divisibility_fallback_replicates():
    mesh = _mesh((1, 2), ("data", "model"))
    rules = {"heads": "model"}
    assert psh.logical_to_pspec(("heads",), rules, (3,), mesh) == (None,)
    assert psh.logical_to_pspec(("heads",), rules, (4,), mesh) == ("model",)


def test_ensure_model_axis_fallback():
    mesh = _mesh((1, 2), ("data", "model"))
    prof = psh.ShardingProfile("t", rules={"heads": "model"})
    spec = {"wq": ParamSpec((4096, 3, 256), ("embed", "heads", "head_dim"))}
    sh = psh.param_shardings(spec, mesh, prof, ensure_model_axis=True,
                             min_elems=1 << 20)
    assert sh["wq"].spec == ("model", None, None)
    spec2 = {"w": ParamSpec((2048, 4096), ("layers", "embed"))}
    sh2 = psh.param_shardings(spec2, mesh, prof, ensure_model_axis=True,
                              min_elems=1 << 20)
    assert sh2["w"].spec == (None, "model")


def test_profiles_construct_both_modes():
    for name, fn in psh.PROFILES.items():
        for mp in (False, True):
            assert "batch" in fn(mp).activation_rules, name


def test_axis_sizes_two_pod_mesh():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    assert psh._axis_sizes(mesh) == {"pod": 2, "data": 2, "model": 2}
    assert psh._axis_sizes(None) == {}


def test_multi_pod_batch_spans_pod_and_data():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    prof = psh.get_profile("tp_dp", multi_pod=True)
    assert prof.activation_rules["batch"] == ("pod", "data")
    ps = psh.logical_to_pspec(("batch", "seq", "embed"),
                              prof.activation_rules, (8, 16, 32), mesh)
    assert ps == (("pod", "data"), None, None)
    assert psh.logical_to_pspec(("batch",), prof.activation_rules, (2,),
                                mesh) == ("pod",)


def test_param_shardings_two_pod_mesh():
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    spec = {"wq": ParamSpec((64, 8, 16), ("embed", "heads", "head_dim")),
            "emb": ParamSpec((128, 64), ("vocab", "embed"))}
    sh = psh.param_shardings(spec, mesh, psh.get_profile("tp_dp", multi_pod=True))
    assert sh["wq"].spec == (None, "model", None)
    assert sh["emb"].spec == ("model", None)
    sh = psh.param_shardings(spec, mesh,
                             psh.get_profile("tp_fsdp", multi_pod=True))
    assert sh["wq"].spec == ("data", "model", None)
    assert sh["emb"].spec == ("model", "data")


def test_register_profile_and_mesh_context():
    prof = psh.ShardingProfile("pinned", rules={"embed": "data"},
                               activation_rules={"batch": ("pod", "data")})
    psh.register_profile(prof, "pinned-alias")
    try:
        assert psh.get_profile("pinned-alias", multi_pod=True) is prof
        assert psh.current_context().mesh is None
        mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
        with psh.use_mesh_context(mesh, prof) as ctx:
            assert psh.current_mesh() is mesh
            assert ctx.data_axes == ("pod", "data")
            with psh.use_mesh_context(mesh, None, multi_pod=False) as inner:
                assert inner.data_axes == ("data",)
            assert psh.current_context() is ctx
        assert psh.current_context().mesh is None
    finally:
        psh.PROFILES.pop("pinned")
        psh._PROFILE_ALIASES.pop("pinned-alias")
