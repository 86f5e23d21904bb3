"""The port's mesh on four spawned gloo ranks (tests/_torch_dist.py): a
``(2, 2)`` ``("data", "model")`` mesh and a ``(2, 1, 2)`` multi-pod mesh
from ``launch/mesh.py`` ``make_host_mesh``.  The ranks run every check
once (one spawn for the module) and write what they saw; each test reads
one property:

* ``data.shard_batch`` puts on each rank the rows of its block, and
  ``make_global_array`` calls ``host_fn`` for the rank's own index only;
* a tuple group ``("pod", "data")``: each rank holds the block
  ``NamedSharding.index`` gives its coordinate (JAX's block:
  tests/test_torch_sharding.py holds ``index`` against JAX);
* ``train.elastic``: ``shrink_mesh`` keeps the first half along ``data``
  and raises the reference's errors; ``remesh_state`` onto the shrunk
  mesh and back is bit-identical (as tests/test_elastic.py);
* ``ckpt``: a state saved on the mesh restores on one device, and one
  saved on one device restores onto the mesh's placements, the two
  checkpoints' files and manifests byte for byte the same.

The launcher's own refusals (``make_production_mesh`` on a world of the
wrong size) run in this process.
"""
import filecmp
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402

WORLD = 4
ARCH = "internlm2-1.8b"
SPEC_ROWS = {"rows": "data", "cols": "model", "pages": "data"}


def _elastic_spec():
    from repro_torch.models.common import ParamSpec

    return {"w": ParamSpec((16, 8), ("rows", "cols")),
            "kv": ParamSpec((8, 4, 4), ("pages", None, None)),
            "step": ParamSpec((), ())}


def _elastic_host():
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
            "kv": torch.from_numpy(rng.standard_normal((8, 4, 4)).astype(np.float32)),
            "step": torch.tensor(17.0)}


def _ranks(rank: int, out: str) -> None:
    from repro_torch.ckpt import restore_tree, save_tree
    from repro_torch.configs import get_arch
    from repro_torch.data import make_global_array, shard_batch
    from repro_torch.dist import NamedSharding, ShardingProfile, param_shardings
    from repro_torch.dist import get_profile
    from repro_torch.launch.mesh import make_host_mesh, mesh_axis_sizes
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_state, remesh_state, shrink_mesh, state_spec
    import torch.distributed as dist

    rec = {"rank": rank}
    mesh = make_host_mesh(model=2, device="cpu")
    rec["sizes"] = mesh_axis_sizes(mesh)
    rec["coord"] = mesh.get_coordinate()
    batch = {"tokens": np.arange(8 * 6, dtype=np.int32).reshape(8, 6),
             "mask": (np.arange(8 * 6).reshape(8, 6) % 5 > 0).astype(np.float32)}
    placed = shard_batch(batch, mesh, ("data",))
    rec["rows"] = placed["tokens"].to_local()[:, 0].tolist()
    rec["batch_whole"] = all(np.array_equal(placed[k].full_tensor().numpy(), v)
                             for k, v in batch.items())
    rec["mask_dtype"] = str(placed["mask"].dtype)
    calls = []

    def host_fn(idx):
        calls.append([[s.start, s.stop] for s in idx])
        return batch["tokens"][idx]

    arr = make_global_array(host_fn, batch["tokens"].shape, mesh,
                            (None, "model"), dtype=np.int64)
    rec["host_fn_calls"] = calls
    rec["global_array"] = (arr.dtype == torch.int64 and np.array_equal(
        arr.to_local().numpy(), batch["tokens"][tuple(
            NamedSharding(mesh, (None, "model")).index(rec["coord"], (8, 6)))]))

    pods = make_host_mesh(model=2, multi_pod=True, device="cpu")
    rec["pod_sizes"] = mesh_axis_sizes(pods)
    rec["pod_coord"] = pods.get_coordinate()
    rec["pod_rows"] = shard_batch(batch, pods, ("pod", "data"))[
        "tokens"].to_local()[:, 0].tolist()
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    tuple_group = NamedSharding(pods, (("pod", "data"), "model"))
    got = tuple_group.distribute(full).to_local()
    want = full[tuple_group.index(rec["pod_coord"], full.shape)]
    rec["tuple_group_block"] = bool(torch.equal(got, want))

    profile = ShardingProfile("t", rules=SPEC_ROWS)
    spec, host = _elastic_spec(), _elastic_host()
    state = {k: s.distribute(host[k]) for k, s in
             param_shardings(spec, mesh, profile).items()}
    small = shrink_mesh(mesh, "data")
    rec["small_sizes"] = mesh_axis_sizes(small)
    rec["small_ranks"] = small.mesh.reshape(-1).tolist()
    rec["small_coord"] = small.get_coordinate()
    restate = remesh_state(state, spec, small, profile)
    if small.get_coordinate() is None:
        rec["shrunk_equal"] = all(v.to_local().numel() == 0
                                  for v in restate.values())
    else:
        rec["shrunk_equal"] = all(
            torch.equal(restate[k].full_tensor(), host[k])
            and restate[k].device_mesh is small for k in host)
    back = remesh_state(restate, spec, mesh, profile)
    rec["back_equal"] = all(torch.equal(back[k].full_tensor(), host[k])
                            and torch.equal(back[k].to_local(),
                                            state[k].to_local())
                            for k in host)
    for axis, key in (("data", "shrink_again"), ("pod", "shrink_unknown")):
        try:
            shrink_mesh(small, axis)
        except ValueError as e:
            rec[key] = str(e)

    arch = get_arch(ARCH, smoke=True)
    opt = AdamWConfig(moment_dtype="int8")
    sspec = state_spec(arch, opt)
    whole = init_state(arch, torch.Generator().manual_seed(0), opt,
                       device="cpu")
    shardings = param_shardings(sspec, mesh, get_profile("tp_fsdp"))
    leaves = iter(tree_leaves(whole))
    sharded = tree_map(lambda s: s.distribute(next(leaves)), shardings)
    rec["sharded_leaves"] = sum(
        any(p.is_shard() for p in s.placements()) for s in tree_leaves(shardings))
    save_tree(os.path.join(out, "mesh"), 3, sharded, metadata={"on": "mesh"})
    if rank == 0:
        save_tree(os.path.join(out, "one"), 3, whole, metadata={"on": "mesh"})
    dist.barrier()
    one, meta = restore_tree(os.path.join(out, "mesh"), 3, sspec, device="cpu")
    rec["mesh_to_one_device"] = all(
        torch.equal(a, b) and a.dtype == b.dtype
        for a, b in zip(tree_leaves(one), tree_leaves(whole)))
    rec["metadata"] = meta
    onto, _ = restore_tree(os.path.join(out, "one"), 3, sspec,
                           shardings=shardings)
    rec["one_device_to_mesh"] = all(
        torch.equal(a.to_local(), b.to_local())
        and a.placements == b.placements
        for a, b in zip(tree_leaves(onto), tree_leaves(sharded)))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    spawn(_ranks, WORLD, out, str(out))
    recs = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            recs.append(json.load(f))
    return out, recs


def test_host_meshes(ranks):
    _, recs = ranks
    assert [r["coord"] for r in recs] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(r["sizes"] == {"data": 2, "model": 2} for r in recs)
    assert all(r["pod_sizes"] == {"pod": 2, "data": 1, "model": 2}
               for r in recs)
    assert [r["pod_coord"] for r in recs] == [[0, 0, 0], [0, 0, 1],
                                              [1, 0, 0], [1, 0, 1]]


def test_shard_batch_rows(ranks):
    _, recs = ranks
    for r in recs:
        data = r["coord"][0]
        assert r["rows"] == [6 * i for i in range(4 * data, 4 * data + 4)]
        pod = r["pod_coord"][0]
        assert r["pod_rows"] == [6 * i for i in range(4 * pod, 4 * pod + 4)]
        assert r["batch_whole"] and r["mask_dtype"] == "torch.float32"


def test_make_global_array_builds_own_block(ranks):
    _, recs = ranks
    for r in recs:
        model = r["coord"][1]
        assert r["host_fn_calls"] == [[[0, 8], [3 * model, 3 * model + 3]]]
        assert r["global_array"]


def test_tuple_group_block_order(ranks):
    _, recs = ranks
    assert all(r["tuple_group_block"] for r in recs)


def test_shrink_mesh(ranks):
    _, recs = ranks
    for r in recs:
        assert r["small_sizes"] == {"data": 1, "model": 2}
        assert r["small_ranks"] == [0, 1]
        assert r["small_coord"] == ([0, r["coord"][1]] if r["rank"] < 2
                                    else None)
        assert r["shrink_again"] == "cannot shrink axis data below 1"
        assert r["shrink_unknown"] == ("mesh has no axis 'pod' (axes: "
                                       "('data', 'model'))")


def test_remesh_there_and_back_bit_identical(ranks):
    _, recs = ranks
    assert all(r["shrunk_equal"] and r["back_equal"] for r in recs)


def test_checkpoints_move_between_mesh_and_one_device(ranks):
    out, recs = ranks
    assert all(r["mesh_to_one_device"] and r["one_device_to_mesh"]
               for r in recs)
    assert recs[0]["sharded_leaves"] > 0
    assert all(r["metadata"] == {"on": "mesh"} for r in recs)
    a, b = out / "mesh" / "step_00000003", out / "one" / "step_00000003"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and "manifest.json" in files
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


def test_production_mesh_refuses_other_worlds():
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="needs 256 ranks; the process "
                                         "group has 1"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks; the process "
                                         "group has 1"):
        make_production_mesh(multi_pod=True, device="cpu")
