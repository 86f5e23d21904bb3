"""The serving engine's KV page store on eight spawned gloo ranks
(tests/_torch_dist.py), the reference's real-mesh device-loss test
(``tests/test_serve.py`` ``test_device_loss_reshards_kv_store_bit_identical``)
on the port: on a ``(4, 2)`` ``("data", "model")`` mesh,
``ServeEngine.attach_kv_store`` places the pages and the page table as
DTensors over ``data``; two device losses
(``serve.faults.apply_device_loss``) take the data axis from 4 to 2 to
1, resharding the store through ``train.elastic`` each time; a third, on
a data axis of 1, is logical.  The pages stay bit-identical, and each
rank's local block is the one the new mesh's sharding gives it.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402

WORLD = 8
N_PAGES, PAGE_TOKENS = 16, 4


def _ranks(rank: int, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import param_shardings
    from repro_torch.serve import EngineConfig, ServeEngine
    from repro_torch.serve.faults import DeviceLoss, apply_device_loss

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    engine = ServeEngine(EngineConfig(n_devices=4))
    store = engine.attach_kv_store(mesh, n_pages=N_PAGES,
                                   page_tokens=PAGE_TOKENS)
    before = {k: v.full_tensor().clone() for k, v in store.items()}
    rec = {"rank": rank,
           "arange": bool(torch.equal(
               before["kv_pages"].flatten(),
               torch.arange(N_PAGES * PAGE_TOKENS * 128, dtype=torch.float32))
               and torch.equal(before["page_table"],
                               torch.arange(N_PAGES, dtype=torch.int32))),
           "placements": {k: [f"shard {p.dim}" if p.is_shard() else
                              "replicate" if p.is_replicate() else str(p)
                              for p in v.placements]
                          for k, v in store.items()},
           "steps": []}

    for step in range(3):
        apply_device_loss(engine, DeviceLoss(step=step, axis="data"))
        ev = engine.events("device_loss")[-1]
        new = engine.mesh
        coord = new.get_coordinate()
        seen = {"event": {k: ev[k] for k in ("resharded", "n_devices_before",
                                             "n_devices_after")},
                "shape": list(new.shape), "in_mesh": coord is not None}
        if coord is None:
            seen["empty"] = all(v.to_local().numel() == 0
                                for v in engine.kv_store.values())
        else:
            shardings = param_shardings(engine.kv_spec, new, engine.kv_profile)
            seen["equal"] = all(
                torch.equal(v.full_tensor(), before[k])
                and v.device_mesh is new
                and v.dtype == before[k].dtype
                for k, v in engine.kv_store.items())
            seen["own_block"] = all(
                torch.equal(v.to_local(), before[k][
                    shardings[k].index(coord, before[k].shape)])
                for k, v in engine.kv_store.items())
        rec["steps"].append(seen)
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(rec, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("kv")
    spawn(_ranks, WORLD, out, str(out))
    recs = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            recs.append(json.load(f))
    return recs


def test_store_is_the_references_aranges_over_data(ranks):
    for r in ranks:
        assert r["arange"]
        assert r["placements"] == {"kv_pages": ["shard 0", "replicate"],
                                   "page_table": ["shard 0", "replicate"]}


def test_two_losses_reshard_bit_identical(ranks):
    for r in ranks:
        first, second, _ = r["steps"]
        assert first["event"] == {"resharded": True, "n_devices_before": 4,
                                  "n_devices_after": 2}
        assert first["shape"] == [2, 2] and second["shape"] == [1, 2]
        assert second["event"] == {"resharded": True, "n_devices_before": 2,
                                   "n_devices_after": 1}
        for seen, members in ((first, 4), (second, 2)):
            assert seen["in_mesh"] == (r["rank"] < members)
            if seen["in_mesh"]:
                assert seen["equal"] and seen["own_block"]
            else:
                assert seen["empty"]


def test_a_loss_on_a_data_axis_of_one_is_logical(ranks):
    for r in ranks:
        third = r["steps"][2]
        assert third["event"] == {"resharded": False, "n_devices_before": 1,
                                  "n_devices_after": 1}
        assert third["shape"] == [1, 2]
        if r["rank"] < 2:
            assert third["equal"] and third["own_block"]
