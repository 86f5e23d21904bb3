"""The port's multi-card parallelism model (``repro_torch.core.mesh``), the
mesh axis of ``core/autotune.py`` ``rank`` and ``core/scaling.py``
``gpu_dp_scaling`` against the reference's ``repro.core.mesh``,
``repro.core.autotune`` and ``repro.core.scaling``.

* ``plan_candidates``' plans equal the reference's, and for each of them
  ``plan_collectives``' link / network / floor tuples (the reference's
  ``ici`` / ``dcn`` / ``floor``) and ``plan_memory_bytes`` bit for bit,
  for internlm2-1.8b, glm4-9b and granite-moe-1b-a400m at 8, 16 and 64
  cards, one pod and two, train, prefill and decode: the op walk is the
  reference's.
* ``plan_scaling``, ``dp_scaling`` and ``gpu_dp_scaling`` equal the
  reference's float for float on a machine carrying ``TPU_V5E``'s rates.
* ``rank(config, machine, mesh=n)`` and its dict form equal
  ``rank_meshes``; fitting plans sort first; stray keywords without
  ``mesh=`` raise the reference's ``TypeError``.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import autotune as RA  # noqa: E402
from repro.core import hlo as RH  # noqa: E402
from repro.core import mesh as RM  # noqa: E402
from repro.core import scaling as RS  # noqa: E402
from repro.core.machine import TPU_V5E  # noqa: E402
from repro_torch.core import gpu_dp_scaling  # noqa: E402
from repro_torch.core import hlo as H  # noqa: E402
from repro_torch.core import mesh as M  # noqa: E402
from repro_torch.core.autotune import rank  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402

CONFIGS = ("internlm2-1.8b", "glm4-9b", "granite-moe-1b-a400m")
PHASES = {"train": dict(batch=8, seq_len=2048),
          "prefill": dict(batch=8, seq_len=2048),
          "decode": dict(batch=8, seq_len=1, context=4096)}
#: the reference TPU's rates on a port machine: its bf16 peak, its HBM,
#: its ICI links per chip as NVLink (``predict_plan`` and ``plan_scaling``
#: price ``ici_link_bytes_per_s * ici_links_per_chip``), its DCN, its
#: exposed fractions and its HBM capacity
TPU_RATES = dataclasses.replace(
    H100_SXM, peak_bf16_tensor_flops=TPU_V5E.peak_bf16_flops,
    hbm_bytes_per_s=TPU_V5E.hbm_bytes_per_s,
    nvlink_bytes_per_s=TPU_V5E.ici_link_bytes_per_s
    * TPU_V5E.ici_links_per_chip,
    net_bytes_per_s=TPU_V5E.dcn_bytes_per_s,
    exposed_link_fraction=TPU_V5E.exposed_ici_fraction,
    exposed_hbm_fraction=TPU_V5E.exposed_hbm_fraction,
    memory_bytes=TPU_V5E.hbm_bytes)


def _ops(colls) -> list[tuple]:
    return [(c.kind, c.out_bytes, c.group_size) for c in colls]


def _plan(p) -> tuple:
    return (p.data, p.model, p.pipe, p.pods, p.profile, p.microbatches,
            p.label, p.bubble_fraction, p.pipeline_scale)


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("n", [8, 16, 64])
def test_plan_candidates_equal_reference(n, pods):
    ours = M.plan_candidates(n, pods=pods)
    assert [_plan(p) for p in ours] == \
        [_plan(p) for p in RM.plan_candidates(n, pods=pods)]
    assert all(p.n_chips == n for p in ours)


@pytest.mark.parametrize("phase", sorted(PHASES))
@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("n", [8, 16, 64])
@pytest.mark.parametrize("config", CONFIGS)
def test_plan_collectives_and_memory_equal_reference(config, n, pods, phase):
    kw = PHASES[phase]
    for plan in M.plan_candidates(n, pods=pods):
        ref_plan = RM.MeshPlan(**dataclasses.asdict(plan))
        ours = M.plan_collectives(config, plan, phase=phase, **kw)
        ref = RM.plan_collectives(config, ref_plan, phase=phase, **kw)
        assert _ops(ours.link) == _ops(ref.ici), plan
        assert _ops(ours.net) == _ops(ref.dcn), plan
        assert _ops(ours.floor) == _ops(ref.floor), plan
        assert ours.link_wire_bytes_per_chip == ref.ici_wire_bytes_per_chip
        assert ours.net_wire_bytes_per_chip == ref.dcn_wire_bytes_per_chip
        assert ours.floor_bytes == ref.floor_bytes
        assert M.plan_memory_bytes(config, plan, phase=phase, **kw) == \
            RM.plan_memory_bytes(config, ref_plan, phase=phase, **kw)


def _resources(collectives):
    ops = [("all-reduce", 4.0e9, 1), ("all-gather", 1.5e9, 8),
           ("reduce-scatter", 1.5e9, 8), ("collective-permute", 2.0e8, 2),
           ("all-to-all", 3.0e8, 4)][:collectives]
    ours = H.HLOResources(flops=6.0e15, bytes_accessed=4.0e12,
                          collectives=[H.CollectiveOp(*o) for o in ops])
    ref = RH.HLOResources(flops=6.0e15, bytes_accessed=4.0e12,
                          collectives=[RH.CollectiveOp(*o) for o in ops])
    return ours, ref


def _renamed(d: dict) -> dict:
    return {k.replace("t_ici", "t_link"): v for k, v in d.items()}


@pytest.mark.parametrize("collectives", [0, 1, 5])
def test_plan_scaling_equals_reference(collectives):
    ours, ref = _resources(collectives)
    plans = [dict(data=1), dict(data=4), dict(data=4, model=2),
             dict(data=2, pipe=4, microbatches=8), dict(data=8, pods=2),
             dict(data=64)]
    got = M.plan_scaling(ours, [M.MeshPlan(**p) for p in plans],
                         machine=TPU_RATES)
    want = RM.plan_scaling(ref, [RM.MeshPlan(**p) for p in plans],
                           machine=TPU_V5E)
    assert got == _renamed(want)
    half = M.plan_scaling(ours, [M.MeshPlan(**p) for p in plans],
                          machine=TPU_RATES, exposed_link_fraction=0.5,
                          dtype_peak=1e14)
    assert half == _renamed(RM.plan_scaling(
        ref, [RM.MeshPlan(**p) for p in plans], machine=TPU_V5E,
        exposed_ici_fraction=0.5, dtype_peak=1e14))


@pytest.mark.parametrize("collectives", [0, 1, 5])
def test_dp_scaling_equals_reference(collectives):
    ours, ref = _resources(collectives)
    want = _renamed(RS.tpu_dp_scaling(ref, machine=TPU_V5E))
    assert M.dp_scaling(ours, machine=TPU_RATES) == want
    assert gpu_dp_scaling(ours, machine=TPU_RATES) == want
    assert gpu_dp_scaling(ours, chip_counts=(1, 4, 16), machine=TPU_RATES,
                          exposed_link_fraction=0.5) == \
        _renamed(RM.dp_scaling(ref, chip_counts=(1, 4, 16), machine=TPU_V5E,
                               exposed_ici_fraction=0.5))
    # the default machine is the card's data sheet
    assert gpu_dp_scaling(ours) == M.dp_scaling(ours, machine=H100_SXM)


MESH_KW = dict(batch=8, seq_len=2048)


@pytest.mark.parametrize("config", CONFIGS)
def test_rank_facade_equals_rank_meshes(config):
    for n in (8, 64):
        direct = M.rank_meshes(config, n, H100_SXM, **MESH_KW)
        assert rank(config, H100_SXM, mesh=n, **MESH_KW) == direct
        assert rank(config, mesh=n, **MESH_KW) == direct
        assert rank(config, H100_SXM, mesh={"n_chips": n, **MESH_KW}) == \
            direct
        assert rank(config, H100_SXM, mesh=n, top=2, **MESH_KW) == direct[:2]
        fits = [r["fits_hbm"] for r in direct]
        assert fits == sorted(fits, reverse=True)
        w = direct[0]
        assert w["fits_hbm"] and w["data"] * w["model"] * w["pipe"] == n
        # the attention block is a compiled tiling of the tile route
        assert w["block"] in {(128, 64), (128, 128)}
        assert all(r["t_step_us"] > 0 for r in direct)


def test_rank_meshes_orders_as_the_reference_on_its_rates():
    """Fitting plans first, then by step time, then label: the order of
    the reference's rows wherever the two models price a step alike
    (the capacity term is the card's ``memory_bytes``)."""
    rows = M.rank_meshes("glm4-9b", 16, TPU_RATES, include_blocks=False,
                         **MESH_KW)
    keys = [(not r["fits_hbm"], r["t_step_us"], r["mesh"], r["profile"])
            for r in rows]
    assert keys == sorted(keys)
    ref = RM.rank_meshes("glm4-9b", 16, "tpu-v5e", include_blocks=False,
                         **MESH_KW)
    assert {(r["mesh"], r["profile"]) for r in rows} == \
        {(r["mesh"], r["profile"]) for r in ref}
    assert [r["hbm_bytes_per_chip"] for r in sorted(
        rows, key=lambda r: (r["mesh"], r["profile"]))] == \
        [r["hbm_bytes_per_chip"] for r in sorted(
            ref, key=lambda r: (r["mesh"], r["profile"]))]


def test_rank_refuses_stray_keywords_without_mesh():
    with pytest.raises(TypeError, match="without mesh="):
        rank((4096, 4096, 4096), H100_SXM, objective="matmul",
             include_blocks=False)
    with pytest.raises(TypeError, match="without mesh="):
        RA.rank((4096, 4096, 4096), "haswell-ep", objective="matmul",
                include_blocks=False)


def test_predict_plan_keys_and_fabrics():
    plan = M.MeshPlan(data=8, model=2, pods=2)
    row = M.predict_plan("internlm2-1.8b", plan, H100_SXM, **MESH_KW)
    colls = M.plan_collectives("internlm2-1.8b", plan, **MESH_KW)
    assert colls.net and colls.link
    assert row["t_link_us"] == pytest.approx(
        colls.link_wire_bytes_per_chip / 450e9 * 1e6)
    assert row["t_net_us"] == pytest.approx(
        colls.net_wire_bytes_per_chip / 50e9 * 1e6)
    assert row["n_chips"] == 32 and row["mesh"] == "2podxdp8xtp2"
    assert row["fits_hbm"] == (row["hbm_bytes_per_chip"]
                               <= H100_SXM.memory_bytes)
