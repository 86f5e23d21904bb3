"""The port's compute-bound model against the reference's
(``repro/core/workload.py``, ``repro/core/autotune.py``): the traffic laws
of ``MatmulWorkload`` and ``AttentionWorkload`` in bytes at one cache
level, equal to the reference's line counts on a stand-in machine whose
one capacity is the H100's L2; ``kv_fraction`` against the reference's
and against the kernel's own skip rule; the ranking; the GPU step models
at the full-size points."""
import dataclasses
import inspect
import itertools
import types

import pytest

torch = pytest.importorskip("torch")

from repro.core import workload as JW  # noqa: E402
from repro_torch.benchmarks import gpu_compute_ecm as GC  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.autotune import rank  # noqa: E402
from repro_torch.core.gpu_ecm import gpu_attention_ecm, gpu_matmul_ecm  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.kernels.attention import kernel as AK  # noqa: E402
from repro_torch.kernels.attention import ops as AO  # noqa: E402
from repro_torch.kernels.matmul import kernel as MK  # noqa: E402
from repro_torch.kernels.matmul import ops as MO  # noqa: E402

L2 = H100_SXM.l2_bytes
#: the reference's machine as its traffic laws read it: one capacity, the
#: card's L2, and memory behind it
STAND_IN = types.SimpleNamespace(name="h100-l2", capacities=(L2,), levels=())

#: (m, n, k, bm, bn) on both sides of each condition: the A panel
#: (bm * k * 4 * 2 <= 50 MiB: k <= 51200 at bm 128) and all of B
#: (k * n * 4 * 2: fits at 2048^2, not at 4096^2), the boundaries included
MATMUL_CASES = [(4096, 4096, 4096, 128, 128), (4096, 4096, 4096, 64, 64),
                (2048, 2048, 2048, 128, 64), (1024, 1024, 1024, 64, 128),
                (256, 256, 65536, 128, 128), (256, 256, 51200, 128, 128),
                (256, 256, 51328, 128, 64), (64, 128, 102400, 64, 64)]
#: (sq, skv, d, bq, bkv) across the KV condition (2 * skv * d * 4 * 2 <=
#: 50 MiB: skv <= 25600 at d 128), causal and not
ATTENTION_CASES = [(4096, 4096, 128, 128, 128), (4096, 4096, 128, 64, 64),
                   (1, 4096, 128, 1, 256), (32768, 32768, 128, 128, 64),
                   (25600, 25600, 128, 128, 128), (26624, 26624, 128, 64, 128),
                   (8192, 65536, 64, 128, 128), (256, 256, 64, 64, 128)]


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("case", MATMUL_CASES, ids=str)
def test_matmul_traffic_equals_reference(case, eb):
    m, n, k, bm, bn = case
    spec = dataclasses.replace(JW.MATMUL_F32, elem_bytes=eb)
    want = JW.MatmulWorkload(spec, m=m, n=n, k=k, bm=bm, bn=bn).traffic(STAND_IN)
    got = W.MatmulWorkload(m, n, k, bm, bn, eb).traffic(L2)
    c_bytes = m * n * eb      # the reference counts lines per line of C
    assert got.read == pytest.approx(float(want.loads[0, 0]) * c_bytes, rel=1e-12)
    assert got.write == want.evicts * c_bytes
    assert want.rfo == 1.0    # the reference's write-allocate, not modelled here


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", ATTENTION_CASES, ids=str)
def test_attention_traffic_and_kv_fraction_equal_reference(case, causal):
    sq, skv, d, bq, bkv = case
    ref = JW.AttentionWorkload(JW.FLASH_ATTENTION_F32, sq=sq, skv=skv, d=d,
                               bq=bq, bkv=bkv, causal=causal)
    port = W.AttentionWorkload(sq, skv, d, bq, bkv, causal)
    assert port.kv_fraction() == ref.kv_fraction()
    want = ref.traffic(STAND_IN)
    got = port.traffic(L2)
    o_bytes = sq * d * 4      # the reference counts lines per line of O
    assert got.read == pytest.approx(float(want.loads[0, 0]) * o_bytes, rel=1e-12)
    assert got.write == want.evicts * o_bytes


def test_work_counts_equal_reference():
    """2mnk for the product; per visited score 4d for the two products and
    the reference's softmax count, exp_mul + exp_add + 2."""
    spec = JW.FLASH_ATTENTION_F32
    assert W.SOFTMAX_FLOPS_PER_SCORE == spec.exp_mul_uops + spec.exp_add_uops + 2
    assert W.COMPUTE_LC_SAFETY == JW.COMPUTE_LC_SAFETY
    mm = JW.MatmulWorkload(JW.MATMUL_F32, m=256, n=512, k=1024)
    assert W.MatmulWorkload(256, 512, 1024, 128, 128).flops == \
        mm.work_per_elem()[0] * 256 * 512
    port = W.AttentionWorkload(4096, 4096, 128, 128, 128, True)
    assert port.flops == 4096 * 4096 * 0.515625 * (4 * 128 + 10)


def test_fields_are_what_the_model_reads():
    """No uop mix, no CPU register tile, no bk: nothing in the port reads
    them."""
    names = lambda c: [f.name for f in dataclasses.fields(c)]  # noqa: E731
    assert names(W.MatmulWorkload) == ["m", "n", "k", "bm", "bn", "elem_bytes"]
    assert names(W.AttentionWorkload) == ["sq", "skv", "d", "bq", "bkv",
                                          "causal", "elem_bytes"]


@pytest.mark.parametrize("sq,bq,bkv", [(4096, 128, 128), (4096, 64, 64),
                                       (4096, 64, 128), (4096, 128, 64),
                                       (256, 64, 128), (1024, 1, 256)])
def test_kv_fraction_is_the_kernels_skip_rule(sq, bq, bkv):
    """The tiles the kernel visits under its skip rule (qi*bq + bq - 1 >=
    ki*bkv), counted, are the model's kv_fraction."""
    nq, nk = sq // bq, sq // bkv
    visited = sum(qi * bq + bq - 1 >= ki * bkv
                  for qi, ki in itertools.product(range(nq), range(nk)))
    w = W.AttentionWorkload(sq, sq, 128, bq, bkv, True)
    assert visited / (nq * nk) == w.kv_fraction()


def test_step_models_at_the_full_size_points():
    """The hand-reckoned figures: 2mnk at 67 TFLOP/s (2.051 ms); bf16's
    bound and model at 989 TFLOP/s (0.139 ms); the decode model's KV bytes,
    repeated per query head, at 3.35 TB/s (0.160 ms), and the decode
    kernel's bound, the bytes of the operands it receives, each KV head
    read once (0.080 ms); exact causal prefill work (1.026 ms)."""
    mm = gpu_matmul_ecm(MO.matmul_workload(4096, 4096, 4096), H100_SXM)
    assert mm.t_comp == pytest.approx(2.0513e-3, rel=1e-4)
    assert mm.t_ecm == mm.t_comp           # compute-bound: T_OL hides HBM
    bf = GC.bound(GC.POINTS["matmul_bf16"], H100_SXM)
    assert bf["bound_ms"] == pytest.approx(0.13897, rel=1e-4)
    assert bf["bound_by"] == "operations"
    # bf16 runs on the tensor cores (wgmma): its model's T_comp is the bound
    assert GC.model(GC.POINTS["matmul_bf16"], (128, 256, 64),
                    H100_SXM)["t_comp_ms"] == pytest.approx(0.13897, rel=1e-4)
    dec = gpu_attention_ecm(AO.attention_workload(1, 4096, 128, bq=1, bk=256,
                                                  causal=False),
                            H100_SXM, batch_heads=8 * 16)
    assert dec.t_hbm == pytest.approx(0.16030e-3, rel=1e-4)
    lim = GC.bound(GC.POINTS["attention_decode"], H100_SXM)
    assert lim["bound_ms"] == pytest.approx(0.080169, rel=1e-4)
    assert lim["bound_by"] == "bytes"
    assert lim["bound_ms"] == pytest.approx(dec.t_hbm * 1e3 / 2, rel=1e-3)
    pre = GC.bound(GC.POINTS["attention_prefill"], H100_SXM)
    assert pre["bound_ms"] == pytest.approx(4 * 4096 * 4097 / 2 * 128 * 16
                                            / 67e12 * 1e3)
    assert pre["bound_by"] == "operations"
    assert GC.bound(GC.POINTS["matmul"], H100_SXM)["bound_ms"] == \
        pytest.approx(mm.t_comp * 1e3)


def _keys_sorted(ranked):
    keys = [(r["t_ecm"], -r["block"][0] * r["block"][1]) for r in ranked]
    return keys == sorted(keys)


def test_rank_matmul():
    """Each route ranks its own table.  f32: all twelve tilings are
    compute-bound at 4096^3 and tie: the largest tile first, then the
    kernel's table order (the deeper stage first).  bf16: the model is HBM-bound (B, 32 MiB, is
    re-read once per row block at the safety factor), so bm = 128 beats
    bm = 64, and the wider tile wins the tie."""
    ranked = rank((4096, 4096, 4096), H100_SXM, objective="matmul")
    assert [r["block"] for r in ranked[:2]] == [(128, 256, 32), (128, 256, 16)]
    assert sorted(r["block"] for r in ranked) == sorted(MK.TILINGS["ffma"])
    assert _keys_sorted(ranked)
    assert MO.tuned_blocks(4096, 4096, 4096) == ranked[0]["block"]
    bf = rank((4096, 4096, 4096), H100_SXM, objective="matmul", elem_bytes=2)
    assert [r["block"] for r in bf] == [(128, 256, 64), (128, 128, 64),
                                        (64, 128, 64)]
    assert sorted(r["block"] for r in bf) == sorted(MK.TILINGS["wgmma"])
    assert _keys_sorted(bf) and bf[0]["t_ecm"] < bf[-1]["t_ecm"]
    assert [r["smem_bytes"] for r in bf] == [
        MK.smem_bytes(*r["block"], torch.bfloat16) for r in bf]
    assert MO.tuned_blocks(4096, 4096, 4096, dtype=torch.bfloat16) == \
        bf[0]["block"]
    # the reference's (512, 384, 640): bn = 256 does not divide n
    assert {r["block"] for r in rank((512, 384, 640), H100_SXM,
                                     objective="matmul", elem_bytes=2)} == \
        {(64, 128, 64), (128, 128, 64)}
    # only tilings that divide: m = 192 leaves bm = 64, k = 48 leaves bk = 16
    small = rank((192, 256, 48), H100_SXM, objective="matmul")
    assert {r["block"] for r in small} == {(64, 64, 16), (64, 128, 16),
                                           (64, 256, 16)}
    # off the data sheet: a card with less shared memory loses the deep tiles
    tight = dataclasses.replace(H100_SXM, smem_per_block_optin=90_000)
    blocks = {r["block"] for r in rank((4096,) * 3, tight, objective="matmul")}
    assert blocks == set(MK.TILINGS["ffma"]) - {(128, 256, 32), (128, 128, 32),
                                                (64, 256, 32)}
    roomier = dataclasses.replace(H100_SXM, smem_per_block_optin=140_000)
    blocks = {r["block"] for r in rank((4096,) * 3, roomier, objective="matmul",
                                       elem_bytes=2)}
    assert blocks == set(MK.TILINGS["wgmma"]) - {(128, 256, 64)}
    with pytest.raises(ValueError, match="no compiled matmul tiling"):
        rank((4096,) * 3, tight, objective="matmul", elem_bytes=2)


def test_rank_breaks_ties_and_orders_by_the_model():
    """Where the model does not tie, t_ecm orders: at a long K neither B
    nor an A panel fits L2, and the 64 x 64 tiles re-stream both often
    enough to be HBM-bound."""
    ranked = rank((4096, 4096, 262144), H100_SXM, objective="matmul")
    assert _keys_sorted(ranked)
    assert ranked[0]["t_ecm"] < ranked[-1]["t_ecm"]
    assert ranked[-1]["block"][:2] == (64, 64)


def test_rank_attention():
    ranked = rank((4096, 4096, 128), H100_SXM, objective="attention")
    # causal: both prefill tiles visit the same scores (their larger block
    # is 128) and tie; the larger tile first, then the one-row tilings
    assert [r["block"] for r in ranked[:2]] == [(128, 128), (128, 64)]
    assert ranked[0]["t_ecm"] == ranked[1]["t_ecm"] < ranked[-1]["t_ecm"]
    assert _keys_sorted(ranked)
    assert sorted(r["block"] for r in ranked) == sorted(AK.TILINGS)
    assert AO.tuned_blocks(4096, 4096, 128) == (128, 128)
    assert AO.tuned_blocks(4096, 4096, 128, causal=False) == (128, 128)
    # decode: every tiling ties on bytes (each clamped to the one row);
    # the one-row tilings compute no masked rows, so they rank first
    dec = rank((1, 4096, 128), H100_SXM, objective="attention", causal=False)
    assert [r["block"] for r in dec][:2] == [(1, 256), (1, 128)]
    assert sorted(r["block"] for r in dec[2:]) == sorted(
        t for t in AK.TILINGS if t[0] > 1)
    assert len({r["t_ecm"] for r in dec}) == 1
    with pytest.raises(ValueError, match="no compiled"):
        rank((256, 256, 96), H100_SXM, objective="attention")
    with pytest.raises(ValueError, match="objective"):
        rank((256, 256, 64), H100_SXM, objective="stencil")


def test_rank_has_no_knob_without_a_caller():
    """rank's keywords are the objective, causal and the element size,
    which the ops' tuned_blocks and the compute loop set, and the mesh
    axis (``mesh`` and ``rank_meshes``' options), which the mesh model's
    callers set."""
    params = inspect.signature(rank).parameters
    assert list(params) == ["dims", "machine", "objective", "causal",
                            "elem_bytes", "mesh", "mesh_opts"]
    assert list(inspect.signature(MO.tuned_blocks).parameters) == \
        ["m", "n", "k", "dtype", "machine"]
    assert list(inspect.signature(AO.tuned_blocks).parameters) == \
        ["sq", "sk", "d", "causal", "machine"]
