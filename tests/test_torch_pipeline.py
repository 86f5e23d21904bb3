"""Port pipeline: ops at depth 2 against the JAX reference's DMA pipeline
in interpret mode, and the host contract (block fitting, stage cap,
buffer budgets, launch geometry) against the reference's."""
import types

import pytest

torch = pytest.importorskip("torch")

from repro.kernels import pipeline as JP  # noqa: E402
from repro_torch.benchmarks.gpu_stream_ecm import pipeline_block  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.kernels import pipeline as P  # noqa: E402
from repro_torch.kernels.stream import ops  # noqa: E402
from test_torch_stream import S, T, check_against_reference  # noqa: E402


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("rows", [64, 33, 7])
def test_pipeline_ops_match_reference(rows, dt):
    check_against_reference(rows, dt, 2)


def test_fit_block_matches_reference():
    for rows in [1, 2, 7, 33, 64, 96, 128, 255, 512, 1000, 8192]:
        for block in [1, 2, 7, 8, 32, 64, 100]:
            assert P._fit_block(rows, block) == JP._fit_block(rows, block)


def test_stage_cap():
    """Depth is capped at the chunk count: max(1, min(num_stages, n))."""
    assert P.chunking(512, 64, 3) == (64, 8, 3)
    assert P.chunking(2, 2, 3) == (2, 1, 1)      # one chunk: serial
    assert P.chunking(7, 64, 2) == (7, 1, 1)     # prime rows: one block
    assert P.chunking(33, 32, 3) == (11, 3, 3)
    assert P.chunking(64, 32, 0) == (32, 2, 1)
    b = torch.arange(2 * 128, dtype=torch.float32)
    assert torch.equal(ops.copy(b, num_stages=3, block_rows=2), b)


def test_buffer_budgets():
    cfg = P.PipelineConfig(num_stages=3, block_rows=64)
    ref = JP.PipelineConfig(num_stages=3, block_rows=64)
    for n, eb in [(1, 4), (3, 4), (4, 4), (2, 2)]:
        assert cfg.vmem_bytes(n, eb) == ref.vmem_bytes(n, eb)
    limit = H100_SXM.smem_per_block_optin
    with pytest.raises(ValueError, match="shared memory"):
        cfg.smem_bytes(3, limit=limit)           # 3 x 3 x 32 KiB
    assert P.PipelineConfig(3, 32).smem_bytes(3, limit=limit) == 3 * 3 * 16384
    assert pipeline_block(H100_SXM) == 32


def _map_smem(op, block_rows, depth, limit):
    """(output slots, shared memory) of the map pipeline for ``op``."""
    n_in = P.MAP_OPS[op][2]
    cfg = P.PipelineConfig(depth, block_rows)
    slots = cfg.map_out_slots(n_in, limit=limit)
    return slots, cfg.smem_bytes(n_in, limit=limit, out_slots=slots)


@pytest.mark.parametrize("op", list(P.MAP_OPS))
def test_map_ring_with_output_ring_fits(op):
    """Every map call the benchmark and the smoke test make still fits
    with the output ring counted: the benchmark's 32-row block at depths
    1-3 and the ops' default 64 rows at depths 1-2 (schoenauer at 64 rows
    and depth 2 with one output slot, 229,392 B of 232,448)."""
    limit = H100_SXM.smem_per_block_optin
    n_in = P.MAP_OPS[op][2]
    slot32, slot64 = 32 * 128 * 4, 64 * 128 * 4
    for depth in (1, 2, 3):
        slots, nbytes = _map_smem(op, 32, depth, limit)
        assert slots == (1 if n_in == 0 else 2)
        assert nbytes == (n_in * depth + slots) * slot32 + 8 * depth <= limit
    for depth in (1, 2):
        slots, nbytes = _map_smem(op, 64, depth, limit)
        want = 1 if n_in == 0 or (n_in, depth) == (3, 2) else 2
        assert slots == want
        assert nbytes == (n_in * depth + slots) * slot64 + 8 * depth <= limit
    assert _map_smem("schoenauer", 64, 2, limit) == (1, 229392)
    assert _map_smem("striad", 64, 3, limit) == (1, 229400)


def test_map_ring_over_shared_memory_raises():
    """A 64-row depth-3 schoenauer ring (288 KiB of input slots) raises,
    output ring or not; the block is never shrunk."""
    limit = H100_SXM.smem_per_block_optin
    cfg = P.PipelineConfig(3, 64)
    assert cfg.map_out_slots(3, limit=limit) == 1
    with pytest.raises(ValueError, match="1 output slot"):
        cfg.smem_bytes(3, limit=limit, out_slots=1)
    assert cfg.ring_bytes(3) == cfg.vmem_bytes(3) == 3 * 3 * 32768


def test_check_aligned():
    """A flat view at an odd element offset, reshaped as the ops reshape
    their streams, is refused; an offset of 16 bytes is not."""
    x = torch.zeros(8 + 128 * 64)
    assert x.data_ptr() % 16 == 0
    for offset, ok in ((0, True), (1, False), (2, False), (3, False),
                       (4, True)):
        view = ops._as2d(x[offset:offset + 128 * 64])
        if ok:
            P.check_aligned((view,))
        else:
            with pytest.raises(ValueError, match="16-byte boundary"):
                P.check_aligned((x[:128].view(1, 128), view))
    bf = torch.zeros(16 + 128 * 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte boundary"):
        P.check_aligned((bf[4:4 + 128 * 8],))     # 8 bytes in
    P.check_aligned((bf[8:8 + 128 * 8],))


def test_launch_plan(monkeypatch):
    """Launch geometry without a card: a persistent grid of
    min(n_chunks, SMs) CTAs for a reduction, an explicit ctas in range,
    the ring checked against the card's opt-in shared memory, and for a
    map op its output slots (0 for a reduction, which has no output
    ring) and its grid from the CTAs an SM holds."""
    props = types.SimpleNamespace(
        shared_memory_per_block_optin=H100_SXM.smem_per_block_optin,
        multi_processor_count=H100_SXM.sm_count)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
    seen = []

    def per_sm(code, dtype, *geometry):
        seen.append((code, dtype, *geometry))
        return 2

    monkeypatch.setattr(P, "map_ctas_per_sm", per_sm)
    kw = dict(dtype=torch.float32, device=torch.device("cpu"))
    assert P.plan(1 << 19, block_rows=32, num_stages=3, n_in=3, **kw) == \
        (32, 1 << 14, 3, 132, 0)
    assert P.plan(96, block_rows=32, num_stages=3, n_in=3, **kw) == \
        (32, 3, 3, 3, 0)
    assert P.plan(1 << 19, block_rows=32, num_stages=2, n_in=2, ctas=1,
                  map_op="striad", **kw) == (32, 1 << 14, 2, 1, 2)
    assert P.plan(512, block_rows=64, num_stages=2, n_in=3,
                  map_op="schoenauer", **kw) == (64, 8, 2, 8, 1)
    # the map pipeline's default grid: one CTA an SM, then up to SMs x the
    # CTAs an SM holds at the launch's geometry while each CTA still gets
    # as many chunks as its ring has slots
    assert P.plan(1 << 19, block_rows=32, num_stages=2, n_in=2,
                  map_op="striad", **kw) == (32, 1 << 14, 2, 264, 2)
    assert seen[-1] == (3, torch.float32, 32, 2, 2)
    assert P.plan(96, block_rows=32, num_stages=3, n_in=3,
                  map_op="schoenauer", **kw) == (32, 3, 3, 3, 2)
    assert P.plan(8192, block_rows=32, num_stages=2, n_in=2,
                  map_op="striad", **kw) == (32, 256, 2, 132, 2)
    assert P.plan(16384, block_rows=32, num_stages=2, n_in=2,
                  map_op="striad", **kw) == (32, 512, 2, 256, 2)
    assert P.plan(8192, block_rows=32, num_stages=1, n_in=2,
                  map_op="striad", **kw) == (32, 256, 1, 256, 2)
    with pytest.raises(ValueError, match="shared memory"):
        P.plan(512, block_rows=64, num_stages=3, n_in=3, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        P.plan(512, block_rows=64, num_stages=3, n_in=3, map_op="schoenauer",
               **kw)
    with pytest.raises(ValueError, match="ctas"):
        P.plan(96, block_rows=32, num_stages=2, n_in=1, ctas=4, **kw)
    # bf16 halves the ring: a 64-row depth-3 ring of 3 streams fits, with
    # two output slots (144 + 32 KiB)
    bf = dict(dtype=torch.bfloat16, device=torch.device("cpu"))
    assert P.plan(512, block_rows=64, num_stages=3, n_in=3, **bf) == \
        (64, 8, 3, 8, 0)
    assert P.plan(512, block_rows=64, num_stages=3, n_in=3,
                  map_op="schoenauer", **bf) == (64, 8, 3, 8, 2)


def test_launch_plan_reserve(monkeypatch):
    """One CTA an SM comes with an explicit grid and changes neither
    blocks nor slots; the wrapper launches with the reserve that over
    half the card's per-block limit gives, and 0 without it."""
    props = types.SimpleNamespace(
        shared_memory_per_block_optin=H100_SXM.smem_per_block_optin,
        multi_processor_count=H100_SXM.sm_count)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: props)
    kw = dict(dtype=torch.float32, device=torch.device("cpu"))
    assert P.plan(1 << 19, block_rows=32, num_stages=2, n_in=2, ctas=48,
                  map_op="striad", one_cta_per_sm=True, **kw) == \
        (32, 1 << 14, 2, 48, 2)
    assert P.plan(1 << 19, block_rows=32, num_stages=2, n_in=1, ctas=7,
                  one_cta_per_sm=True, **kw) == (32, 1 << 14, 2, 7, 0)
    with pytest.raises(ValueError, match="pass ctas"):
        P.plan(1 << 19, block_rows=32, num_stages=2, n_in=2,
               map_op="striad", one_cta_per_sm=True, **kw)
    assert P.one_cta_reserve(torch.device("cuda")) == \
        H100_SXM.smem_per_block_optin // 2 + 1
    launched = []
    monkeypatch.setattr(P.MAP_PIPELINE, "launch",
                        lambda *a: launched.append(a[-2]))
    monkeypatch.setattr(P.REDUCE_PIPELINE, "launch",
                        lambda *a: launched.append(a[-2]))
    monkeypatch.setattr(P, "check_streams", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    meta = torch.empty((1 << 10, P.LANES), device="meta")
    for one in (True, False):
        P.map_pipeline("copy", (), (meta,), rows=1 << 10, dtype=torch.float32,
                       device=meta.device, num_stages=2, block_rows=32,
                       ctas=4, one_cta_per_sm=one)
        P.reduce_pipeline("ddot", (meta, meta), num_stages=2, block_rows=32,
                          ctas=4, one_cta_per_sm=one)
    assert launched == [H100_SXM.smem_per_block_optin // 2 + 1] * 2 + [0, 0]


def test_fused_chain_equals_unfused():
    g = torch.Generator().manual_seed(3)
    b, c = (torch.randn(64 * 128, generator=g) for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        bb, cc = b.to(dtype), c.to(dtype)
        fused = ops.triad_update(S, T, bb, cc)
        assert torch.equal(fused, ops.triad_update_unfused(S, T, bb, cc))
        assert torch.equal(fused, ops.triad_update(S, T, bb, cc,
                                                   num_stages=None))


def test_fused_chain_stream_counts():
    from repro_torch.core.kernel_spec import TRIAD_UPDATE_STREAMS

    assert TRIAD_UPDATE_STREAMS == JP.triad_update_chain_streams() == (5, 3)
