"""The port's blocked matmul against the reference's
(``repro/kernels/matmul``): the same numpy inputs through the reference's
Pallas kernel in interpret mode, its oracle, and the port's op on the CPU
(its plain version), at the reference's shapes and tolerances; the op's
contract, blocks left at None included; the depth a requested ``bk`` runs
at; the tiling the op hands the kernel wrapper on the card path (``meta``
tensors, the wrapper replaced by a recorder); the kernel wrapper's
refusals without the card; and the ``(rtol, atol)`` mode of ``compare``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul import ops as jops  # noqa: E402
from repro.kernels.matmul import ref as jref  # noqa: E402
from repro_torch.convert import streams_from_numpy  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.kernels.matmul import kernel as K  # noqa: E402
from repro_torch.kernels.matmul import ops, ref  # noqa: E402

#: the reference's test shapes (tests/test_kernels.py), (m, n, k)
SHAPES = [(256, 256, 256), (512, 384, 640), (128, 128, 1024)]
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
SMEM = H100_SXM.smem_per_block_optin


def _pair(m, n, k, jdt, seed=0):
    """x (m, k), y (k, n) as JAX arrays of ``jdt`` and as bit-identical
    CPU tensors."""
    rng = np.random.default_rng(seed)
    jx = jnp.asarray(rng.standard_normal((m, k)), jdt)
    jy = jnp.asarray(rng.standard_normal((k, n)), jdt)
    tx, ty = streams_from_numpy([np.asarray(jx), np.asarray(jy)], device="cpu")
    return (jx, jy), (tx, ty)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matmul_matches_reference(shape, dtype):
    """At 128^3 blocks, as the reference's own test: within the
    reference's tolerance of its Pallas kernel and of its oracle."""
    tdt, jdt = DTYPES[dtype]
    (jx, jy), (tx, ty) = _pair(*shape, jdt)
    got = ops.matmul(tx, ty, bm=128, bn=128, bk=128)
    assert got.dtype == tdt and tuple(got.shape) == shape[:2]
    for want in (jops.matmul(jx, jy, bm=128, bn=128, bk=128, interpret=True),
                 jref.matmul(jx, jy)):
        (w,) = streams_from_numpy([np.asarray(want)], device="cpu")
        ok, err, tol = compare(got, w, tol=ref.TOLERANCE[tdt])
        assert ok, (err, tol)


def test_matmul_out_dtype():
    """f32 accumulation; the output in ``out_dtype or x.dtype``."""
    (jx, jy), (tx, ty) = _pair(128, 128, 256, jnp.float32)
    want = jref.matmul(jx, jy, out_dtype=jnp.bfloat16)
    got = ops.matmul(tx, ty, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    (w,) = streams_from_numpy([np.asarray(want)], device="cpu")
    assert compare(got, w, tol=ref.TOLERANCE[torch.bfloat16])[0]
    assert ops.matmul(tx, ty).dtype == torch.float32
    (_, _), (bx, by) = _pair(128, 128, 256, jnp.bfloat16)
    assert ops.matmul(bx, by).dtype == torch.bfloat16
    assert ops.matmul(bx, by, out_dtype=torch.float32).dtype == torch.float32


def test_matmul_blocks_clamp_and_must_divide():
    """Blocks are clamped to the problem with min(b, dim); a dimension the
    clamped block does not divide raises, as the reference asserts."""
    (_, _), (x, y) = _pair(64, 96, 32, jnp.float32)
    # bm 128 -> 64, bn 1024 -> 96, bk 512 -> 32: all divide
    out = ops.matmul(x, y, bm=128, bn=1024, bk=512)
    assert torch.equal(out, ref.matmul(x, y))
    with pytest.raises(ValueError, match="do not divide"):
        ops.matmul(x, y, bm=48, bn=64)          # 96 % 64
    with pytest.raises(ValueError, match="do not divide"):
        ops.matmul(x, y, bk=24)
    with pytest.raises(ValueError, match="cannot multiply"):
        ops.matmul(x, x)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_default_tiling_is_compiled(dtype):
    """The port's default tiling of each route (the one the model's
    workload takes by default) is compiled and divides the reference's
    shapes, unlike the reference's VMEM-sized 256/256/512, which the op
    takes on the CPU only."""
    tdt, jdt = DTYPES[dtype]
    route = K.route_of(tdt)
    assert K.DEFAULTS[route] in K.TILINGS[route]
    from repro.kernels.matmul import kernel as JK
    assert (JK.DEFAULT_BM, JK.DEFAULT_BN, JK.DEFAULT_BK) not in K.TILINGS[route]
    assert ops.REFERENCE_BLOCKS == (JK.DEFAULT_BM, JK.DEFAULT_BN, JK.DEFAULT_BK)
    for m, n, k in SHAPES:   # the defaults divide the reference's shapes
        assert not (m % K.DEFAULTS[route][0] or n % K.DEFAULTS[route][1]
                    or k % K.DEFAULTS[route][2])
    assert list(K.TILINGS) == list(K.ROUTES.values()) == ["ffma", "wgmma"]


#: per route: (count of tilings, a tiling's shared bytes by formula)
ROUTE_TABLES = {
    "f32": (12, lambda bm, bn, bk: 3 * (bm + 4 + bn) * bk * 4),
    "bf16": (3, lambda bm, bn, bk: 1024 + 4 * (bm + bn) * bk * 2 + 4 * 2 * 8),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tiling_table_and_shared_memory(dtype):
    """Every compiled tiling of the route fits the H100; a tiling over
    shared memory and one the route is not compiled for raise, before
    any launch."""
    tdt, _ = DTYPES[dtype]
    route = K.route_of(tdt)
    count, formula = ROUTE_TABLES[dtype]
    assert len(set(K.TILINGS[route])) == len(K.TILINGS[route]) == count
    for t in K.TILINGS[route]:
        assert K.check_tiling(*t, SMEM, tdt) == K.smem_bytes(*t, tdt) == formula(*t)
    big = (128, 128, 256) if dtype == "f32" else (256, 256, 64)
    with pytest.raises(ValueError, match="shared memory"):
        K.check_tiling(*big, SMEM, tdt)
    with pytest.raises(ValueError, match="compiled"):
        K.check_tiling(128, 128, 8, SMEM, tdt)
    with pytest.raises(ValueError, match="shared memory"):
        K.check_tiling(*K.DEFAULTS[route], 10_000, tdt)
    # the other route's tilings are not this route's
    other = K.TILINGS["wgmma" if route == "ffma" else "ffma"]
    assert not set(other) & set(K.TILINGS[route])
    with pytest.raises(ValueError, match="compiled"):
        K.check_tiling(*other[0], SMEM, tdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_of_each_compiled_tiling(dtype):
    """The one host plan: on the wgmma route every TMA box's inner
    dimension is at most one 128-byte swizzle row, the boxes fill a stage,
    one consumer warpgroup per 64 rows plus the producer's, ``bn`` at most
    256 and a multiple of 8; on either route stages x stage bytes plus
    the alignment slack (and the mbarriers) fit the card."""
    tdt, _ = DTYPES[dtype]
    for t in K.TILINGS[K.route_of(tdt)]:
        p = K.plan(*t, tdt)
        bm, bn, bk = p.block
        assert p.block == t
        assert p.stages * p.stage_bytes + p.slack <= p.smem_bytes <= SMEM
        if p.route == "wgmma":
            assert p.stage_bytes == (bm + bn) * bk * 2
            assert bm % 64 == 0 and bn <= 256 and bn % 8 == 0 and bk == 64
            assert p.threads == 128 * (bm // 64 + 1)
            assert p.swizzle == 128 and p.slack == 1024
            assert all(cols * 2 <= p.swizzle for _, cols in p.boxes)
            assert sum(r * c for r, c in p.boxes) * 2 == p.stage_bytes
            assert p.boxes[0] == (bm, bk)
            assert p.smem_bytes == p.slack + p.stages * p.stage_bytes + 16 * p.stages
        else:
            assert p.stage_bytes == (bm + K.FFMA_A_PAD + bn) * bk * 4
            assert p.boxes == () and p.swizzle == 0 and p.slack == 0
            assert p.stages >= 2 and p.threads == 256
            assert p.smem_bytes == p.stages * p.stage_bytes


def _operands(m, n, k, tdt, offset=0):
    """x (m, k), y (k, n) of ``tdt`` on the CPU; x starts ``offset``
    elements into its buffer."""
    x = torch.zeros(m * k + offset, dtype=tdt)[offset:].view(m, k)
    return x, torch.zeros((k, n), dtype=tdt)


@pytest.mark.parametrize("case", ["uncompiled", "over_shared_memory",
                                  "bf16_k", "bf16_n", "misaligned",
                                  "not_divided", "mixed_dtypes"])
def test_check_operands_refuses_before_launch(case):
    """What the kernel wrapper refuses, checked on the host before any
    launch (and so testable on the CPU)."""
    bf, f32 = torch.bfloat16, torch.float32
    calls = {
        "uncompiled": (_operands(128, 128, 128, bf), (128, 64, 64), "compiled"),
        "over_shared_memory": (_operands(256, 256, 256, f32), (128, 128, 256),
                               "shared memory"),
        "bf16_k": (_operands(128, 128, 100, bf), (128, 128, 100), "multiples of 8"),
        "bf16_n": (_operands(128, 132, 128, bf), (128, 132, 64), "multiples of 8"),
        "misaligned": (_operands(128, 128, 128, bf, offset=1), (128, 128, 64),
                       "16-byte aligned"),
        "not_divided": (_operands(128, 128, 96, bf), (128, 128, 64), "do not divide"),
        "mixed_dtypes": ((torch.zeros((128, 64), dtype=bf),
                          torch.zeros((64, 128), dtype=f32)), (128, 128, 64),
                         "one dtype"),
    }
    (x, y), (bm, bn, bk), msg = calls[case]
    with pytest.raises(ValueError, match=msg):
        K.check_operands(x, y, bm=bm, bn=bn, bk=bk, smem_limit=SMEM)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_check_operands_plans_the_route(dtype):
    tdt, _ = DTYPES[dtype]
    x, y = _operands(512, 384, 640, tdt)
    t = K.DEFAULTS[K.route_of(tdt)]
    p = K.check_operands(x, y, bm=t[0], bn=t[1], bk=t[2], smem_limit=SMEM)
    assert p == K.plan(*t, tdt) and p.route == K.ROUTES[tdt]


def test_launch_counts_by_route():
    """The one matmul kernel counts its launches per route; a launch must
    name one of its routes (checked before the library is loaded), and a
    reset clears both counts."""
    assert K.MATMUL.routes == ("ffma", "wgmma")
    K.MATMUL.launches_by_route["wgmma"] += 2
    K.MATMUL.launches += 2
    K.MATMUL.reset()
    assert K.MATMUL.launches == 0
    assert K.MATMUL.launches_by_route == {"ffma": 0, "wgmma": 0}
    for route in (None, "tf32"):
        with pytest.raises(ValueError, match="route"):
            K.MATMUL.launch(route=route)
    assert K.MATMUL.launches_by_route == {"ffma": 0, "wgmma": 0}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES + [(192, 192, 192)], ids=str)
def test_matmul_at_the_route_default_matches_reference(shape, dtype):
    """The op on the CPU with its blocks left at None takes the
    reference's defaults (256/256/512, clamped): within the reference's
    tolerance of its Pallas kernel at its defaults, and of its oracle,
    where the reference accepts the shape; where the reference refuses it
    (its 256-row block does not divide n = 384), the op refuses it too."""
    tdt, jdt = DTYPES[dtype]
    (jx, jy), (tx, ty) = _pair(*shape, jdt, seed=3)
    if shape[1] % 256 and shape[1] > 256:
        with pytest.raises(AssertionError):
            jops.matmul(jx, jy, interpret=True)
        with pytest.raises(ValueError, match="do not divide"):
            ops.matmul(tx, ty)
        return
    got = ops.matmul(tx, ty)
    assert got.dtype == tdt and tuple(got.shape) == shape[:2]
    for want in (jops.matmul(jx, jy, interpret=True), jref.matmul(jx, jy)):
        (w,) = streams_from_numpy([np.asarray(want)], device="cpu")
        ok, err, tol = compare(got, w, tol=ref.TOLERANCE[tdt])
        assert ok, (err, tol)


#: (dtype, asked (bm, bn, bk), the depth that runs): a compiled depth
#: stays; an uncompiled one runs at the largest compiled depth of the
#: route that divides it (the reference's test call, 128 x 128 x 128,
#: among them); one that none divides, or an uncompiled (bm, bn), stays
#: as asked for check_tiling to refuse
DEPTHS = [("f32", (128, 128, 16), 16), ("f32", (128, 256, 32), 32),
          ("f32", (128, 128, 128), 32), ("f32", (64, 64, 48), 16),
          ("f32", (128, 128, 8), 8), ("f32", (96, 128, 128), 128),
          ("bf16", (128, 128, 64), 64), ("bf16", (128, 128, 128), 64),
          ("bf16", (128, 256, 4096), 64), ("bf16", (128, 128, 32), 32),
          ("bf16", (256, 256, 128), 128)]


@pytest.mark.parametrize("dtype,asked,runs", DEPTHS, ids=str)
def test_compiled_depth(dtype, asked, runs):
    tdt, _ = DTYPES[dtype]
    assert K.compiled_depth(*asked, tdt) == runs
    if runs != asked[2]:
        assert asked[:2] + (runs,) in K.TILINGS[K.route_of(tdt)]


class _Recorder:
    """Stands in for the kernel wrapper on tensors without storage (the
    ``meta`` device, which takes the op's card path): records the call."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, y, **kw):
        self.calls.append((x, y, kw))
        return torch.empty((x.shape[0], y.shape[1]), dtype=kw["out_dtype"],
                           device=x.device)


#: (shape, dtype, asked blocks, the blocks the wrapper receives; None: the
#: model's pick, tuned_blocks)
CARD_CALLS = [((192, 192, 192), "f32", (None, None, None), None),
              ((256, 384, 192), "bf16", (None, None, None), None),
              ((256, 256, 256), "f32", (128, 128, 128), (128, 128, 32)),
              ((512, 384, 640), "bf16", (128, 128, 128), (128, 128, 64)),
              ((256, 256, 256), "bf16", (64, None, None), (64, 128, 64)),
              ((256, 256, 256), "f32", (None, None, 128), (128, 256, 32)),
              ((256, 256, 256), "f32", (1024, 1024, 1024), (256, 256, 256))]


@pytest.mark.parametrize("shape,dtype,asked,gets", CARD_CALLS, ids=str)
def test_card_path_takes_a_compiled_tiling(shape, dtype, asked, gets,
                                           monkeypatch):
    """On the card, blocks left at None take the first ranked compiled
    tiling that agrees with the blocks given, and a requested depth runs
    at the compiled one that divides it; the blocks a caller passes are
    clamped and handed on (the wrapper then refuses what is not
    compiled: 256^3 is over shared memory at f32)."""
    tdt, _ = DTYPES[dtype]
    m, n, k = shape
    rec = _Recorder()
    monkeypatch.setattr(K, "matmul_tiled", rec)
    x = torch.empty((m, k), dtype=tdt, device="meta")
    y = torch.empty((k, n), dtype=tdt, device="meta")
    bm, bn, bk = asked
    out = ops.matmul(x, y, bm=bm, bn=bn, bk=bk)
    assert tuple(out.shape) == (m, n) and out.dtype == tdt
    ((gx, gy, kw),) = rec.calls
    assert gx is x and gy is y
    got = (kw["bm"], kw["bn"], kw["bk"])
    want = gets or ops.tuned_blocks(m, n, k, dtype=tdt)
    assert got == want
    if gets is None or asked[0] != 1024:
        assert got in K.TILINGS[K.route_of(tdt)]
    else:
        with pytest.raises(ValueError, match="shared memory"):
            K.check_tiling(*got, SMEM, tdt)


def test_card_path_raises_without_a_compiled_tiling(monkeypatch):
    """No compiled tiling divides m = 96, nor n = 192 on the bf16 route
    (its tiles are 128 or 256 wide), or agrees with bm = 256 there: the
    op raises before any launch."""
    monkeypatch.setattr(K, "matmul_tiled", _Recorder())
    x = torch.empty((96, 128), device="meta")
    with pytest.raises(ValueError, match="no compiled matmul tiling"):
        ops.matmul(x, torch.empty((128, 128), device="meta"))
    x = torch.empty((192, 192), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no compiled matmul tiling"):
        ops.matmul(x, x)
    xb = torch.empty((512, 512), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no compiled wgmma matmul tiling"):
        ops.matmul(xb, xb, bm=256)
    with pytest.raises(ValueError, match="do not divide"):
        ops.matmul(xb, xb, bm=96)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_wrapper_refuses_cpu_tensors(dtype):
    x = torch.zeros((128, 128), dtype=DTYPES[dtype][0])
    bm, bn, bk = K.DEFAULTS[K.route_of(x.dtype)]
    with pytest.raises(ValueError, match="CUDA"):
        K.matmul_tiled(x, x, bm=bm, bn=bn, bk=bk, out_dtype=torch.float32)


def test_compare_tol_mode_is_elementwise_and_nan_safe():
    want = torch.tensor([1.0, 100.0, -3.0])
    tol = (1e-2, 1e-3)
    ok, err, bound = compare(want.clone(), want, tol=tol)
    assert (ok, err) == (True, 0.0) and bound == pytest.approx(1.001)
    # 0.5 off at 100 is inside rtol; 0.05 off at 1.0 is not
    ok, err, bound = compare(torch.tensor([1.0, 100.5, -3.0]), want, tol=tol)
    assert ok and err == 0.5 and bound == pytest.approx(1.001)
    ok, err, _ = compare(torch.tensor([1.05, 100.0, -3.0]), want, tol=tol)
    assert not ok and err == pytest.approx(0.05)
    ok, err, _ = compare(torch.tensor([float("nan"), 100.0, -3.0]), want, tol=tol)
    assert not ok and err == float("inf")
    inf = torch.tensor([float("inf")])
    assert not compare(inf, inf, tol=tol)[0]
    nan = torch.tensor([float("nan")])
    assert not compare(nan, nan, tol=tol)[0]
    with pytest.raises(ValueError, match="not both"):
        compare(want, want, summed_from=want, tol=tol)


def test_card_path_ranks_each_shape_once(monkeypatch):
    """The card path memoizes the ranking per (dims, dtype, machine): a
    second call at the same key does not call ``rank`` and takes the same
    tiling; another dtype ranks anew."""
    import repro_torch.core.autotune as autotune

    real_rank, calls = autotune.rank, []

    def counting_rank(*args, **kw):
        calls.append((args[0], kw["elem_bytes"]))
        return real_rank(*args, **kw)

    monkeypatch.setattr(autotune, "rank", counting_rank)
    monkeypatch.setattr(ops, "_RANKED", {})
    rec = _Recorder()
    monkeypatch.setattr(K, "matmul_tiled", rec)
    x = torch.empty((256, 512), device="meta")
    y = torch.empty((512, 384), device="meta")
    for _ in range(3):
        ops.matmul(x, y)
    assert calls == [((256, 384, 512), 4)]
    assert len({(kw["bm"], kw["bn"], kw["bk"]) for *_, kw in rec.calls}) == 1
    assert ops.tuned_blocks(256, 384, 512) == ops.ranked_blocks(
        (256, 384, 512), torch.float32)[0]
    assert len(calls) == 1
    ops.matmul(x.to(torch.bfloat16), y.to(torch.bfloat16))
    assert calls[1:] == [((256, 384, 512), 2)]
    assert ops.ranked_blocks((256, 384, 512), torch.float32) == tuple(
        r["block"] for r in real_rank((256, 384, 512), H100_SXM,
                                      objective="matmul", elem_bytes=4))


@pytest.mark.parametrize("operand", [0, 1])
def test_matmul_refuses_grad(operand):
    """The kernel has no backward (nor has the reference's Pallas
    kernel): with grad mode on, an operand that requires grad raises on
    the CPU as on the card; under no_grad the op runs as before."""
    (_, _), (tx, ty) = _pair(128, 128, 128, jnp.float32)
    args = [tx, ty]
    args[operand] = args[operand].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.matmul(*args)
    with torch.no_grad():
        assert torch.equal(ops.matmul(*args), ops.matmul(tx, ty))
