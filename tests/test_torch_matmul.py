"""The port's blocked matmul against the reference's
(``repro/kernels/matmul``): the same numpy inputs through the reference's
Pallas kernel in interpret mode, its oracle, and the port's op on the CPU
(its plain version), at the reference's shapes and tolerances; the op's
contract; the kernel wrapper's refusals without the card; and the
``(rtol, atol)`` mode of ``compare``."""
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
    """The port's defaults are a tiling of the dtype's route, unlike the
    reference's VMEM-sized 256/256/512, and the op takes them when no
    block is given."""
    tdt, jdt = DTYPES[dtype]
    route = K.route_of(tdt)
    assert K.DEFAULTS[route] in K.TILINGS[route]
    from repro.kernels.matmul import kernel as JK
    assert (JK.DEFAULT_BM, JK.DEFAULT_BN, JK.DEFAULT_BK) not in K.TILINGS[route]
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
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matmul_at_the_route_default_matches_reference(shape, dtype):
    """The op at its default blocks (the route's, clamped) within the
    reference's tolerance of its Pallas kernel at the same blocks, and of
    its oracle."""
    tdt, jdt = DTYPES[dtype]
    (jx, jy), (tx, ty) = _pair(*shape, jdt, seed=3)
    bm, bn, bk = (min(b, d) for b, d in zip(K.DEFAULTS[K.route_of(tdt)],
                                             (shape[0], shape[1], shape[2])))
    got = ops.matmul(tx, ty)
    assert got.dtype == tdt and tuple(got.shape) == shape[:2]
    for want in (jops.matmul(jx, jy, bm=bm, bn=bn, bk=bk, interpret=True),
                 jref.matmul(jx, jy)):
        (w,) = streams_from_numpy([np.asarray(want)], device="cpu")
        ok, err, tol = compare(got, w, tol=ref.TOLERANCE[tdt])
        assert ok, (err, tol)


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
