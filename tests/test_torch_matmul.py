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


def test_default_tiling_is_compiled():
    """The port's defaults are a tiling the kernel has, unlike the
    reference's VMEM-sized 256/256/512."""
    assert (K.DEFAULT_BM, K.DEFAULT_BN, K.DEFAULT_BK) in K.TILINGS
    from repro.kernels.matmul import kernel as JK
    assert (JK.DEFAULT_BM, JK.DEFAULT_BN, JK.DEFAULT_BK) not in K.TILINGS


def test_tiling_table_and_shared_memory():
    """Every compiled tiling fits the H100; a tiling over shared memory and
    one the kernel is not compiled for raise, before any launch."""
    assert len(set(K.TILINGS)) == len(K.TILINGS) == 8
    for t in K.TILINGS:
        assert K.check_tiling(*t, SMEM) == K.smem_bytes(*t) == \
            (t[0] + t[1]) * t[2] * 4
    assert K.smem_bytes(128, 128, 128) == 131072
    with pytest.raises(ValueError, match="shared memory"):
        K.check_tiling(128, 128, 256, SMEM)
    with pytest.raises(ValueError, match="compiled"):
        K.check_tiling(128, 128, 32, SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        K.check_tiling(128, 128, 128, 100_000)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((128, 128))
    with pytest.raises(ValueError, match="CUDA"):
        K.matmul_tiled(x, x, bm=128, bn=128, bk=16, out_dtype=torch.float32)


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
