"""Port stencil ops (plain path on the CPU) against the JAX reference: the
oracles of ``repro/kernels/stencil/ref.py`` and the Pallas paths of
``ops.py`` in interpret mode, on the same numpy inputs; and the halo
pipeline's host contract (padding, block fit, depth cap, tiles, ring)."""
import functools
import inspect
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import pipeline as JP  # noqa: E402
from repro.kernels.stencil import ops as jops  # noqa: E402
from repro.kernels.stencil import ref as jref  # noqa: E402
from repro_torch.benchmarks import gpu_stencil_ecm as G  # noqa: E402
from repro_torch.convert import streams_from_numpy  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.kernels import pipeline as P  # noqa: E402
from repro_torch.kernels.stencil import kernel as K  # noqa: E402
from repro_torch.kernels.stencil import ops, ref  # noqa: E402

STAGES = [None, 1, 2, 3]
SHAPES_2D = [(24, 33), (40, 128), (23, 17)]      # the reference's tests
SHAPES_3D = [(12, 10, 17), (7, 9, 11)]
SHAPES = SHAPES_2D + SHAPES_3D
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
#: per dimension: the reference's own coefficient pairs, then c0 != 0
PAIRS = {2: [(0.0, 0.25), (0.5, 0.125), (0.3, 0.175)],
         3: [(0.0, 1.0 / 6.0), (0.3, 0.1), (0.3, 0.175)]}
SMEM = H100_SXM.smem_per_block_optin


def _input(shape, dt="f32", seed=0):
    """A N(0, 1) array as a JAX array and, bit for bit, as a port tensor."""
    jdt, _ = DTYPES[dt]
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    .astype(np.float32), jdt)
    return x, streams_from_numpy([np.asarray(x)], device="cpu")[0]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _port(a, c0, c1, ns=None):
    op = ops.jacobi2d if a.dim() == 2 else ops.jacobi3d
    return op(a, c0=c0, c1=c1, num_stages=ns)


@functools.lru_cache(maxsize=None)
def _pallas(shape, dt, c0, c1, ns):
    """The reference's op in interpret mode (cached: each call compiles)."""
    x, _ = _input(shape, dt)
    op = jops.jacobi2d if len(shape) == 2 else jops.jacobi3d
    return np.asarray(op(x, c0=c0, c1=c1, num_stages=ns, interpret=True),
                      np.float32)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_equals_reference_oracle(shape, dt):
    """Bit for bit for every coefficient pair, c0 != 0 included: the port
    pins ref.py's rounding (both products rounded, then added; bf16
    rounded after every operation)."""
    x, a = _input(shape, dt)
    jop = jref.jacobi2d if len(shape) == 2 else jref.jacobi3d
    for c0, c1 in PAIRS[len(shape)]:
        got = _port(a, c0, c1)
        want = streams_from_numpy([np.asarray(jop(x, c0, c1))],
                                  device="cpu")[0]
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (c0, c1)


@pytest.mark.parametrize("ns", STAGES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_equals_pallas_at_reference_pairs(shape, ns):
    """At the reference's default pair (c0 = 0) the Pallas paths agree
    with their oracle bit for bit, and so with the port."""
    c0, c1 = PAIRS[len(shape)][0]
    _, a = _input(shape)
    assert np.array_equal(_np(_port(a, c0, c1, ns)),
                          _pallas(shape, "f32", c0, c1, ns))


@pytest.mark.parametrize("ns", STAGES)
def test_equals_pallas_nonzero_c0_exact_products(ns):
    """(0.5, 0.125): both products are exact, so every rounding order
    agrees (tests/test_stencil.py:41)."""
    _, a = _input((40, 56))
    assert np.array_equal(_np(_port(a, 0.5, 0.125, ns)),
                          _pallas((40, 56), "f32", 0.5, 0.125, ns))


@pytest.mark.parametrize("ns", [None, 2])
def test_equals_pallas_bf16(ns):
    """bf16: every path rounds after each operation, as the port does."""
    _, a = _input((32, 48), "bf16")
    assert np.array_equal(_np(_port(a, 0.0, 0.25, ns)),
                          _pallas((32, 48), "bf16", 0.0, 0.25, ns))


ATOL_NONZERO_C0 = 1e-6


@pytest.mark.parametrize("ns", [None, 1])
@pytest.mark.parametrize("shape", [(40, 56), (12, 10, 17)], ids=str)
def test_near_pallas_at_nonzero_c0(shape, ns):
    """With c0 != 0 the reference's three f32 paths round c0*c + c1*s
    three ways: ref.py rounds both products, the whole-array kernel fuses
    c0*c into the add, the halo pipeline fuses c1*s.  The port equals
    ref.py (test above), so against the Pallas paths it differs by at most
    one rounding of a result of magnitude below ~3: measured 1.19e-7 on
    N(0, 1) inputs at (0.3, 0.175) and (0.3, 0.1); the tolerance is 1e-6.
    Depths 2 and 3 take the same path as depth 1."""
    c0, c1 = PAIRS[len(shape)][1 if len(shape) == 3 else 2]
    _, a = _input(shape)
    got = _np(_port(a, c0, c1, ns))
    want = _pallas(shape, "f32", c0, c1, ns)
    err = np.abs(got - want)
    assert err.max() <= ATOL_NONZERO_C0
    assert (err > 0).any()      # the reference's split is real


def test_boundary_is_dirichlet_copy():
    for shape in [(16, 20), (6, 7, 9)]:
        _, a = _input(shape, seed=7)
        out = _port(a, 0.3, 0.175)
        edge = ref.edge_mask(shape, a.device)
        assert torch.equal(out[edge], a[edge])
        assert int(edge.sum()) == math.prod(shape) - math.prod(
            n - 2 for n in shape)


def test_fixed_point_constant_field():
    """With c0 + 2*dim*c1 = 1 (and exact products) a constant field is a
    fixed point of the sweep."""
    a = torch.full((24, 40), 3.25)
    assert torch.equal(ops.jacobi2d(a, c0=0.0, c1=0.25, num_stages=3), a)
    a = torch.full((6, 8, 10), 3.25)
    assert torch.equal(ops.jacobi3d(a, c0=0.25, c1=0.125), a)


def test_halo_plan_rejects_unpadded_input():
    with pytest.raises(ValueError, match="padded input"):
        P.halo_plan((8, 6), (8, 4), torch.float32, num_stages=2,
                    block_rows=8, smem_limit=SMEM)
    with pytest.raises(ValueError, match="padded by 1"):
        P.halo_plan((10, 5), (8, 4), torch.float32, num_stages=2,
                    block_rows=8, smem_limit=SMEM)
    with pytest.raises(ValueError, match="padded by 1"):
        P.halo_plan((10, 6, 6, 6), (8, 4, 4, 4), torch.float32,
                    num_stages=2, block_rows=8, smem_limit=SMEM)


@pytest.mark.parametrize("shape", SHAPES + [(8, 12), (24, 2100)] +
                         list(G.POINTS.values()), ids=str)
def test_halo_plan_axis0_matches_reference(shape):
    """Block fit and depth cap are the reference's, at every depth and
    block; the tile is cut to the array where it is narrower."""
    padded = tuple(n + 2 for n in shape)
    for block_rows in (1, 4, 8, 16):
        for ns in (1, 2, 3, 5):
            plan = P.halo_plan(padded, shape, torch.float32, num_stages=ns,
                               block_rows=block_rows, smem_limit=1 << 30)
            b = JP._fit_block(shape[0], block_rows)
            assert (plan.block, plan.n_chunks) == (b, shape[0] // b)
            assert plan.stages == max(1, min(ns, shape[0] // b))
            th, tw = P.HALO_TILE[len(shape)]
            h = shape[1] if len(shape) == 3 else 1
            assert plan.tile == (min(th, h), min(tw, shape[-1]))
            tiles = math.ceil(h / plan.tile[0]) * math.ceil(
                shape[-1] / plan.tile[1])
            assert (plan.tiles_x, plan.tiles) == (
                math.ceil(shape[-1] / plan.tile[1]), tiles)
            assert plan.n_items == plan.n_chunks * tiles


def test_halo_plan_ring():
    """The ring: stages x (b + 2) axis-0 rows x the tile's slot rows; bf16
    rows have an even pitch with room for a one-element shift."""
    plan = P.halo_plan((8194, 8194), (8192, 8192), torch.float32, num_stages=3,
                       block_rows=8, smem_limit=SMEM)
    assert (plan.tile, plan.pitch, plan.lines) == ((1, 1024), 1026, 1)
    assert plan.smem_bytes == 3 * 10 * 1026 * 4 == 123120
    plan = P.halo_plan((514,) * 3, (512,) * 3, torch.float32, num_stages=3,
                       block_rows=8, smem_limit=SMEM)
    assert (plan.tile, plan.pitch, plan.lines) == ((16, 64), 66, 18)
    assert plan.smem_bytes == 3 * 10 * 18 * 66 * 4 == 142560
    for tw, pitch in [(17, 20), (16, 20), (256, 260)]:
        plan = P.halo_plan((10, tw + 2), (8, tw), torch.bfloat16,
                           num_stages=1, block_rows=8, smem_limit=SMEM)
        assert plan.pitch == pitch and plan.pitch % 2 == 0
        assert plan.pitch >= tw + 2 + 1


def test_ring_over_shared_memory_raises():
    """A 16-layer 3D block at depth 3 needs 3 x 18 x 18 x 66 x 4 B =
    256,608 B, over the card's 232,448: it raises and is never shrunk."""
    shape = (64, 64, 64)
    padded = tuple(n + 2 for n in shape)
    with pytest.raises(ValueError, match="shared memory"):
        P.halo_plan(padded, shape, torch.float32, num_stages=3,
                    block_rows=16, smem_limit=SMEM)
    plan = P.halo_plan(padded, shape, torch.float32, num_stages=2,
                       block_rows=16, smem_limit=SMEM)
    assert plan.smem_bytes == 2 * 18 * 18 * 66 * 4
    # bf16 halves the ring: depth 3 fits
    P.halo_plan(padded, shape, torch.bfloat16, num_stages=3, block_rows=16,
                smem_limit=SMEM)


def test_wrappers_take_cuda_tensors_only():
    p = torch.zeros((10, 12))
    with pytest.raises(ValueError, match="CUDA"):
        K.jacobi2d_grid(p, c0=0.0, c1=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        K.jacobi3d_grid(torch.zeros((4, 5, 6)), c0=0.0, c1=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        P.halo_pipeline(p, out_shape=(8, 10), c0=0.0, c1=0.25, num_stages=2,
                        block_rows=8)
    assert not any(k.launches for k in (K.JACOBI2D_GRID, K.JACOBI3D_GRID,
                                        P.HALO_PIPELINE))


def test_read_amplification():
    """Shared-memory fills per padded element at the three points: axis 0
    reads (b + 2)/b, each tile its own halo."""
    got = {k: G.read_amplification(s, K.BLOCK_ROWS, H100_SXM)
           for k, s in G.POINTS.items()}
    assert got["2d"] == 1024 * 10 * (8192 + 2 * 8) / 8194**2
    assert got["3d"] == 64 * 10 * (512 + 2 * 32) * (512 + 2 * 8) / 514**3
    assert 1.25 < got["2d"] < got["3d_lc_broken"] < got["3d"] < 1.5


def test_signatures_match_reference():
    """Same parameters and defaults as the reference's ops, less
    ``interpret``."""
    for mine, theirs in [(ops.jacobi2d, jops.jacobi2d),
                         (ops.jacobi3d, jops.jacobi3d)]:
        want = dict(inspect.signature(theirs).parameters)
        want.pop("interpret")
        got = inspect.signature(mine).parameters
        assert list(got) == list(want)
        assert [p.default for p in got.values()] == [
            p.default for p in want.values()]
    assert K.BLOCK_ROWS == 8
