"""The port's layer conditions against the reference's
(``repro/core/layer_condition.py``), with the H100's and Haswell-EP's
capacities passed in, and the GPU stencil model built on them."""
import dataclasses
import inspect
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import layer_condition as JLC  # noqa: E402
from repro.core.machine import HASWELL_EP  # noqa: E402
from repro_torch.core import layer_condition as LC  # noqa: E402
from repro_torch.core.gpu_ecm import (gpu_stencil_ecm,  # noqa: E402
                                      stencil_hbm_streams)
from repro_torch.core.machine import H100_SXM  # noqa: E402

#: L1 (256 KB of the SM, shared with shared memory) and L2 of the H100
#: data sheet; the reference's Haswell-EP L1/L2/L3
CAPACITIES = {"h100": (256 * 1024, H100_SXM.l2_bytes),
              "haswell": HASWELL_EP.capacities}
ELEM_BYTES = (8, 4)
#: 2D widths around each capacity's break, 3 rows x W x eb x 2 <= C, in
#: f64 and f32
WIDTHS_2D = sorted({w + d for c in itertools.chain(*CAPACITIES.values())
                    for eb in ELEM_BYTES for w in [c // (6 * eb)]
                    for d in (-1, 0, 1)} | {8, 32, 8192})
#: 3D (H, W) pairs across the layer condition (3 layers) and the row
#: condition (5 rows)
HS = (8, 100, 512, 2048, 4096)
WS = (8, 64, 682, 2048, 3277, 5461, 8192, 26215, 262144)


def _specs():
    for name in ("jacobi2d", "jacobi3d"):
        for eb in ELEM_BYTES:
            yield (dataclasses.replace(LC.STENCILS[name], elem_bytes=eb),
                   dataclasses.replace(JLC.STENCILS[name], elem_bytes=eb))


def _widths(spec):
    if spec.dim == 2:
        return [(w,) for w in WIDTHS_2D]
    return list(itertools.product(HS, WS))


SPECS = list(_specs())
IDS = [f"{s.name}-f{8 * s.elem_bytes}" for s, _ in SPECS]


def test_specs_match_reference():
    assert LC.LC_SAFETY == JLC.LC_SAFETY
    assert list(LC.STENCILS) == list(JLC.STENCILS)
    for name, spec in LC.STENCILS.items():
        ref = JLC.STENCILS[name]
        # the port keeps the stream-structure fields and the flop count;
        # the uop counts feed only the reference's CPU ECM construction
        for field in dataclasses.fields(spec):
            assert getattr(spec, field.name) == getattr(ref, field.name), \
                field.name
        for prop in ("row_streams", "rfo_streams", "wb_streams"):
            assert getattr(spec, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("caps", sorted(CAPACITIES))
@pytest.mark.parametrize("spec,ref", SPECS, ids=IDS)
def test_misses_per_level_matches_reference(spec, ref, caps):
    capacities = CAPACITIES[caps]
    seen = set()
    for widths in _widths(spec):
        got = spec.misses_per_level(widths, capacities)
        assert got == ref.misses_per_level(widths, capacities), widths
        seen.update(got)
        for block in ([(64,)] if spec.dim == 2 else [(16, 64), (512, 8)]):
            assert (spec.misses_per_level(widths, capacities, block=block)
                    == ref.misses_per_level(widths, capacities, block=block))
    # the widths straddle every condition: every miss count occurs
    assert seen == ({1, 3} if spec.dim == 2 else {1, 3, 5})


@pytest.mark.parametrize("caps", sorted(CAPACITIES))
@pytest.mark.parametrize("spec,ref", SPECS, ids=IDS)
def test_misses_batch_matches_reference(spec, ref, caps):
    w = np.asarray(_widths(spec), float)
    got = LC.misses_batch(spec, w, CAPACITIES[caps])
    want = JLC.misses_batch(ref, w, CAPACITIES[caps])
    assert got.shape == (len(w), len(CAPACITIES[caps]))
    assert np.array_equal(got, want)
    if spec.dim == 2:
        assert np.array_equal(LC.misses_batch(spec, w[:, 0], CAPACITIES[caps]),
                              want)


def test_conditions_match_reference():
    for spec, ref in SPECS:
        for widths in _widths(spec)[:5]:
            assert spec.conditions(widths) == tuple(
                LC.LayerCondition(c.name, c.nbytes, c.misses_if_held)
                for c in ref.conditions(widths))


def test_no_knob_without_a_caller():
    """The safety factor is the constant LC_SAFETY, not an argument; the
    spec keeps the reference's stream-structure fields and flop count, and
    none of its uop counts."""
    for fn in (LC.LayerCondition.holds, LC.StencilSpec.load_misses,
               LC.StencilSpec.misses_per_level, LC.misses_batch):
        assert "safety" not in inspect.signature(fn).parameters, fn
    assert [f.name for f in dataclasses.fields(LC.StencilSpec)] == [
        "name", "dim", "radius", "elem_bytes", "write_allocate",
        "flops_per_elem"]


def test_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        LC.StencilSpec(name="x", dim=4)
    with pytest.raises(ValueError):
        LC.StencilSpec(name="x", dim=2, radius=0)
    with pytest.raises(ValueError):
        LC.JACOBI3D.conditions((64,))
    with pytest.raises(ValueError):
        LC.misses_batch(LC.JACOBI3D, np.ones((3, 1)), (1024,))


#: (shape, HBM streams, T_hbm ms at the data-sheet 3.35 TB/s): the three
#: full-size points of the stencil loop, f32, against the H100's 50 MiB L2
#: with the safety factor 2
POINTS = [((8192, 8192), 2, 0.16025997373134326),
          ((512, 512, 512), 2, 0.3205199474626865),
          ((64, 2048, 2048), 4, 1.282079789850746)]


@pytest.mark.parametrize("shape,streams,t_hbm_ms", POINTS)
def test_gpu_stencil_ecm_at_the_points(shape, streams, t_hbm_ms):
    spec = LC.STENCILS[f"jacobi{len(shape)}d"]
    assert stencil_hbm_streams(spec, shape, H100_SXM) == streams
    m = gpu_stencil_ecm(spec, shape, H100_SXM, 4)
    lups = np.prod(shape)
    assert m.t_hbm * H100_SXM.hbm_bytes_per_s / lups == pytest.approx(
        4 * streams)
    assert m.t_hbm * 1e3 == pytest.approx(t_hbm_ms, rel=1e-12)
    assert m.t_comp == pytest.approx(
        spec.flops_per_elem * lups / H100_SXM.peak_f32_flops)
    # the card's exposed fraction is 0: full overlap, the roofline
    assert m.t_ecm == m.t_roofline == m.t_hbm


#: the halo pipeline's tile caps the widths: three layers of 16 x 64 hold
#: at every point, so its model streams 2 arrays, 8 B/LUP in f32
@pytest.mark.parametrize("shape,_streams,_t", POINTS)
def test_gpu_stencil_ecm_blocked_by_the_halo_tile(shape, _streams, _t):
    dim = len(shape)
    spec = LC.STENCILS[f"jacobi{dim}d"]
    block = {2: (1024,), 3: (16, 64)}[dim]
    assert stencil_hbm_streams(spec, shape, H100_SXM, block=block) == 2
    m = gpu_stencil_ecm(spec, shape, H100_SXM, 4, block=block)
    assert m.t_hbm * H100_SXM.hbm_bytes_per_s / np.prod(shape) == \
        pytest.approx(8)


def test_gpu_stencil_ecm_conditions_use_the_element_size():
    """Three layers of 1200 x 1200 are 17.3 MB in f32, within the 25 MiB
    the safety factor leaves of the L2, and twice that in f64: the
    condition holds for f32 elements only."""
    shape = (16, 1200, 1200)
    f32 = gpu_stencil_ecm(LC.JACOBI3D, shape, H100_SXM, 4)
    f64 = gpu_stencil_ecm(LC.JACOBI3D, shape, H100_SXM, 8)
    lups = np.prod(shape)
    assert f32.t_hbm * H100_SXM.hbm_bytes_per_s / lups == pytest.approx(8)
    assert f64.t_hbm * H100_SXM.hbm_bytes_per_s / lups == pytest.approx(32)


def test_gpu_stencil_ecm_rejects_a_wrong_shape():
    with pytest.raises(ValueError):
        gpu_stencil_ecm(LC.JACOBI2D, (8, 8, 8), H100_SXM, 4)


#: (shape, HBM streams): where no layer condition holds in the card's L2,
#: the whole-array kernel reads its CTA's 8 + 2 rows once per 8 rows of
#: output; a held condition is untouched
NO_CONDITION = [((64, 4_400_000), 2.25), ((64, 2_000_000), 2),
                ((4, 3_000_000, 3_000_000), 4.25), ((64, 2048, 2048), 4)]


@pytest.mark.parametrize("shape,streams", NO_CONDITION)
def test_gpu_stencil_streams_where_no_condition_holds(shape, streams):
    from repro_torch.core.gpu_ecm import GRID_CTA_ROWS

    dim = len(shape)
    spec = dataclasses.replace(LC.STENCILS[f"jacobi{dim}d"], elem_bytes=4)
    assert GRID_CTA_ROWS == 8
    assert stencil_hbm_streams(spec, shape, H100_SXM) == streams
    m = gpu_stencil_ecm(spec, shape, H100_SXM, 4)
    assert m.t_hbm * H100_SXM.hbm_bytes_per_s / np.prod(shape) == \
        pytest.approx(4 * streams)
    # the halo pipeline's tile holds the condition whatever the width
    block = {2: (1024,), 3: (16, 64)}[dim]
    assert stencil_hbm_streams(spec, shape, H100_SXM, block=block) == 2
