"""The port's traced resources (``repro_torch.core.hlo``) and three-term
step model (``core/gpu_ecm.py`` ``GPUStepECM``) against the reference's
``repro.core.hlo`` and ``repro.core.tpu_ecm``, and the counters of
``analyze`` on the CPU.

* ``CollectiveOp``'s ring wire bytes and ``HLOResources``' sums equal the
  reference's for every kind and group, the degenerate ones too.
* ``GPUStepECM``, ``from_resources`` and ``saturation_chips`` equal the
  reference's float for float on a machine carrying ``TPU_V5E``'s rates
  (its one ICI link as NVLink, its DCN as the network).
* ``analyze``: a smoke arch's FLOPs traced on fake tensors equal
  ``FlopCounterMode`` on the real CPU step, and so do the bytes; the
  memory of a known program; the flash op on fake CUDA tensors launches
  nothing and counts the plain version's FLOPs, also when a model
  imports it inside the trace.
* The collectives of DTensor code on a fake world, in a subprocess (one
  default process group a process): kinds, groups and bytes.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hlo as RH  # noqa: E402
from repro.core import tpu_ecm as RT  # noqa: E402
from repro.core.machine import TPU_V5E  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import gpu_ecm as G  # noqa: E402
from repro_torch.core import hlo as H  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.models.common import abstract, materialize  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.steps import (make_prefill_step,  # noqa: E402
                                     make_train_step, state_spec)

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")
#: a port machine carrying the reference TPU's rates: its bf16 peak, its
#: HBM, one ICI link (the reference's ``from_resources`` default) as
#: NVLink and its DCN as the network; exposed fractions the TPU's
TPU_RATES = dataclasses.replace(
    H100_SXM, peak_bf16_tensor_flops=TPU_V5E.peak_bf16_flops,
    hbm_bytes_per_s=TPU_V5E.hbm_bytes_per_s,
    nvlink_bytes_per_s=TPU_V5E.ici_link_bytes_per_s,
    net_bytes_per_s=TPU_V5E.dcn_bytes_per_s,
    exposed_link_fraction=TPU_V5E.exposed_ici_fraction,
    exposed_hbm_fraction=TPU_V5E.exposed_hbm_fraction)


def _pairs(ops):
    return ([H.CollectiveOp(k, b, g) for k, b, g in ops],
            [RH.CollectiveOp(k, b, g) for k, b, g in ops])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("group", [0, 1, 2, 3, 16, 512])
def test_wire_bytes_equal_reference(kind, group):
    ours, ref = _pairs([(kind, 1024.0 * 3 + 7, group)])
    assert ours[0].wire_bytes_per_chip == ref[0].wire_bytes_per_chip


def test_resources_sums_equal_reference():
    rng = np.random.default_rng(0)
    ops = [(KINDS[i % 5], float(rng.integers(1, 1 << 30)), int(g))
           for i, g in enumerate(rng.integers(1, 64, 20))]
    ours, ref = _pairs(ops)
    a = H.HLOResources(flops=1e12, bytes_accessed=2e9, collectives=ours)
    b = RH.HLOResources(flops=1e12, bytes_accessed=2e9, collectives=ref)
    assert a.by_kind() == b.by_kind()
    assert a.wire_bytes_per_chip == b.wire_bytes_per_chip
    assert a.collective_bytes == b.collective_bytes


@pytest.mark.parametrize("fractions", [(1.0, 1.0), (0.0, 0.0), (0.3, 0.7),
                                       (1.0, 0.0)])
def test_step_model_equals_reference(fractions):
    f_link, f_hbm = fractions
    rng = np.random.default_rng(1)
    for _ in range(20):
        c, h, l, n = (float(x) for x in rng.uniform(0, 2, 4))
        ours = G.GPUStepECM("x", c, h, l, n, exposed_link_fraction=f_link,
                            exposed_hbm_fraction=f_hbm, model_flops=3.0,
                            hlo_flops=5.0)
        ref = RT.TPUStepECM("x", c, h, l, n, exposed_ici_fraction=f_link,
                            exposed_hbm_fraction=f_hbm, model_flops=3.0,
                            hlo_flops=5.0)
        assert (ours.t_ecm, ours.t_roofline, ours.dominant,
                ours.roofline_fraction, ours.useful_flops_fraction) == \
            (ref.t_ecm, ref.t_roofline, ref.dominant, ref.roofline_fraction,
             ref.useful_flops_fraction)
        for b in ("compute", "memory", "collective"):
            assert G.saturation_chips(ours, b) == RT.saturation_chips(ref, b)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("flops_are_global", [False, True])
def test_from_resources_equals_reference(multi_pod, flops_are_global):
    ops = [("all-reduce", 4.0e8, 16), ("all-gather", 3.0e8, 512),
           ("reduce-scatter", 2.5e8, 256), ("all-to-all", 1.0e8, 32),
           ("collective-permute", 5.0e7, 2)]
    ours, ref = _pairs(ops)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    got = G.from_resources(
        H.HLOResources(flops=3e15, bytes_accessed=7e12, collectives=ours),
        G.MeshSpec(shape, axes), name="c", machine=TPU_RATES,
        model_flops=1e15, flops_are_global=flops_are_global)
    want = RT.from_resources(
        RH.HLOResources(flops=3e15, bytes_accessed=7e12, collectives=ref),
        RT.MeshSpec(shape, axes), name="c", machine=TPU_V5E,
        model_flops=1e15, flops_are_global=flops_are_global)
    assert (got.t_comp, got.t_hbm, got.t_link, got.t_net, got.t_ecm,
            got.hlo_flops) == (want.t_comp, want.t_hbm, want.t_ici,
                               want.t_dcn, want.t_ecm, want.hlo_flops)
    assert (got.t_net > 0) == multi_pod
    s = got.summary()
    assert s["t_link_s"] == got.t_link and s["t_net_s"] == got.t_net
    assert G.MeshSpec(shape, axes).n_pods == (2 if multi_pod else 1)


def test_machine_fabric_priors():
    assert (H100_SXM.nvlink_bytes_per_s, H100_SXM.net_bytes_per_s) == \
        (450e9, 50e9)
    assert H100_SXM.exposed_link_fraction == 1.0
    assert G.fabric_rates(H100_SXM) == (450e9, 50e9)
    with pytest.raises(ValueError, match="network"):
        G.fabric_rates(dataclasses.replace(H100_SXM, net_bytes_per_s=None))


def test_machine_file_without_fabrics_loads_the_priors(tmp_path):
    from repro_torch.core.machine import (load_machine_file,
                                          save_machine_file)

    path = save_machine_file(H100_SXM, tmp_path / "m.json")
    doc = json.loads(path.read_text())
    for key in ("nvlink_bytes_per_s", "net_bytes_per_s",
                "exposed_link_fraction"):
        del doc["machine"][key]
    path.write_text(json.dumps(doc))
    assert load_machine_file(path) == H100_SXM


# ---------------------------------------------------------------------------
# analyze on the CPU
# ---------------------------------------------------------------------------

SMOKE = "internlm2-1.8b"


def _fake(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


def _real_and_fake(make):
    """``analyze`` of the step ``make(device, real)`` builds, on real CPU
    tensors and on fake ones, with ``FlopCounterMode``'s count of the real
    run beside."""
    from torch.utils.flop_counter import FlopCounterMode

    step, args = make(real=True)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    step, args = make(real=True)
    real = H.analyze(step, *args).resources

    def fake():
        step, args = make(real=False)
        return H.analyze(step, *args).resources
    return fc.get_total_flops(), real, _fake(fake)


def _batch(arch, shape, real):
    if not real:
        return arch.abstract_batch(shape, device="cpu")
    return {k: torch.as_tensor(v) for k, v in arch.make_batch(shape).items()}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_traced_flops_equal_flop_counter_on_the_real_step(kind):
    arch = get_arch(SMOKE, smoke=True)
    shape = ShapeSpec(kind, 32, 4, kind)
    opt = AdamWConfig()

    def make(real):
        gen = torch.Generator().manual_seed(0)
        if kind == "train":
            spec = state_spec(arch, opt)
            state = (materialize(spec, gen, device="cpu") if real
                     else abstract(spec, device="cpu"))
            step = make_train_step(arch, opt, accum=2)
            return step, (state, _batch(arch, shape, real))
        spec = arch.param_spec()
        params = (materialize(spec, gen, device="cpu") if real
                  else abstract(spec, device="cpu"))
        return (make_prefill_step(arch, max_len=shape.seq_len),
                (params, _batch(arch, shape, real)))

    counted, real, fake = _real_and_fake(make)
    assert counted > 0
    assert fake.flops == real.flops == counted
    assert fake.bytes_accessed == real.bytes_accessed > 0
    assert fake.transcendentals == real.transcendentals > 0
    assert not fake.collectives


def test_memory_of_a_known_program():
    n = 1000

    def step(x):
        y = x * 2           # a new buffer
        z = y + 1           # a second one, y still alive: the peak
        del y
        return z            # the output

    trace = H.analyze(step, torch.ones(n))
    m = H.memory_analysis_dict(trace)
    assert m == {"argument_size_in_bytes": 4.0 * n,
                 "output_size_in_bytes": 4.0 * n,
                 "temp_size_in_bytes": 4.0 * n,
                 "peak_size_in_bytes": 12.0 * n}
    # bytes: each op reads its input and writes its output
    assert trace.resources.bytes_accessed == 4 * 4.0 * n
    assert H.analyze(torch.exp, torch.ones(n)).resources.transcendentals == n


def test_flash_op_on_fake_cuda_counts_the_plain_version():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import kernels
    from repro_torch.kernels.attention import ops

    b, s, h, hkv, d = 2, 256, 8, 2, 64
    before = kernels.FLASH_ATTENTION.launches

    def fake():
        q = torch.empty(b, s, h, d, device="cuda")
        k = torch.empty(b, s, hkv, d, device="cuda")
        out = ops.flash_attention(q, k, k)
        assert out.shape == (b, s, h, d) and out.device.type == "cuda"
        return H.analyze(ops.flash_attention, q, k, k).resources.flops
    traced = _fake(fake)
    assert kernels.FLASH_ATTENTION.launches == before
    q, k = torch.randn(b, s, h, d), torch.randn(b, s, hkv, d)
    with FlopCounterMode(display=False) as fc:
        ops.flash_attention(q, k, k)
    assert traced == fc.get_total_flops() == 4 * b * h * s * s * d


_COLLECTIVES = r"""
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.core import hlo
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import make_production_mesh

with fake_world(256):
    mesh = make_production_mesh(device="cpu")
    def step(x, g):
        whole = DTensor.from_local(x, mesh, [Replicate(), Shard(0)],
                                   run_check=False).full_tensor()
        red = DTensor.from_local(g, mesh, [Partial("avg"), Replicate()],
                                 run_check=False).redistribute(
            mesh, [Shard(0), Replicate()]).to_local()
        dist.all_reduce(g, group=mesh.get_group(1))
        return whole, red
    with FakeTensorMode():
        x = torch.empty(8, 32)
        g = torch.empty(64, 32, dtype=torch.bfloat16)
        res = hlo.analyze(step, x, g).resources
print(json.dumps([[c.kind, c.out_bytes, c.group_size, c.wire_bytes_per_chip]
                  for c in res.collectives]))
"""


def test_collectives_of_a_fake_world():
    """The mesh's ``model`` axis gathers a sharded leaf (16 x 8 rows of 32
    f32), the ``data`` axis reduce-scatters a bf16 partial sum, and a
    ``c10d`` all-reduce runs on the model group: kinds, groups, output
    bytes and ring wire bytes."""
    out = subprocess.run(
        [sys.executable, "-c", _COLLECTIVES], capture_output=True, text=True,
        timeout=240, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "GLOO_SOCKET_IFNAME": "lo"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want = [("all-gather", 16 * 8 * 32 * 4.0, 16),
            ("reduce-scatter", 4 * 32 * 2.0, 16),
            ("all-reduce", 64 * 32 * 2.0, 16)]
    assert [tuple(c[:3]) for c in got] == want
    assert [c[3] for c in got] == [H.CollectiveOp(*w).wire_bytes_per_chip
                                   for w in want]


_LAZY = r"""
import sys, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.core import hlo
assert "repro_torch.kernels.attention.ops" not in sys.modules

def step(q, k):
    from repro_torch.kernels.attention.ops import flash_attention
    return flash_attention(q, k, k)

with FakeTensorMode():
    q = torch.empty(2, 256, 8, 64, device="cuda")
    k = torch.empty(2, 256, 2, 64, device="cuda")
    print(hlo.analyze(step, q, k).resources.flops)
"""


def test_flash_op_counted_when_a_model_imports_it_inside_the_trace():
    """A model imports the flash op inside its first call, after the trace's
    counter was made (a counter copies the formula registry when made);
    ``flop_counter`` imports the op first, so the trace counts it."""
    out = subprocess.run([sys.executable, "-c", _LAZY], capture_output=True,
                         text=True, timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert float(out.stdout.strip().splitlines()[-1]) == \
        4 * 2 * 8 * 256 * 256 * 64
