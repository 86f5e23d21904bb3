"""The port stands alone: no module of ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and importing the port
leaves JAX out of the process."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks")


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert (ROOT / "src/repro_torch/kernels/csrc/stream.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/csrc/pipeline.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/csrc/stencil.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/csrc/matmul.cu").exists()
    assert (ROOT / "src/repro_torch/kernels/csrc/attention.cu").exists()
    assert ROOT / "src/repro_torch/benchmarks/gpu_stencil_ecm.py" in PORT_FILES
    assert ROOT / "src/repro_torch/core/layer_condition.py" in PORT_FILES
    for f in ("benchmarks/gpu_compute_ecm.py", "core/workload.py",
              "core/autotune.py", "kernels/matmul/ops.py",
              "kernels/attention/ops.py", "core/calibrate.py",
              "core/diskcache.py", "core/saturation.py",
              "benchmarks/gpu_calibrate.py", "benchmarks/gpu_scaling_ecm.py",
              "launch/calibrate.py", "core/scaling.py", "core/energy.py",
              "benchmarks/power.py", "benchmarks/gpu_energy_ecm.py",
              "models/common.py", "models/attention.py", "models/lm.py",
              "configs/base.py", "configs/_lm_family.py", "configs/__init__.py",
              "configs/internlm2_1_8b.py", "configs/minitron_4b.py",
              "configs/glm4_9b.py", "configs/qwen1_5_110b.py",
              "launch/serve.py", "models/moe.py", "models/mamba2.py",
              "models/zamba2.py", "configs/granite_moe_1b.py",
              "configs/qwen3_moe_235b.py", "configs/pixtral_12b.py",
              "configs/zamba2_1_2b.py", "models/xlstm.py",
              "models/xlstm_lm.py", "models/whisper.py",
              "configs/xlstm_125m.py", "configs/whisper_base.py",
              "kernels/autograd.py", "optim/__init__.py", "optim/adamw.py",
              "optim/schedule.py", "data/__init__.py", "data/pipeline.py",
              "data/arch_data.py", "ckpt/__init__.py", "ckpt/checkpoint.py",
              "train/__init__.py", "train/steps.py", "train/driver.py",
              "train/elastic.py", "dist/__init__.py", "dist/sharding.py",
              "dist/collectives.py", "launch/mesh.py", "launch/train.py",
              "serve/__init__.py", "serve/policy.py", "serve/trace.py",
              "serve/faults.py", "serve/engine.py"):
        assert ROOT / "src/repro_torch" / f in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.kernels\n"
        "import repro_torch.benchmarks.gpu_stream_ecm\n"
        "import repro_torch.benchmarks.gpu_stencil_ecm\n"
        "import repro_torch.kernels.stencil.ops\n"
        "import repro_torch.core.layer_condition\n"
        "import repro_torch.benchmarks.gpu_compute_ecm\n"
        "import repro_torch.kernels.matmul.ops, repro_torch.kernels.attention.ops\n"
        "import repro_torch.core.autotune, repro_torch.core.workload\n"
        "import repro_torch.core.calibrate, repro_torch.core.diskcache\n"
        "import repro_torch.core.saturation, repro_torch.launch.calibrate\n"
        "import repro_torch.benchmarks.gpu_calibrate\n"
        "import repro_torch.benchmarks.gpu_scaling_ecm\n"
        "import repro_torch.core.scaling, repro_torch.core.energy\n"
        "import repro_torch.benchmarks.power\n"
        "import repro_torch.benchmarks.gpu_energy_ecm\n"
        "import repro_torch.models.common, repro_torch.models.attention\n"
        "import repro_torch.models.lm, repro_torch.launch.serve\n"
        "import repro_torch.models.moe, repro_torch.models.mamba2\n"
        "import repro_torch.models.zamba2\n"
        "import repro_torch.models.xlstm, repro_torch.models.xlstm_lm\n"
        "import repro_torch.models.whisper\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.ckpt\n"
        "import repro_torch.train, repro_torch.kernels.autograd\n"
        "import repro_torch.train.driver, repro_torch.train.elastic\n"
        "import repro_torch.dist, repro_torch.launch.mesh\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.serve, repro_torch.serve.policy\n"
        "import repro_torch.serve.trace, repro_torch.serve.faults\n"
        "import repro_torch.serve.engine\n"
        "from repro_torch.configs import all_archs\n"
        "all_archs(); all_archs(smoke=True)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_needs_cuda_and_the_repo(tmp_path):
    """Without a card chip_smoke.py fails and prints no result; alone in
    a directory it fails too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
