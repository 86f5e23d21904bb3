"""The port's training launcher (``repro_torch/launch/train.py``): the
reference's flags and printed JSON keys at the smoke config on the CPU
(``--device cpu``, a one-rank gloo host mesh that the launcher starts
and stops), a resumed run from its checkpoints, the card by default
(it raises without one) and the production meshes' refusal on a world
of the wrong size."""
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.launch import train  # noqa: E402

KEYS = ["arch", "steps", "first_loss", "final_loss", "stragglers"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke steps are tiny: one intra-op thread keeps them from
    oversubscribing a machine that runs other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(capsys, *argv) -> dict:
    assert train.main(list(argv)) == 0
    assert not dist.is_initialized()
    return json.loads(capsys.readouterr().out)


def test_cli_trains_on_the_cpu_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-interval", "2"]
    out = _run(capsys, *argv)
    assert list(out) == KEYS
    assert out["arch"] == "internlm2-1.8b" and out["steps"] == 4
    assert all(isinstance(out[k], float) for k in ("first_loss", "final_loss"))
    assert out["stragglers"] == []
    assert sorted(p.name for p in (tmp_path / "internlm2-1.8b").iterdir()) == [
        "step_00000002", "step_00000004"]
    more = _run(capsys, *argv[:3], "6", *argv[4:])
    assert more["steps"] == 6          # resumed at 4: two more steps
    assert more["first_loss"] != out["first_loss"]


@pytest.mark.parametrize("moments", ["bf16", "int8"])
def test_cli_moment_dtypes_and_accum(tmp_path, capsys, moments):
    out = _run(capsys, "--device", "cpu", "--arch", "granite-moe-1b-a400m",
               "--steps", "2", "--batch", "4", "--seq", "16", "--accum", "2",
               "--moment-dtype", moments, "--ckpt-dir", str(tmp_path))
    assert out["arch"] == "granite-moe-1b-a400m" and out["steps"] == 2


def test_cli_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("mesh, ranks", [("single-pod", 256),
                                         ("multi-pod", 512)])
def test_cli_production_mesh_refuses(tmp_path, mesh, ranks):
    with pytest.raises(ValueError, match=f"needs {ranks} ranks; the process "
                                         f"group has 1"):
        train.main(["--device", "cpu", "--mesh", mesh, "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    assert not dist.is_initialized()
