"""``chip_smoke.py`` phase 15's card-against-CPU gate on the CPU: its CPU
side runs in a fresh process with its threads and MKL branch fixed before
torch loads (``_cpu_gate_reference``), and two such runs give the same
bits.  At the smoke config; the card's side needs the card."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cpu_gate_reference_gives_the_same_bits_twice(chip_smoke, tmp_path):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.steps import init_state

    cs = chip_smoke
    first = cs._cpu_gate_reference(str(tmp_path), smoke=True)
    second = cs._cpu_gate_reference(str(tmp_path), smoke=True)
    assert first["sha256"] == second["sha256"]
    assert (first["loss"], first["grad_norm"]) == \
        (second["loss"], second["grad_norm"])
    assert cs._digest(first["grads"]) == first["sha256"]["grads"]
    assert cs._digest(first["params"]) == first["sha256"]["params"]
    assert first["threads"] == cs.CPU_GATE_THREADS
    assert first["env"] == cs.CPU_GATE_ENV
    assert not list(tmp_path.iterdir())
    # the card's side starts from the state this process draws
    state = init_state(cs._gate_arch(smoke=True),
                       torch.Generator().manual_seed(cs.SEED), AdamWConfig(),
                       device="cpu")
    assert cs._digest(state["params"]) == first["sha256"]["init"]
    assert first["sha256"]["params"] != first["sha256"]["init"]
