"""The port's train step on the hybrid (zamba2-1.2b), recurrent
(xlstm-125m) and encoder-decoder (whisper-base) families (the others are
tests/test_torch_train.py and test_torch_train_moe.py, the shared cases
tests/_torch_train.py): ``remat`` full against none, and the reference's
oracles ``test_train_step_smoke`` and ``test_loss_decreases_smoke``
(tests/test_archs_smoke.py)."""
import pytest

pytest.importorskip("torch")

from _torch_train import (  # noqa: E402
    check_loss_decreases_smoke, check_remat_gives_the_same_grads,
    check_train_step_smoke, family_archs)

ARCHS = family_archs("hybrid", "ssm", "audio")


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_grads(name):
    check_remat_gives_the_same_grads(name, ("full",))


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_smoke(name):
    check_train_step_smoke(name)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_decreases_smoke(name):
    check_loss_decreases_smoke(name)
