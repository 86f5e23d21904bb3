"""As tests/test_torch_train_lm.py, for the hybrid (zamba2: the Mamba2
SSD chunks and the shared attention block checkpointed), recurrent
(xlstm-125m: the mLSTM chunks and each block) and encoder-decoder
(whisper-base: each encoder and decoder layer, chunked self- and
cross-attention) smoke archs."""
import pytest

pytest.importorskip("torch")

from test_torch_train_lm import check_against_reference  # noqa: E402

FAMILIES = ("zamba2-1.2b", "xlstm-125m", "whisper-base")


@pytest.mark.parametrize("name", FAMILIES)
def test_grads_and_step_match_reference(name):
    check_against_reference(name, seed=10 + FAMILIES.index(name))
