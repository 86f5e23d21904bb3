"""The tensor- and data-parallel train step of the families outside
``models/lm.py`` on a ``(2, 2)`` ``("data", "model")`` mesh against the
one-device step, on four spawned gloo ranks (one spawn for the module),
from the contracted draw at its gates (tests/_torch_train_mesh.py
``check_case``; at ``init_state``'s own draw whisper's near one-hot
scores part the grad norms by 1.1e-4):

* whisper-base under ``tp_dp``: the encoder and both decoder attentions
  on the rank's heads, the MLPs column- then row-parallel, the tied
  vocabulary split over ``model`` (its gradient the embedding's rows and
  the unembedding's columns added);
* xlstm-125m under ``dp_vocab``: every block replicated over ``model``
  (each model rank the whole block, its gradient summed over the axis),
  the vocabulary split.

tests/test_torch_train_families.py holds the one-device step against
the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_train_mesh import WORLD, check_case, run_cases  # noqa: E402

#: name -> (arch, moments, profile, mesh shape, multi-pod, accum)
CASES = {
    "whisper": ("whisper-base", "f32", "tp_dp", (2, 2), False, 1),
    "xlstm": ("xlstm-125m", "f32", "dp_vocab", (2, 2), False, 1),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh_families")
    spawn(run_cases, WORLD, out, str(out), CASES, "contracted",
          timeout=300)
    return {case: [torch.load(out / f"{case}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)] for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_one_device(case, ranks):
    check_case(ranks[case], CASES[case], "contracted")
