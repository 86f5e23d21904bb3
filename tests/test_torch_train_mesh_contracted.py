"""tests/test_torch_train_mesh.py's cases from the contracted draw: the
state ``init_state`` draws with the attention projections rescaled to
the fan-in they contract over (``_torch_train_mesh.init``), as
tests/_torch_train.py draws the states it holds against the reference.
At ``init_state``'s own draw the scores' softmax is near one-hot and a
relative change of 6e-8 in the parameters moves the one-device
gradients by 2.4e-4 of their largest, so the gate on the share of
entries left out of the parameter comparison (at most 5 % of a leaf)
holds here only; ``_torch_train_mesh.check_case`` says which gates each
draw holds.  Four spawned gloo ranks, one spawn for the module.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_train_mesh import LM_CASES, WORLD, check_case, run_cases  # noqa: E402

CASES = LM_CASES


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_mesh_contracted")
    spawn(run_cases, WORLD, out, str(out), CASES, "contracted", timeout=420)
    return {case: [torch.load(out / f"{case}-rank{r}.pt", weights_only=False)
                   for r in range(WORLD)] for case in CASES}


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_one_device(case, ranks):
    check_case(ranks[case], CASES[case], "contracted")
