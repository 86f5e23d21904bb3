"""The port's xLSTM served on a mesh against the reference's sharded serve
(tests/_torch_serve_mesh.py): xlstm-125m at smoke size, f32, on four
ranks, on ``(1, 4)`` and ``(2, 2)``.  Its ``dp_vocab`` profile splits the
vocabulary over ``model`` and nothing else of the blocks: every weight is
gathered where it is used and each rank computes its rows with every
head.  The states are placed by the input profile, their heads over
``model`` where they divide it (``(2, 2)``: a rank writes its heads'
block and reads the gathered state in decode).  The prefill logits and
four decode steps' logits agree at 2e-3 on every rank, the greedy tokens
are equal, and each rank's blocks of every final state leaf equal the
reference's blocks.  On a one-rank ``(1, 1)`` mesh the launcher's
``serve`` is bit-equal to ``mesh=None`` in f32 and bf16.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_serve_mesh import compare, one_rank, run  # noqa: E402

ARCH = "xlstm-125m"
CASES = [((1, 4), "f32"), ((2, 2), "f32")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run(ARCH, None, CASES, tmp_path_factory.mktemp("serve_mesh_xlstm"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_sharded_serve_equals_the_references(served, case):
    compare(*served, [case])


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("one_rank_xlstm")
    spawn(one_rank, 1, out, str(out), ((ARCH, None),), timeout=110)
    return json.loads((out / "one_rank.json").read_text())


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank_runs, dtype):
    assert one_rank_runs[f"{ARCH} {dtype}"] == {
        "logits": True, "tokens": True, "cache": True, "length": True}
