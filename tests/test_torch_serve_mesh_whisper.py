"""The port's whisper served on a mesh against the reference's sharded
serve (tests/_torch_serve_mesh.py): whisper-base at smoke size, f32, on
four ranks.  On ``(1, 4)`` its 2 heads do not divide ``model``: the
attention runs every head, the caches are split by sequence (the self
cache decoded by the flash decode, the cross cache's softmax completed
over ``model``); on ``(2, 2)`` the heads and both caches split over
``model``.  The MLP is column- then row-parallel and the tied
vocabulary split in the embedding and the logits.  The prefill logits
and four decode steps' logits agree at 2e-3 on every rank, the greedy
tokens are equal, and each rank's blocks of every final cache leaf
(``self_k``, ``self_v``, ``cross_k``, ``cross_v``) equal the reference's
blocks.  On a one-rank ``(1, 1)`` mesh the launcher's ``serve`` is
bit-equal to ``mesh=None`` in f32 and bf16.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_serve_mesh import compare, one_rank, run  # noqa: E402

ARCH = "whisper-base"
CASES = [((1, 4), "f32"), ((2, 2), "f32")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run(ARCH, None, CASES, tmp_path_factory.mktemp("serve_mesh_whisper"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_sharded_serve_equals_the_references(served, case):
    compare(*served, [case])


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("one_rank_whisper")
    spawn(one_rank, 1, out, str(out), ((ARCH, None),), timeout=110)
    return json.loads((out / "one_rank.json").read_text())


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank_runs, dtype):
    assert one_rank_runs[f"{ARCH} {dtype}"] == {
        "logits": True, "tokens": True, "cache": True, "length": True}
