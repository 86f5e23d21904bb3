"""The port's dense LM served on a mesh against the reference's sharded
serve (tests/_torch_serve_mesh.py): internlm2-1.8b at smoke size on four
ranks, on ``(1, 4)`` (two KV heads on a four-way ``model`` axis: the
cache split by sequence, decode through ``_flash_decode``) and on
``(2, 2)`` (the KV heads split over ``model``, the batch over ``data``).
The prefill logits and four decode steps' logits agree at f32 2e-3 and
bf16 6e-2 on every rank, the f32 greedy tokens are equal, and each
rank's blocks of the final caches equal the reference's blocks.  On a
one-rank ``(1, 1)`` mesh (every collective on a one-rank group) the
launcher's ``serve`` is bit-equal to ``mesh=None`` for the dense, MoE
(``shard_map``), QKV-bias (``tp_fsdp``) and multimodal smoke archs.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_serve_mesh import ONE_RANK, compare, one_rank, run  # noqa: E402

CASES = [((1, 4), "f32"), ((2, 2), "f32"), ((1, 4), "bf16"),
         ((2, 2), "bf16")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run("internlm2-1.8b", None, CASES,
               tmp_path_factory.mktemp("serve_mesh"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_sharded_serve_equals_the_references(served, case):
    compare(*served, [case])


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("one_rank")
    spawn(one_rank, 1, out, str(out), timeout=110)
    return json.loads((out / "one_rank.json").read_text())


@pytest.mark.parametrize("name", [n for n, _ in ONE_RANK])
@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank_runs, name, dtype):
    assert one_rank_runs[f"{name} {dtype}"] == {
        "logits": True, "tokens": True, "cache": True, "length": True}
