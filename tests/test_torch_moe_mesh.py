"""The port's MoE LM served on a mesh against the reference's sharded
serve (tests/_torch_serve_mesh.py): granite-moe-1b-a400m at smoke size
with ``impl="shard_map"`` on four ranks, on ``(2, 2)`` and ``(1, 4)``:
each model shard computes its local experts (4 and 2 of 8) on its data
shard's tokens, the expert weights FSDP'd over ``data`` by ``moe_ep``
and gathered in the compute dtype, the partial outputs all-reduced over
``model``.  The prefill logits and four decode steps' logits agree at
f32 2e-3 and bf16 6e-2 on every rank, the f32 greedy tokens are equal,
and each rank's cache blocks equal the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_serve_mesh import compare, run  # noqa: E402

CASES = [((2, 2), "f32"), ((1, 4), "f32"), ((2, 2), "bf16"),
         ((1, 4), "bf16")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run("granite-moe-1b-a400m", "shard_map", CASES,
               tmp_path_factory.mktemp("moe_mesh"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_sharded_moe_serve_equals_the_references(served, case):
    compare(*served, [case])
