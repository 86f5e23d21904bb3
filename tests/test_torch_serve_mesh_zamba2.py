"""The port's zamba2 served on a mesh against the reference's sharded serve
(tests/_torch_serve_mesh.py): zamba2-1.2b at smoke size, f32, on four
ranks, on ``(1, 4)`` and ``(2, 2)``.  Each rank's Mamba2 mixers compute
its own heads (``mamba2_layer`` on blocks: the SSD takes 8 / model heads),
``in_proj``'s columns gathered as the weight at prefill and as the
product in decode, the conv cache's blocks straddling the heads; the
shared block's attention on the rank's heads.  The prefill logits and
four decode steps' logits agree at 2e-3 on every rank, the greedy tokens
are equal, and each rank's blocks of every final cache leaf (``ssm``,
``conv``, ``k``, ``v``) equal the reference's blocks.  On a one-rank
``(1, 1)`` mesh the launcher's ``serve`` is bit-equal to ``mesh=None`` in
f32 and bf16.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import spawn  # noqa: E402
from _torch_serve_mesh import compare, one_rank, run  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402

ARCH = "zamba2-1.2b"
CASES = [((1, 4), "f32"), ((2, 2), "f32")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return run(ARCH, None, CASES, tmp_path_factory.mktemp("serve_mesh_zamba2"))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_sharded_serve_equals_the_references(served, case):
    compare(*served, [case])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_each_rank_mixes_its_own_heads(served, case):
    """Every prefill SSD a rank runs takes its share of the Mamba2 heads,
    one call a layer: the mixer is split over ``model``, not repeated."""
    cfg = get_arch(ARCH, smoke=True).cfg
    (_, model), dtype = case
    for got in served[1]:
        heads = got[f"1x4_{dtype}/ssd_heads" if model == 4 else
                    f"2x2_{dtype}/ssd_heads"]
        assert heads.tolist() == [cfg.mamba_cfg.n_heads // model] * cfg.n_layers


@pytest.fixture(scope="module")
def one_rank_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("one_rank_zamba2")
    spawn(one_rank, 1, out, str(out), ((ARCH, None),), timeout=110)
    return json.loads((out / "one_rank.json").read_text())


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_one_rank_mesh_is_bit_equal_to_no_mesh(one_rank_runs, dtype):
    assert one_rank_runs[f"{ARCH} {dtype}"] == {
        "logits": True, "tokens": True, "cache": True, "length": True}
