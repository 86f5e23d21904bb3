"""The port's checkpointing (``repro_torch/ckpt``) against the
reference's (``repro/ckpt``): the reference's six oracles
(tests/test_ckpt.py) on the port; each side restoring what the other
saved, f32, int8-moment and bf16 trees, with the same files byte for byte
and the same manifest; the port restoring the reference's bf16 file,
which the reference itself cannot (``jnp.asarray`` of the ``|V2`` array
it loads raises: ROADMAP §3); and an ``AsyncCheckpointer`` snapshot that
a later in-place change of the tree does not reach."""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import restore_tree as ref_restore  # noqa: E402
from repro.ckpt import save_tree as ref_save  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    AsyncCheckpointer,
    CheckpointManager,
    latest_step,
    restore_tree,
    save_tree,
)
from repro_torch.ckpt.checkpoint import list_steps, prune  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402


def _tree(x=1.0):
    return {"params": {"w": torch.full((4, 3), x), "b": torch.zeros((3,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _restore(root, step, like):
    return restore_tree(root, step, like, device="cpu")


# ---------------------------------------------------------------------------
# the reference's oracles
# ---------------------------------------------------------------------------


def test_roundtrip(tmp_path):
    root = str(tmp_path)
    t = _tree(2.5)
    save_tree(root, 10, t, metadata={"loss": 0.5})
    got, meta = _restore(root, 10, t)
    assert meta["loss"] == 0.5
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_atomic_staging_never_visible(tmp_path):
    root = str(tmp_path)
    save_tree(root, 1, _tree())
    stale = os.path.join(root, "step_00000002.tmp-999")
    os.makedirs(stale)
    assert list_steps(root) == [1]          # staging invisible
    save_tree(root, 3, _tree())             # next save GCs it
    assert not os.path.exists(stale)
    assert latest_step(root) == 3


def test_prune_keeps_last(tmp_path):
    root = str(tmp_path)
    for s in (1, 2, 3, 4):
        save_tree(root, s, _tree(float(s)))
    prune(root, keep_last=2)
    assert list_steps(root) == [3, 4]


def test_manager_interval(tmp_path):
    m = CheckpointManager(str(tmp_path), interval=5, keep_last=2)
    for s in range(1, 12):
        m.maybe_save(s, _tree(float(s)))
    assert list_steps(str(tmp_path)) == [5, 10]
    s, tree, meta = m.restore_latest(_tree(), device="cpu")
    assert s == 10 and float(tree["params"]["w"][0, 0]) == 10.0


def test_restore_corrupt_manifest_raises(tmp_path):
    root = str(tmp_path)
    save_tree(root, 1, _tree())
    with open(os.path.join(root, "step_00000001", "manifest.json"), "w") as f:
        f.write("{")
    with pytest.raises(json.JSONDecodeError):
        _restore(root, 1, _tree())


def test_async_checkpointer(tmp_path):
    ac = AsyncCheckpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3):
        ac.submit(s, _tree(float(s)), metadata={"s": s})
    ac.close()
    assert list_steps(str(tmp_path)) == [2, 3]
    got, meta = _restore(str(tmp_path), 3, _tree())
    assert meta["s"] == 3
    assert float(got["params"]["w"][0, 0]) == 3.0


# ---------------------------------------------------------------------------
# the reference's format, both ways
# ---------------------------------------------------------------------------


def _state(moments: str) -> dict:
    """A train state of the reference's layout as numpy (bf16 leaves as
    ml_dtypes arrays, as ``np.asarray`` of a JAX array gives them)."""
    rng = np.random.default_rng(0)
    params = {"layers": {"wq": rng.standard_normal((2, 4, 3)).astype(np.float32),
                         "scale": np.ones((2, 4), np.float32)},
              "embedding": rng.standard_normal((5, 4)).astype(np.float32)}

    def moment(p):
        if moments == "int8":
            return {"q": rng.integers(-127, 128, p.shape).astype(np.int8),
                    "scale": rng.random((*p.shape[:-1], 1)).astype(np.float32)}
        m = rng.standard_normal(p.shape).astype(np.float32)
        return (np.asarray(jnp.asarray(m, jnp.bfloat16)) if moments == "bf16"
                else m)

    return {"params": params,
            "opt_state": {"mu": jax.tree.map(moment, params),
                          "nu": jax.tree.map(moment, params),
                          "count": np.asarray(3, np.int32)},
            "step": np.asarray(3, np.int32)}


def _files(d: str) -> dict:
    return {f: open(os.path.join(d, f), "rb").read() for f in os.listdir(d)}


@pytest.mark.parametrize("moments", ["f32", "int8", "bf16"])
def test_port_and_reference_write_the_same_files(tmp_path, moments):
    state = _state(moments)
    ours, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    save_tree(ours, 3, state_from_numpy(state, device="cpu"),
              metadata={"arch": "x"})
    ref_save(ref, 3, jax.tree.map(jnp.asarray, state), metadata={"arch": "x"})
    got, want = _files(f"{ours}/step_00000003"), _files(f"{ref}/step_00000003")
    assert got == want
    manifest = json.loads(got["manifest.json"])
    if moments == "int8":
        assert "opt_state/mu/layers/wq/q" in manifest["leaves"]
    if moments == "bf16":
        ent = manifest["leaves"]["opt_state/mu/embedding"]
        assert ent["dtype"] == "bfloat16"
        assert b"'descr': '<V2'" in got[ent["file"]]


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_cross_restore_both_ways(tmp_path, moments):
    state = _state(moments)
    port_state = state_from_numpy(state, device="cpu")
    save_tree(str(tmp_path / "port"), 3, port_state)
    got, _ = ref_restore(str(tmp_path / "port"), 3,
                         jax.tree.map(jnp.asarray, state))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)
    ref_save(str(tmp_path / "ref"), 3, jax.tree.map(jnp.asarray, state))
    back, _ = _restore(str(tmp_path / "ref"), 3, port_state)
    for a, b in zip(tree_leaves(back), tree_leaves(port_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_restores_the_references_bf16(tmp_path):
    """The reference writes a bf16 leaf as ``'<V2'`` and cannot load it
    back (its ``restore_tree`` raises); the port restores it by the
    manifest's dtype, bit for bit."""
    state = _state("bf16")
    root = str(tmp_path)
    ref_save(root, 3, jax.tree.map(jnp.asarray, state))
    with pytest.raises(TypeError):
        ref_restore(root, 3, jax.tree.map(jnp.asarray, state))
    port_state = state_from_numpy(state, device="cpu")
    back, _ = _restore(root, 3, port_state)
    mu = back["opt_state"]["mu"]["embedding"]
    assert mu.dtype == torch.bfloat16
    for a, b in zip(tree_leaves(back), tree_leaves(port_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_snapshot_is_not_reached_by_later_changes(tmp_path):
    """``submit`` copies the tree before it queues it: an in-place change
    made while the snapshot waits (as the in-place optimizer makes) does
    not reach the file."""
    gate = threading.Event()
    ac = AsyncCheckpointer(str(tmp_path))
    ac._q.put((0, {"x": torch.zeros(1)}, None))   # holds the writer ...
    real_save = save_tree

    def slow_save(*a, **kw):
        gate.wait(10)
        return real_save(*a, **kw)

    import repro_torch.ckpt.checkpoint as C
    C.save_tree, saved = slow_save, C.save_tree
    try:
        tree = _tree(1.0)
        ac.submit(5, tree)
        tree["params"]["w"].add_(100.0)             # ... while this waits
        tree["step"].fill_(0)
        gate.set()
        ac.close()
    finally:
        C.save_tree = saved
    got, _ = _restore(str(tmp_path), 5, tree)
    assert float(got["params"]["w"].max()) == 1.0 and int(got["step"]) == 7


def test_close_raises_on_a_wedged_writer(tmp_path):
    ac = AsyncCheckpointer(str(tmp_path))
    gate = threading.Event()
    ac._q.put((0, {}, None))
    import repro_torch.ckpt.checkpoint as C
    real, C.save_tree = C.save_tree, lambda *a, **kw: gate.wait(30)
    try:
        ac._q.join = lambda: None                    # skip the drain
        with pytest.raises(RuntimeError, match="wedged"):
            ac.close(timeout=0.2)
    finally:
        gate.set()
        C.save_tree = real
