"""The port's data pipeline (``repro_torch/data``) against the
reference's (``repro/data``): every batch bit for bit, for the synthetic
LM stream (several steps, seeds and structures), a token file (a
temporary one, uint16 and int32, over an epoch boundary) and the
arch-aware dataset over all ten archs' smoke configs (patch embeddings,
frames, the prefix padding of labels and mask); and its batches carried
to tensors by ``convert.batch_from_numpy`` bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.data import DataConfig as RefConfig  # noqa: E402
from repro.data import SyntheticLMDataset as RefLM  # noqa: E402
from repro.data import TokenFileDataset as RefFile  # noqa: E402
from repro.data.arch_data import ArchSyntheticDataset as RefArchData  # noqa: E402
from repro_torch.configs import ARCH_NAMES, ShapeSpec, get_arch  # noqa: E402
from repro_torch.convert import batch_from_numpy  # noqa: E402
from repro_torch.data import (  # noqa: E402
    ArchSyntheticDataset,
    DataConfig,
    SyntheticLMDataset,
    TokenFileDataset,
)


def _equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


@pytest.mark.parametrize("cfg", [
    dict(global_batch=4, seq_len=32, vocab=128, seed=5),
    dict(global_batch=3, seq_len=17, vocab=1000, seed=0, structure=0.3),
    dict(global_batch=2, seq_len=64, vocab=92544, seed=11)], ids=str)
def test_synthetic_lm_batches_equal_reference(cfg):
    ours, ref = SyntheticLMDataset(DataConfig(**cfg)), RefLM(RefConfig(**cfg))
    assert np.array_equal(ours._succ, ref._succ)
    for step in (0, 1, 7, 123456):
        _equal(ours.batch(step), ref.batch(step))
    gen = ours.batches(start_step=3)
    _equal(next(gen), ref.batch(3))
    _equal(next(gen), ref.batch(4))


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_token_file_batches_equal_reference(tmp_path, dtype):
    path = str(tmp_path / "tokens.bin")
    (np.arange(5000, dtype=np.int64) * 7919 % 30000).astype(dtype).tofile(path)
    cfg = dict(global_batch=3, seq_len=64, vocab=30000, seed=2)
    ours = TokenFileDataset(path, DataConfig(**cfg), dtype=dtype)
    ref = RefFile(path, RefConfig(**cfg), dtype=dtype)
    assert ours.n_windows == ref.n_windows
    per_epoch = ours.n_windows // 3
    for step in (0, 1, per_epoch - 1, per_epoch, 3 * per_epoch + 2):
        _equal(ours.batch(step), ref.batch(step))
    with pytest.raises(ValueError):
        TokenFileDataset(path, DataConfig(global_batch=100, seq_len=64,
                                          vocab=30000), dtype=dtype)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_batches_equal_reference(name):
    shape = ("t", 32, 2, "train")
    ours = ArchSyntheticDataset(get_arch(name, smoke=True), ShapeSpec(*shape),
                                seed=3)
    ref = RefArchData(ref_arch(name, smoke=True), RefShape(*shape), seed=3)
    for step in (0, 5):
        got, want = ours.batch(step), ref.batch(step)
        _equal(got, want)
        t = batch_from_numpy(got, device="cpu")
        for k, v in got.items():
            assert np.array_equal(t[k].numpy(), v)


def test_arch_batch_prefix_is_masked():
    """pixtral: the patch positions lead the labels and the mask as
    zeros, as in the reference."""
    arch = get_arch("pixtral-12b", smoke=True)
    b = ArchSyntheticDataset(arch, ShapeSpec("t", 32, 2, "train")).batch(0)
    p = arch.cfg.image_prefix
    assert not b["mask"][:, :p].any() and b["mask"][:, p:].all()
    assert not b["labels"][:, :p].any()
    assert b["patch_embeds"].shape == (2, p, arch.cfg.d_model)
