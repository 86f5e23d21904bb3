"""The port's architecture registry (``repro_torch/configs``) against the
reference's (``repro/configs``): the ten configs' numbers and sources (the
dense, MoE, multimodal, hybrid, recurrent and audio archs), ``make_batch``
bit for bit (pixtral's patch embeddings too; whisper's frames in
``test_torch_whisper.py``), and the accounting (``n_params``,
``n_active_params`` with the MoE's expert rule, ``model_flops``,
``shape_supported``, ``cells``) at full size; an unknown arch raises
``KeyError``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch  # noqa: E402


def test_registry_lists_the_dense_archs():
    """Every arch of the reference, in its order: the dense, MoE,
    multimodal and hybrid ones, the recurrent xLSTM and the audio
    encoder-decoder."""
    assert set(ARCH_NAMES) == {"internlm2-1.8b", "minitron-4b", "glm4-9b",
                               "qwen1.5-110b", "granite-moe-1b-a400m",
                               "qwen3-moe-235b-a22b", "pixtral-12b",
                               "zamba2-1.2b", "xlstm-125m", "whisper-base"}
    assert ARCH_NAMES == ref_configs.ARCH_NAMES
    assert set(configs.all_archs(smoke=True)) == set(ARCH_NAMES)
    assert set(configs.all_archs()) == set(ARCH_NAMES)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch 'gpt-5'"):
        get_arch("gpt-5")
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("whisper-tiny", smoke=True)


def _dtype_names(tree):
    """A config's ``asdict`` with every dtype (jnp or torch) as its name."""
    if isinstance(tree, dict):
        return {k: _dtype_names(v) for k, v in tree.items()}
    if isinstance(tree, torch.dtype):
        return str(tree).removeprefix("torch.")
    if tree in (jnp.bfloat16, jnp.float32):
        return np.dtype(tree).name
    return tree


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_carry_the_reference_numbers(name, smoke):
    """Every field of the model config (the MoE's too), with the dtypes
    mapped from jnp to torch, and the arch's family, profile, source,
    accumulation, moment dtype and extra inputs."""
    ref, port = ref_configs.get_arch(name, smoke=smoke), get_arch(name, smoke=smoke)
    assert type(port.cfg).__name__ == type(ref.cfg).__name__
    want = dataclasses.asdict(ref.cfg)
    got = dataclasses.asdict(port.cfg)
    assert want["dtype"] == jnp.bfloat16 and got["dtype"] == torch.bfloat16
    assert _dtype_names(got) == _dtype_names(want)
    for field in ("name", "family", "profile", "sub_quadratic", "has_decoder",
                  "source", "train_accum", "moment_dtype"):
        assert getattr(port, field) == getattr(ref, field), field
    assert list(port.extra_inputs) == list(ref.extra_inputs)
    assert (port.batch_spec_fn is None) == (ref.batch_spec_fn is None)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_accounting_matches_reference(name):
    """At full size (1.2 B to 235 B parameters, nothing allocated)."""
    ref, port = ref_configs.get_arch(name), get_arch(name)
    assert port.n_params == ref.n_params
    assert port.n_active_params == ref.n_active_params
    for shape_name, shape in SHAPES.items():
        ref_shape = ref_configs.SHAPES[shape_name]
        assert (shape.seq_len, shape.global_batch, shape.kind,
                shape.tokens_per_step) == (ref_shape.seq_len, ref_shape.global_batch,
                                           ref_shape.kind, ref_shape.tokens_per_step)
        assert port.model_flops(shape) == ref.model_flops(ref_shape)
        assert port.shape_supported(shape) == ref.shape_supported(ref_shape)
    assert [(s.name, ok, why) for s, ok, why in port.cells()] == \
        [(s.name, ok, why) for s, ok, why in ref.cells()]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("name", ["internlm2-1.8b", "minitron-4b"])
def test_make_batch_equals_reference(name, shape_name, seed):
    """The same keys, shapes, dtypes and values, bit for bit, at every
    assigned shape of the full config (tokens, and labels and mask when
    training) and at the serve launcher's prefill shape."""
    ref, port = ref_configs.get_arch(name), get_arch(name)
    shapes = [(SHAPES[shape_name], ref_configs.SHAPES[shape_name])]
    if shape_name == "train_4k":
        shapes.append((configs.ShapeSpec("cli_prefill", 16, 4, "prefill"),
                       ref_configs.ShapeSpec("cli_prefill", 16, 4, "prefill")))
    for shape, ref_shape in shapes:
        got = port.make_batch(shape, seed=seed)
        want = ref.make_batch(ref_shape, seed=seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])


def test_active_params_scale_the_experts():
    """granite-moe-1b-a400m: of 1,389,151,232 parameters, the experts'
    (24 layers x 3 x 32 x 1024 x 512) count at top_k / n_experts = 8/32,
    so 483,181,568 are active; a dense arch's are all active."""
    granite = get_arch("granite-moe-1b-a400m")
    assert granite.n_params == 1_389_151_232
    assert granite.n_active_params == 1_389_151_232 - 24 * 3 * 32 * 1024 * 512 * 3 // 4
    assert granite.n_active_params == 483_181_568
    assert get_arch("internlm2-1.8b").n_active_params == \
        get_arch("internlm2-1.8b").n_params
    shape = SHAPES["prefill_32k"]
    assert granite.model_flops(shape) == 2.0 * 483_181_568 * shape.tokens_per_step


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape_name", [*SHAPES, "cli_prefill"])
def test_make_batch_with_patch_embeds_equals_reference(shape_name, seed):
    """pixtral's batch draws its patch embeddings after the tokens (and
    labels and mask), f32 normals times 0.02, bit for bit as the
    reference's; at a decode shape it has none.  The smoke config at
    every assigned shape, the full one (256 patches of 5120) at the serve
    launcher's prefill shape."""
    cases = [(True, 0)] + ([(False, 256)] if shape_name == "cli_prefill" else [])
    for smoke, prefix in cases:
        ref, port = (ref_configs.get_arch("pixtral-12b", smoke=smoke),
                     get_arch("pixtral-12b", smoke=smoke))
        if shape_name == "cli_prefill":
            shape = configs.ShapeSpec("cli_prefill", prefix + 16, 4, "prefill")
            ref_shape = ref_configs.ShapeSpec("cli_prefill", prefix + 16, 4, "prefill")
        else:
            shape, ref_shape = SHAPES[shape_name], ref_configs.SHAPES[shape_name]
        got = port.make_batch(shape, seed=seed)
        want = ref.make_batch(ref_shape, seed=seed)
        assert list(got) == list(want)
        assert ("patch_embeds" in got) == (shape.kind != "decode")
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
