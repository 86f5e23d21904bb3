"""The port's architecture registry (``repro_torch/configs``) against the
reference's (``repro/configs``): the four dense configs' numbers and
sources, ``make_batch`` bit for bit, and the accounting
(``n_params``, ``n_active_params``, ``model_flops``, ``shape_supported``,
``cells``) at full size; an arch not ported yet raises ``KeyError``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ARCH_NAMES, SHAPES, get_arch  # noqa: E402


def test_registry_lists_the_dense_archs():
    assert set(ARCH_NAMES) == {"internlm2-1.8b", "minitron-4b", "glm4-9b",
                               "qwen1.5-110b"}
    assert set(ARCH_NAMES) | set(configs.NOT_PORTED) == set(ref_configs.ARCH_NAMES)
    assert set(configs.all_archs(smoke=True)) == set(ARCH_NAMES)


@pytest.mark.parametrize("name", sorted(configs.NOT_PORTED))
def test_unported_arch_raises_naming_its_item(name):
    with pytest.raises(KeyError, match="not ported yet.*ROADMAP §1 item 3"):
        get_arch(name)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_carry_the_reference_numbers(name, smoke):
    """Every field of the LM config, with the dtype mapped from jnp to
    torch, and the arch's family, profile, source and accumulation."""
    ref, port = ref_configs.get_arch(name, smoke=smoke), get_arch(name, smoke=smoke)
    want = dataclasses.asdict(ref.cfg)
    got = dataclasses.asdict(port.cfg)
    assert want.pop("dtype") == jnp.bfloat16 and got.pop("dtype") == torch.bfloat16
    assert got == want
    for field in ("name", "family", "profile", "sub_quadratic", "has_decoder",
                  "source", "train_accum"):
        assert getattr(port, field) == getattr(ref, field), field


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_accounting_matches_reference(name):
    """At full size (1.9 B to 111 B parameters, nothing allocated)."""
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
