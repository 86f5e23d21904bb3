"""The port's whisper encoder-decoder (``repro_torch/models/whisper.py``)
against the reference's (``repro/models/whisper.py``) on its smoke config
and its own parameters (``materialize``, carried across with
``convert.params_from_numpy``; every layernorm's scale and bias drawn away
from their ones and zeros): ``encode``, ``decode_train`` and ``loss_fn``,
``prefill`` and three ``decode_step``s with every cache entry, in f32 at
the reference's attention tolerance (2e-3) against the reference jitted,
and in bf16 at its decode-consistency tolerance (6e-2) against the
reference run op by op (``jax.disable_jit``), which rounds to bf16 after
every op as the port does: jitted, XLA fuses elementwise chains and skips
roundings between them, and through the perturbed layernorms that alone
moves the smoke logits by 0.18 from the reference's own op-by-op run
(where the port's are within 2e-5); decode against the port's own
teacher-forced pass; the parameters cast once against cast at every use,
bit for bit, with layernorm's scale and bias kept in f32; the batch
(frames, then the prompt) bit for bit; and the full config's shapes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import common as pc  # noqa: E402
from repro_torch.models import whisper  # noqa: E402

NAME = "whisper-base"
DTYPES = {"f32": (torch.float32, jnp.float32, 2e-3),
          "bf16": (torch.bfloat16, jnp.bfloat16, 6e-2)}
FRAMES, PROMPT, STEPS, MAX_LEN = 16, 6, 3, 12
_JIT = {"encode": jax.jit(jw.encode, static_argnums=1),
        "decode_train": jax.jit(jw.decode_train, static_argnums=1),
        "loss_fn": jax.jit(jw.loss_fn, static_argnums=1),
        "prefill": jax.jit(jw.prefill, static_argnums=1,
                           static_argnames="max_len"),
        "decode_step": jax.jit(jw.decode_step, static_argnums=1)}


def _ref(name: str, dt: str, *args, **kw):
    """The reference's ``name``: jitted in f32, op by op in bf16."""
    if dt == "f32":
        return _JIT[name](*args, **kw)
    with jax.disable_jit():
        return getattr(jw, name)(*args, **kw)


def _f32(x) -> np.ndarray:
    return np.array(x, np.float32)


def _close(got, want, tol: float):
    ok, err, bound = compare(got.float(), torch.from_numpy(_f32(want)),
                             tol=(tol, tol))
    assert ok, (err, bound)


def _perturb_layernorms(tree, rng):
    """Every layernorm's scale and bias drawn around 1 and 0, in place."""
    for key, sub in tree.items():
        if key == "scale":
            tree[key] = (1.0 + 0.2 * rng.standard_normal(sub.shape)).astype(np.float32)
        elif key == "bias":
            tree[key] = (0.2 * rng.standard_normal(sub.shape)).astype(np.float32)
        elif isinstance(sub, dict):
            _perturb_layernorms(sub, rng)


@pytest.fixture(scope="module")
def ref_params():
    p = jax.tree.map(np.asarray, ref_materialize(
        ref_configs.get_arch(NAME, smoke=True).param_spec(), jax.random.key(0)))
    _perturb_layernorms(p, np.random.default_rng(1))
    return p


def _cfgs(dt, **kw):
    tdt, jdt, _ = DTYPES[dt]
    return (dataclasses.replace(ref_configs.get_arch(NAME, smoke=True).cfg,
                                dtype=jdt, **kw),
            dataclasses.replace(configs.get_arch(NAME, smoke=True).cfg,
                                dtype=tdt, **kw))


def _inputs(cfg, seed: int):
    rng = np.random.default_rng(seed)
    frames = (0.1 * rng.standard_normal((2, FRAMES, cfg.d_model))).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (2, PROMPT + STEPS + 1)).astype(np.int32)
    return frames, tokens


def _prefill_decode(params, cfg, frames, toks):
    logits, cache = whisper.prefill(
        params, cfg, {"frames": torch.from_numpy(frames),
                      "tokens": torch.from_numpy(toks[:, :PROMPT])},
        max_len=MAX_LEN)
    steps = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = whisper.decode_step(
            params, cfg, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        steps.append(logits)
    return steps, cache


@pytest.mark.parametrize("dt, impl", [("f32", "dense"), ("f32", "chunked"),
                                      ("bf16", "dense")])
def test_encode_and_decode_train_match_reference(ref_params, dt, impl):
    """The encoder's states and the teacher-forced decoder's, and the loss,
    on the smoke config's dense attention and on the chunked one (its
    cross-attention then takes the chunked path too: chunks of 8 over 8
    tokens and 16 frames), the chunked one in f32 only: run op by op, the
    reference's nested scans take seconds to dispatch."""
    jcfg, cfg = _cfgs(dt, attn_impl=impl, attn_chunk=8)
    frames, toks = _inputs(cfg, seed=0)
    toks = toks[:, :8]
    jp = jax.tree.map(jnp.asarray, ref_params)
    want_enc = _ref("encode", dt, jp, jcfg, jnp.asarray(frames))
    want_dec = _ref("decode_train", dt, jp, jcfg, jnp.asarray(toks), want_enc)
    params = params_from_numpy(ref_params, device="cpu")
    enc = whisper.encode(params, cfg, torch.from_numpy(frames))
    assert enc.dtype == DTYPES[dt][0] and tuple(enc.shape) == (2, FRAMES, cfg.d_model)
    _close(enc, want_enc, DTYPES[dt][2])
    dec = whisper.decode_train(params, cfg, torch.from_numpy(toks), enc)
    assert tuple(dec.shape) == (2, toks.shape[1], cfg.d_model)
    _close(dec, want_dec, DTYPES[dt][2])
    batch = {"frames": frames, "tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": np.ones(toks.shape, np.float32)}
    want_loss, _ = _ref("loss_fn", dt, jp, jcfg, jax.tree.map(jnp.asarray, batch))
    got_loss, metrics = whisper.loss_fn(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    assert metrics["aux_loss"] == 0.0
    _close(got_loss, want_loss, DTYPES[dt][2])


@pytest.mark.parametrize("dt", DTYPES)
def test_prefill_and_decode_match_reference(ref_params, dt):
    """The prefill's last-position logits and three decode steps; the
    cache (self K/V padded to MAX_LEN, cross K/V over the frames) ends as
    the reference's, its length on the host."""
    jcfg, cfg = _cfgs(dt)
    frames, toks = _inputs(cfg, seed=1)
    jp = jax.tree.map(jnp.asarray, ref_params)
    logits, cache = _ref(
        "prefill", dt, jp, jcfg, {"frames": jnp.asarray(frames),
                   "tokens": jnp.asarray(toks[:, :PROMPT])}, max_len=MAX_LEN)
    want = [logits]
    for t in range(PROMPT, PROMPT + STEPS):
        logits, cache = _ref("decode_step", dt, jp, jcfg, cache,
                             {"tokens": jnp.asarray(toks[:, t:t + 1])})
        want.append(logits)
    steps, got_cache = _prefill_decode(params_from_numpy(ref_params, device="cpu"),
                                       cfg, frames, toks)
    for got, w in zip(steps, want, strict=True):
        assert tuple(got.shape) == (2, 1, cfg.vocab_padded)
        _close(got, w, DTYPES[dt][2])
    want_cache = cache_from_numpy(jax.tree.map(np.asarray, cache), device="cpu")
    assert got_cache["length"] == want_cache["length"] == PROMPT + STEPS
    assert sorted(got_cache) == sorted(want_cache)
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        assert got_cache[key].shape == want_cache[key].shape
        assert got_cache[key].dtype == want_cache[key].dtype
        _close(got_cache[key], want_cache[key].float().numpy(), DTYPES[dt][2])
    assert got_cache["self_k"].shape[2] == MAX_LEN
    assert got_cache["cross_k"].shape[2] == FRAMES


def test_decode_matches_own_teacher_forced(ref_params):
    """The reference's test_whisper_decode_matches_teacher_forced on the
    port, at the config's own dtype (bf16): prefill + decode reproduce the
    teacher-forced logits (6e-2)."""
    cfg = configs.get_arch(NAME, smoke=True).cfg
    params = params_from_numpy(ref_params, device="cpu")
    frames, toks = _inputs(cfg, seed=7)
    enc = whisper.encode(params, cfg, torch.from_numpy(frames))
    full = whisper._logits(params, cfg, whisper.decode_train(
        params, cfg, torch.from_numpy(toks), enc)).float()
    steps, _ = _prefill_decode(params, cfg, frames, toks)
    for j, got in enumerate(steps):
        _close(got[:, 0], full[:, PROMPT - 1 + j].numpy(), 6e-2)


def test_layernorm_keeps_f32_scale_and_bias(ref_params):
    """Cast once to bf16, layernorm's scale and bias stay f32: the bf16
    layernorm on perturbed parameters equals the f32 tree's (cast at use)
    bit for bit and the reference's at its bf16 tolerance, where a bf16
    scale would not give the same bits."""
    p = ref_params["enc"]["ln_f"]
    x = np.random.default_rng(3).standard_normal((2, 9, p["scale"].shape[0]))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = params_from_numpy(np.asarray(xj), device="cpu")
    f32 = params_from_numpy(p, device="cpu")
    once = pc.cast_params({"ln": f32}, torch.bfloat16)["ln"]
    assert {t.dtype for t in once.values()} == {torch.float32}
    got = pc.layernorm(once, xt)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, pc.layernorm(f32, xt))
    _close(got, jc.layernorm(jax.tree.map(jnp.asarray, p), xj), 6e-2)
    rounded = pc.layernorm({k: t.to(torch.bfloat16) for k, t in f32.items()}, xt)
    assert not torch.equal(got, rounded)


def test_cast_once_equals_cast_at_use(ref_params):
    """The whole tree cast once to bf16 (the layernorms kept in f32): the
    same logits and cache as the f32 parameters cast at every use."""
    cfg = configs.get_arch(NAME, smoke=True).cfg
    f32 = params_from_numpy(ref_params, device="cpu")
    once = pc.cast_params(f32, cfg.dtype)
    kept = [t for t in pc.tree_leaves(once) if t.dtype == torch.float32]
    # enc: ln_attn, ln_ffn stacked + ln_f; dec: ln_self, ln_cross, ln_ffn + ln_f
    assert len(kept) == 2 * (2 + 1 + 3 + 1)
    frames, toks = _inputs(cfg, seed=5)
    sa, ca = _prefill_decode(f32, cfg, frames, toks)
    sb, cb = _prefill_decode(once, cfg, frames, toks)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb, strict=True))
    assert all(torch.equal(ca[k], cb[k]) for k in ("self_k", "self_v",
                                                   "cross_k", "cross_v"))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("shape_name", [*configs.SHAPES, "cli_prefill"])
def test_make_batch_equals_reference(shape_name, seed):
    """The batch spec override: frames then tokens (and labels and mask
    when training; the token alone at a decode shape), bit for bit as the
    reference's, on the smoke config and, at the launcher's 1500 frames,
    on the full one (11 prompt tokens)."""
    cases = [(True, 32)] + ([(False, 1500)] if shape_name == "cli_prefill" else [])
    for smoke, frames in cases:
        ref = ref_configs.get_arch(NAME, smoke=smoke)
        port = configs.get_arch(NAME, smoke=smoke)
        if shape_name == "cli_prefill":
            shape = configs.ShapeSpec("cli_prefill", frames, 2, "prefill")
            ref_shape = ref_configs.ShapeSpec("cli_prefill", frames, 2, "prefill")
        else:
            shape = configs.SHAPES[shape_name]
            ref_shape = ref_configs.SHAPES[shape_name]
        if not smoke or shape.kind == "decode" or shape_name == "cli_prefill":
            got, want = port.make_batch(shape, seed=seed), ref.make_batch(ref_shape, seed=seed)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k])
        spec = port.batch_spec(shape)
        ref_spec = ref.batch_spec(ref_shape)
        assert {k: s.shape for k, s in spec.items()} == \
            {k: s.shape for k, s in ref_spec.items()}
        if not smoke:
            assert spec["tokens"].shape == (2, 11)


def test_full_config_shapes():
    """whisper-base: 6 + 6 layers of d 512, 8 heads of 64, the tied
    embedding padded to 53,248 rows; the cache's cross K/V over the frames
    and its self K/V over max_len (nothing allocated)."""
    port, ref = configs.get_arch(NAME), ref_configs.get_arch(NAME)
    cfg = port.cfg
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
            cfg.vocab, cfg.vocab_padded) == (6, 512, 8, 64, 2048, 51865, 53248)
    spec = port.param_spec()
    assert spec["dec"]["embedding"].shape == (53248, 512)
    assert spec["enc"]["layers"]["attn"]["wq"].shape == (6, 512, 8, 64)
    got = whisper.cache_spec(cfg, 8, 1540, n_frames=1500)
    want = jw.cache_spec(ref.cfg, 8, 1540, n_frames=1500)
    assert {k: (s.shape, s.axes, s.init) for k, s in got.items()} == \
        {k: (s.shape, s.axes, s.init) for k, s in want.items()}
    assert got["cross_k"].shape == (6, 8, 1500, 8, 64)
    assert got["self_k"].shape == (6, 8, 1540, 8, 64)


def test_chip_smoke_contracts_the_fan_in_of_the_three_attention_subtrees():
    """``chip_smoke.py`` phase 13 draws the encoder's, the decoder's self
    and its cross attention projections at the fan-in they contract over
    (d_model for wq, wk, wv; heads x head_dim for wo), not the reference's
    head count, and leaves every other leaf."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    module = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(module)
    module.loader.exec_module(chip_smoke)
    arch = configs.get_arch(NAME)
    acfg = arch.cfg.attn_cfg(causal=False)
    spec = got = arch.param_spec()
    paths = (("enc", "layers", "attn"), ("dec", "layers", "self_attn"),
             ("dec", "layers", "cross_attn"))
    for path in paths:
        got = chip_smoke._contracted_fan_in(got, path, acfg)
    for a, b, c in paths:
        attn = got[a][b][c]
        assert attn["wq"].scale == attn["wk"].scale == attn["wv"].scale == 512 ** -0.5
        assert attn["wo"].scale == (8 * 64) ** -0.5
        assert attn["wq"].shape == (6, 512, 8, 64)
    changed = [x for x, y in zip(pc.tree_leaves(got), pc.tree_leaves(spec),
                                 strict=True) if x != y]
    assert len(changed) == 12
