"""The port's serve launcher (``repro_torch/launch/serve.py``) on the CPU
at smoke size: its greedy tokens equal the reference's ``prefill`` +
``decode_step`` loop on the same parameters in f32, for the dense, MoE,
multimodal (the patch embeddings of ``make_batch`` fed with the tokens),
hybrid, recurrent and audio (whisper's frames fed with its prompt) archs;
its JSON has the reference launcher's keys; an encoder-only arch is
skipped, as the reference's launcher skips it; ``--continuous`` runs the
serving engine; what is not ported raises."""
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as ref_arch  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch.configs import ShapeSpec, get_arch  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

BATCH, PROMPT, GEN = 2, 8, 4


def _reference_loop(name):
    """f32: the reference's smoke parameters, and its prefill on the
    launcher's prompt batch (every array of ``make_batch``), then greedy
    argmax over the unpadded vocabulary through its decode steps, with the
    launcher's cache length, each jitted as its launcher jits them;
    returns the parameters and the tokens."""
    ref = ref_arch(name, smoke=True)
    jcfg = dataclasses.replace(ref.cfg, dtype=jnp.float32)
    jparams = ref_materialize(ref.param_spec(), jax.random.key(0))
    shape = ShapeSpec("cli_prefill", seq_len=PROMPT, global_batch=BATCH,
                      kind="prefill")
    batch = {k: jnp.asarray(v) for k, v in ref.make_batch(shape).items()}
    logits, cache = jax.jit(lambda p, b: ref.prefill_fn(
        p, jcfg, b, max_len=PROMPT + GEN + 8))(jparams, batch)
    decode = jax.jit(lambda p, c, b: ref.decode_fn(p, jcfg, c, b))
    tok = jnp.argmax(logits[:, -1, :jcfg.vocab], -1)[:, None]
    want = []
    for _ in range(GEN):
        logits, cache = decode(jparams, cache, {"tokens": tok.astype(jnp.int32)})
        tok = jnp.argmax(logits[:, -1, :jcfg.vocab], -1)[:, None]
        want.append(np.asarray(tok[:, 0]))
    return jax.tree.map(np.asarray, jparams), np.stack(want, 1)


def _served(name, jparams):
    arch = get_arch(name, smoke=True)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype=torch.float32))
    params = params_from_numpy(jparams, device="cpu")
    return arch, serve.serve(arch, params, batch=BATCH, prompt_len=PROMPT,
                             gen=GEN)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "glm4-9b",
                                  "granite-moe-1b-a400m", "pixtral-12b",
                                  "zamba2-1.2b"])
def test_greedy_tokens_equal_the_reference_loop(name):
    """The LMs (:func:`_reference_loop`): the tokens, the KV cache's length
    and size, and the report."""
    jparams, want = _reference_loop(name)
    arch, served = _served(name, jparams)
    assert served.tokens.tolist() == want.tolist()
    prefix = getattr(arch.cfg, "image_prefix", 0)
    assert served.cache["length"] == max(PROMPT - prefix, 1) + prefix + GEN
    assert served.cache["k"].shape[2] == PROMPT + GEN + 8
    assert served.fed[:, 1:].tolist() == served.tokens[:, :-1].tolist()
    assert len(served.step_logits) == GEN
    report = served.report(arch.name)
    assert report["tokens"] == served.tokens.tolist()
    assert report["decode_s_per_tok"] == round(served.decode_s / GEN, 4)


@pytest.mark.parametrize("name", ["xlstm-125m", "whisper-base"])
def test_recurrent_and_audio_tokens_equal_the_reference_loop(name):
    """xLSTM (its per-layer states) and whisper (no top-level embedding:
    the launcher finds the device on any parameter; the frames and an
    8-token prompt, the self cache padded to the launcher's length, the
    cross cache over the frames): the tokens of the reference's loop."""
    jparams, want = _reference_loop(name)
    arch, served = _served(name, jparams)
    assert served.tokens.tolist() == want.tolist()
    assert served.cache["length"] == PROMPT + GEN
    assert served.fed[:, 1:].tolist() == served.tokens[:, :-1].tolist()
    if name == "whisper-base":
        assert served.cache["self_k"].shape[2] == PROMPT + GEN + 8
        assert served.cache["cross_k"].shape[2] == PROMPT
    else:
        assert served.cache["layer_0"]["c"].dtype == torch.float32


def test_encoder_only_arch_is_skipped(capsys, monkeypatch):
    """An arch with no decoder prints the reference launcher's line and
    serves nothing."""
    from repro_torch import configs

    arch = dataclasses.replace(configs.get_arch("whisper-base", smoke=True),
                               has_decoder=False)
    monkeypatch.setattr(serve, "get_arch", lambda name, smoke: arch)
    assert serve.main(["--arch", "whisper-base", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == "whisper-base: encoder-only, nothing to serve\n"


def test_json_keys_equal_the_reference_launchers(capsys, monkeypatch):
    """Both launchers at smoke size on the CPU print one JSON object with
    the same keys; ``--gen 0`` has a null decode time and no tokens."""
    from repro.launch import serve as ref_serve

    argv = ["--batch", "2", "--prompt-len", "4", "--gen", "2"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    assert ref_serve.main() == 0
    want = json.loads(capsys.readouterr().out)
    assert serve.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert list(got) == list(want) == ["arch", "prefill_s",
                                       "decode_s_per_tok", "tokens"]
    assert got["arch"] == want["arch"]
    assert np.array(got["tokens"]).shape == np.array(want["tokens"]).shape == (2, 2)
    assert serve.main(["--gen", "0", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["decode_s_per_tok"] is None and got["tokens"] == []


def test_continuous_runs_the_engine(capsys):
    """``--continuous`` serves a synthetic trace through the engine on the
    data sheet's H100 with ``--device cpu``, prints the reference
    launcher's summary JSON and exits 0 with no request lost."""
    assert serve.main(["--continuous", "--device", "cpu", "--requests",
                       "16"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["lost"] == 0 and summary["requests"] == 16
    assert summary["completed"] == 16 and summary["n_devices_final"] == 4
    assert serve.main(["--continuous", "--device", "cpu", "--requests", "16",
                       "--faults", "device_loss"]) == 0
    assert json.loads(capsys.readouterr().out)["lost"] == 0


def test_what_is_not_ported_raises(capsys):
    with pytest.raises(NotImplementedError, match="item 5"):
        serve.main(["--mesh", "single-pod", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gpt-5", "--device", "cpu"])
    assert "unknown arch 'gpt-5'" in capsys.readouterr().err


def test_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """The default device is the card; without one the launcher raises
    rather than falling back to the CPU."""
    assert serve._parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--continuous"])
