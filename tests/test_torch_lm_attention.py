"""The port's model attention (``repro_torch/models/attention.py``) against
the reference's (``repro/models/attention.py``): the same numpy
parameters and inputs through ``attention`` under each ``impl`` (dense,
chunked, and flash: the reference's Pallas kernel in its interpret mode,
the port's op on its plain version) and through ``decode_attention``, at
GQA rep 1, 2 and 4, with and without the QKV bias, whole and partial
RoPE, in f32 at the reference's attention tolerance (2e-3:
tests/test_kernels.py:102, tests/test_chunked_equivalence.py:136)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import attention as pa  # noqa: E402

TOL = (2e-3, 2e-3)
#: (n_heads, n_kv_heads): GQA rep 1, 2 and 4
HEADS = [(4, 4), (4, 2), (8, 2)]
D, HD = 64, 16


def _cfgs(h, kv, bias, impl, *, fraction=1.0, chunk=16):
    kw = dict(d_model=D, n_heads=h, n_kv_heads=kv, head_dim=HD, qkv_bias=bias,
              rope_fraction=fraction, impl=impl, chunk_size=chunk)
    return ja.AttnConfig(**kw), pa.AttnConfig(**kw)


def _params(jcfg, seed):
    """Random attention parameters, the biases nonzero: the reference's
    tree of f32 arrays and the port's of the same bits."""
    rng = np.random.default_rng(seed)
    spec = ja.attn_spec(jcfg)
    tree = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
            for k, s in spec.items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            params_from_numpy(tree, device="cpu"))


def _close(got, want):
    w = params_from_numpy(np.asarray(want, np.float32), device="cpu")
    ok, err, bound = compare(got.float(), w, tol=TOL)
    assert ok, (err, bound)


@pytest.mark.parametrize("impl", ["dense", "chunked", "flash"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("heads", HEADS, ids=str)
def test_attention_matches_reference(heads, bias, impl):
    """Full-sequence causal attention at S 64 (chunks of 16: a causal walk
    of 4 x 4 tiles that skips the 6 wholly past their q block): the
    output and the layer's K and V."""
    jcfg, pcfg = _cfgs(*heads, bias, impl)
    p, pp = _params(jcfg, seed=sum(heads) + bias)
    x = np.random.default_rng(9).standard_normal((2, 64, D)).astype(np.float32)
    out, (k, v) = ja.attention(p, jcfg, jnp.asarray(x))
    got, (pk, pv) = pa.attention(pp, pcfg, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 64, D)
    assert tuple(pk.shape) == tuple(pv.shape) == (2, 64, heads[1], HD)
    for g, w in ((got, out), (pk, k), (pv, v)):
        _close(g, w)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_equals_dense_in_the_port(causal):
    """The port's chunked loops against its own dense path, GQA 4,
    non-causal (every tile scored) and causal."""
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 48, 8, HD), (2, 48, 2, HD), (2, 48, 2, HD)))
    got = pa._chunked_attn(q, k, v, causal=causal, chunk=16)
    want = pa._dense_attn(q, pa._repeat_kv(k, 4), pa._repeat_kv(v, 4),
                          causal=causal)
    assert compare(got, want, tol=TOL)[0]


def test_chunked_refuses_a_chunk_that_does_not_divide():
    q = torch.zeros((1, 48, 2, HD))
    with pytest.raises(ValueError, match="does not divide"):
        pa._chunked_attn(q, q, q, causal=True, chunk=32)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("heads", HEADS, ids=str)
def test_decode_attention_matches_reference(heads, bias, fraction):
    """One token against a 24-position cache holding 9 keys (the rest
    garbage, masked): the output, and the caches with the new K and V
    written at position 9 (in place in the port)."""
    jcfg, pcfg = _cfgs(*heads, bias, "dense", fraction=fraction)
    p, pp = _params(jcfg, seed=20 + sum(heads) + bias)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 24, heads[1], HD)).astype(np.float32)
              for _ in range(2))
    out, nk, nv = ja.decode_attention(p, jcfg, jnp.asarray(x), jnp.asarray(ck),
                                      jnp.asarray(cv), jnp.asarray(9, jnp.int32))
    pk, pv = params_from_numpy({"k": ck, "v": cv}, device="cpu").values()
    got, gk, gv = pa.decode_attention(pp, pcfg, torch.from_numpy(x), pk, pv, 9)
    assert gk is pk and gv is pv
    _close(got, out)
    _close(gk, nk)
    _close(gv, nv)
    untouched = np.r_[0:9, 10:24]
    assert np.array_equal(gk.numpy()[:, untouched], ck[:, untouched])
