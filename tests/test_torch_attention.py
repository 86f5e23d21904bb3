"""The port's flash attention against the reference's
(``repro/kernels/attention``): the same numpy inputs through the
reference's Pallas kernel in interpret mode, its oracle, and the port's
op on the CPU (its plain version), at the reference's shapes (causal and
not, with GQA), its decode case and its tolerance; the op's contract; the
kernel wrapper's refusals without the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attention import ops as jops  # noqa: E402
from repro.kernels.attention import ref as jref  # noqa: E402
from repro_torch.convert import streams_from_numpy  # noqa: E402
from repro_torch.core.machine import H100_SXM  # noqa: E402
from repro_torch.kernels.attention import kernel as K  # noqa: E402
from repro_torch.kernels.attention import ops, ref  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402

#: the reference's test shapes (tests/test_kernels.py):
#: (b, sq, sk, h, hkv, d), GQA 2, 1 and 8
SHAPES = [(1, 256, 256, 4, 2, 64), (2, 512, 512, 8, 8, 64),
          (2, 256, 256, 8, 1, 128)]
TOL = ref.TOLERANCE[torch.float32]
SMEM = H100_SXM.smem_per_block_optin


def _qkv(b, sq, sk, h, hkv, d, jdt=jnp.float32, seed=0):
    """q, k, v as JAX arrays of ``jdt`` and as bit-identical CPU tensors."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.standard_normal(s), jdt)
          for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    return js, streams_from_numpy([np.asarray(a) for a in js], device="cpu")


def _oracle(jq, jk, jv, causal):
    """The reference's oracle on its own fused, repeated layout (as its
    test builds it), back in (B, Sq, H, d)."""
    b, sq, h, d = jq.shape
    sk, rep = jk.shape[1], h // jk.shape[2]
    fuse = lambda t, s: t.transpose(0, 2, 1, 3).reshape(b * h, s, d)  # noqa: E731
    out = jref.attention(fuse(jq, sq), fuse(jnp.repeat(jk, rep, 2), sk),
                         fuse(jnp.repeat(jv, rep, 2), sk), causal=causal)
    return out.reshape(b, h, sq, d).transpose(0, 2, 1, 3)


def _close(got, want, tol=TOL):
    (w,) = streams_from_numpy([np.asarray(want)], device="cpu")
    return compare(got, w, tol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", SHAPES, ids=str)
def test_flash_attention_matches_reference(dims, causal):
    """At 128 x 128 tiles, as the reference's own test: within 2e-3 of its
    Pallas kernel and of its oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(*dims)
    got = ops.flash_attention(q, k, v, causal=causal, bq=128, bk=128)
    b, sq, _, h, _, d = dims
    assert tuple(got.shape) == (b, sq, h, d) and got.dtype == torch.float32
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, bq=128, bk=128,
                                  interpret=True)
    for want in (pallas, _oracle(jq, jk, jv, causal)):
        ok, err, tol = _close(got, want)
        assert ok, (err, tol)


def test_flash_attention_decode_matches_reference():
    """The reference's decode case: one query row against a 1024-long
    cache, non-causal, bq = 1, bk = 256, GQA 4."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 1, 1024, 8, 2, 64)
    got = ops.flash_attention(q, k, v, causal=False, bq=1, bk=256)
    pallas = jops.flash_attention(jq, jk, jv, causal=False, bq=1, bk=256,
                                  interpret=True)
    for want in (pallas, _oracle(jq, jk, jv, False)):
        ok, err, tol = _close(got, want)
        assert ok, (err, tol)


def test_bf16_inputs_keep_their_dtype():
    """bf16 in, bf16 out, within the reference's bf16 tolerance of its
    oracle on the same bf16 inputs."""
    (jq, jk, jv), (q, k, v) = _qkv(*SHAPES[0], jdt=jnp.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16
    ok, err, tol = _close(got, _oracle(jq, jk, jv, True),
                          tol=ref.TOLERANCE[torch.bfloat16])
    assert ok, (err, tol)


def test_gqa_repeat_is_jnp_repeat():
    """KV heads are repeated in jnp.repeat's order before the fused
    layout, bit for bit."""
    (_, jk, _), (q, k, v) = _qkv(2, 16, 16, 8, 2, 64)
    qf, kf, vf = ops.fused_inputs(q, k, v)
    want = np.asarray(jnp.repeat(jk, 4, 2).transpose(0, 2, 1, 3).reshape(16, 16, 64))
    assert np.array_equal(kf.numpy(), want)
    assert qf.is_contiguous() and kf.is_contiguous() and vf.is_contiguous()
    with pytest.raises(ValueError, match="multiple"):
        ops.fused_inputs(q, k[:, :, :1].expand(2, 16, 3, 64), v)


def test_contract_clamp_divide_and_causal():
    _, (q, k, v) = _qkv(1, 64, 64, 2, 2, 64)
    # bq, bk 1024 -> 64: clamped to the sequence, then they divide it
    out = ops.flash_attention(q, k, v, causal=True, bq=1024, bk=1024)
    qf, kf, vf = ops.fused_inputs(q, k, v)
    want = ref.attention(qf, kf, vf, causal=True).reshape(1, 2, 64, 64)
    assert torch.equal(out, want.permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(q, k, v, bq=48)
    with pytest.raises(ValueError, match="sq == sk"):
        ops.flash_attention(q[:, :32], k, v, causal=True)
    short = ops.flash_attention(q[:, :32], k, v, causal=False)
    assert tuple(short.shape) == (1, 32, 2, 64)


def test_plain_version_is_the_reference_oracle():
    """The plain version on the fused layout against the reference's oracle
    with sq != sk: its mask is tril(k = sk - sq) when causal."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((3, 16, 32), (3, 48, 32), (3, 48, 32)))
    tq, tk, tv = streams_from_numpy([q, k, v], device="cpu")
    for causal in (True, False):
        want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
        got = ref.attention(tq, tk, tv, causal=causal)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


def test_tiling_table_and_shared_memory():
    """Every compiled tiling fits the H100 at both head dims; a tile over
    shared memory, an uncompiled tiling and an uncompiled head dim raise,
    before any launch."""
    assert len(set(K.TILINGS)) == len(K.TILINGS)
    assert (K.DEFAULT_BQ, K.DEFAULT_BK) in K.TILINGS
    for d in K.HEAD_DIMS:
        for bq, bk in K.TILINGS:
            assert K.check_tiling(bq, bk, d, SMEM) == K.smem_bytes(bq, bk, d)
    # Q^T 64 KiB, K^T/P 66 KiB (P's rows padded by 4 floats), V 64 KiB
    assert K.smem_bytes(128, 128, 128) == (16384 + 128 * 132 + 16384) * 4
    with pytest.raises(ValueError, match="shared memory"):
        K.check_tiling(128, 256, 128, SMEM)
    with pytest.raises(ValueError, match="compiled"):
        K.check_tiling(32, 32, 64, SMEM)
    with pytest.raises(ValueError, match="head dims"):
        K.check_tiling(128, 128, 96, SMEM)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_fused(x, x, x, causal=True, bq=128, bk=128)
