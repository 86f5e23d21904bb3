"""The port's flash attention against the reference's
(``repro/kernels/attention``): the same numpy inputs through the
reference's Pallas kernel in interpret mode, its oracle, and the port's
op on the CPU (its plain version), at the reference's shapes (causal and
not, with GQA), its decode case, blocks left at None, ragged lengths (sq
= sk of 48, 100, 200), GQA 1/2/4/8 at head dims 16 to 128, and its
tolerance; the op's contract, which accepts and refuses what the
reference does on both devices; the card's choice of tiling
(``ops.card_blocks``, ``attention_block_candidates``); what the op hands
the kernel wrappers on the card path (``meta`` tensors, the wrapper
replaced by a recorder); each compiled tile's shared memory; the split
route's plan and arithmetic (``ref.split_partials``, ``ref.combine``);
both wrappers' host checks and refusals without the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.attention import ops as jops  # noqa: E402
from repro.kernels.attention import ref as jref  # noqa: E402
from repro_torch.convert import streams_from_numpy  # noqa: E402
from repro_torch.core.autotune import attention_block_candidates, rank  # noqa: E402
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


@pytest.mark.parametrize("causal", [True, False])
def test_none_blocks_follow_the_reference_at_192(causal):
    """sq = sk = 192, blocks left at None: the reference clamps its 512
    to 192 and runs; so does the op on the CPU, within 2e-3 of the
    reference's Pallas kernel and of its oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 192, 192, 4, 2, 64, seed=4)
    got = ops.flash_attention(q, k, v, causal=causal)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    for want in (pallas, _oracle(jq, jk, jv, causal)):
        ok, err, tol = _close(got, want)
        assert ok, (err, tol)
    assert ops.REFERENCE_BLOCKS == (jops.K.DEFAULT_BQ, jops.K.DEFAULT_BK)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_gqa_and_head_dims_match_reference(rep, d):
    """GQA 1/2/4/8 at the head dims of the smoke configs (16, 32) and of
    the full ones (64, 128), causal, blocks left at None: within 2e-3 of
    the reference's Pallas kernel and of its oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(1, 64, 64, 8, 8 // rep, d, seed=rep + d)
    got = ops.flash_attention(q, k, v, causal=True)
    assert tuple(got.shape) == (1, 64, 8, d)
    pallas = jops.flash_attention(jq, jk, jv, causal=True, interpret=True)
    for want in (pallas, _oracle(jq, jk, jv, True)):
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
    # Q 64 KiB, P 64 KiB, three ring slots of 128 K rows of 32 + 4 floats
    assert K.smem_bytes(128, 128, 128) == (16384 + 16384 + 3 * 128 * 36) * 4
    # 128 x 256 at d = 128: P alone is 128 KiB; 258,048 B in all
    with pytest.raises(ValueError, match="shared memory"):
        K.check_tiling(128, 256, 128, SMEM)
    with pytest.raises(ValueError, match="compiled"):
        K.check_tiling(32, 32, 64, SMEM)
    with pytest.raises(ValueError, match="head dims"):
        K.check_tiling(128, 128, 96, SMEM)


#: csrc/attention.cu's shared memory of each compiled prefill tiling,
#: 4 (bq d + bq bk + TILE_STAGES max(bk (KC + 4), VC d)) bytes with KC =
#: min(16 threads / bk, d), VC = min(16 threads / d, bk), threads = 2 bq;
#: the d = 128 figures are the ones its header lists
TILE_SMEM = {(128, 64, 128): (16384 + 8192 + 3 * max(64 * 68, 32 * 128)) * 4,
             (128, 128, 128): (16384 + 16384 + 3 * max(128 * 36, 32 * 128)) * 4,
             (128, 64, 64): (8192 + 8192 + 3 * max(64 * 68, 64 * 64)) * 4,
             (128, 128, 64): (8192 + 16384 + 3 * max(128 * 36, 64 * 64)) * 4}


@pytest.mark.parametrize("tiling", list(TILE_SMEM), ids=str)
def test_tile_shared_memory_is_the_kernels(tiling):
    """Each compiled prefill tiling's shared memory is the kernel's
    formula and at most the 232,448 B a block may use."""
    bq, bk, d = tiling
    assert (bq, bk) in K.TILINGS and d in K.HEAD_DIMS
    assert {(t[0], t[1]) for t in TILE_SMEM} == {t for t in K.TILINGS if t[0] > 1}
    assert K.smem_bytes(bq, bk, d) == TILE_SMEM[tiling] <= 232_448
    threads, kc, vc = K.tile_panels(bq, bk, d)
    assert threads == 2 * bq and d % kc == 0 and bk % vc == 0
    assert bk * kc <= 16 * threads and vc * d <= 16 * threads
    assert {K.smem_bytes(*t[:2], 128) for t in TILE_SMEM if t[2] == 128} == \
        {150_528, 186_368}


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_tile(x, x, x, causal=True, bq=128, bk=128,
                               scale=0.125)
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_attention_split(x, x, x, causal=False, bk=128, scale=0.125)


def test_split_route_shared_memory_and_routes():
    """The bq = 1 tilings are the split route's: its ring of 3 stages of
    32 K and V rows, each padded by 16 bytes, and per query head its
    scaled q row, P and rescale factor; the table's figure is its largest
    launch (f32, 16 query heads a KV head).  The attention kernel has one
    C entry per route and checks the route before loading anything."""
    assert K.split_smem_bytes(128, 2, 4) == 3 * 2 * 32 * 528 + 2 * 161 * 4
    assert K.split_smem_bytes(64, 1, 2) == 3 * 2 * 32 * 144 + 97 * 4
    for d in K.HEAD_DIMS:
        assert K.smem_bytes(1, 256, d) == K.split_smem_bytes(d, K.MAX_REP, 4)
    assert K.route_of(1) == "split" and K.route_of(64) == "tile"
    assert K.FLASH_ATTENTION.routes == K.ROUTES == ("tile", "split")
    assert set(K.FLASH_ATTENTION.symbol) == set(K.ROUTES)
    for route in (None, "row"):
        with pytest.raises(ValueError, match="route"):
            K.FLASH_ATTENTION.launch(route=route)
    assert K.FLASH_ATTENTION.launches_by_route == {"tile": 0, "split": 0}


#: (groups, sk, bk, ctas an SM, n_split, split_keys): the timed decode
#: point (64 groups, 2 CTAs on each of 132 SMs: 4 splits of 4 tiles); one
#: tile; groups that fill the card; 5 splits wanted of 32 tiles, spread
#: as 7 tiles (the last split 4); the smallest groups, one tile each
PLANS = [(64, 4096, 256, 2, 4, 1024), (16, 128, 128, 4, 1, 128),
         (576, 512, 128, 4, 1, 512), (52, 4096, 128, 2, 5, 896),
         (1, 1024, 256, 4, 4, 256)]


@pytest.mark.parametrize("groups,sk,bk,per_sm,n,keys", PLANS, ids=str)
def test_split_plan(groups, sk, bk, per_sm, n, keys):
    plan = K.split_plan(groups=groups, sk=sk, bk=bk, sms=132,
                        ctas_per_sm=per_sm, smem_bytes=1)
    assert (plan.n_split, plan.split_keys) == (n, keys)
    assert plan.ctas == groups * n <= max(groups, 132 * per_sm)
    assert keys % bk == 0 and (n - 1) * keys < sk <= n * keys


def _strided(shape, dtype=torch.float32, cap=None, offset=0):
    """A (B, S, H, d) CPU view; ``cap`` > S makes it a slice of a longer
    cache, ``offset`` shifts its base by that many elements."""
    b, s, h, d = shape
    cap = cap or s
    buf = torch.zeros(b * cap * h * d + offset, dtype=dtype)[offset:]
    return buf.view(b, cap, h, d)[:, :s]


@pytest.mark.parametrize("case", ["rep", "misaligned", "last_dim", "row_stride",
                                  "sk", "tiling", "dtype", "causal", "head_dim"])
def test_check_split_operands_refuses(case):
    q = _strided((2, 1, 8, 64))
    k = _strided((2, 256, 2, 64))
    calls = {
        "rep": ((_strided((1, 1, 34, 64)), _strided((1, 256, 2, 64)),
                 _strided((1, 256, 2, 64))), {}, "over the 16"),
        "misaligned": ((q, _strided((2, 256, 2, 64), offset=1), k), {}, "aligned"),
        "last_dim": ((q, k.transpose(2, 3).contiguous().transpose(2, 3), k), {},
                     "dense last"),
        "row_stride": ((q, torch.zeros(2, 256, 2, 66)[..., :64], k), {}, "strides"),
        "sk": ((q, k[:, :200], k[:, :200]), {}, "do not divide"),
        "tiling": ((q, k, k), {"bk": 64}, "compiled"),
        "dtype": ((q, k.bfloat16(), k), {}, "one dtype"),
        "causal": ((q, k, k), {"causal": True}, "sq == sk"),
        "head_dim": ((_strided((2, 1, 8, 96)), _strided((2, 256, 2, 96)),
                      _strided((2, 256, 2, 96))), {}, "head dims"),
    }
    ops_, kw, msg = calls[case]
    with pytest.raises(ValueError, match=msg):
        K.check_split_operands(*ops_, **({"causal": False, "bk": 128} | kw),
                               smem_limit=SMEM)


def test_check_split_operands_takes_a_cache_slice():
    """A slice of a longer cache is addressed through its strides, with
    no copy; bf16 at GQA 4 takes its own ring."""
    q = _strided((2, 1, 8, 128), torch.bfloat16)
    k = _strided((2, 512, 2, 128), torch.bfloat16, cap=4096)
    assert not k.is_contiguous()
    assert K.check_split_operands(q, k, k, causal=False, bk=256,
                                  smem_limit=SMEM) == \
        K.split_smem_bytes(128, 4, 2)


class _Recorder:
    """Stands in for a kernel wrapper on tensors without storage (the
    ``meta`` device, which takes the op's card path): records the call
    and returns an output of the shape the wrapper would."""

    def __init__(self):
        self.calls = []

    def __call__(self, q, k, v, **kw):
        self.calls.append((q, k, v, kw))
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@pytest.mark.parametrize("d", [128, 64, 32, 16])
def test_decode_op_hands_the_kernel_the_callers_cache(d, monkeypatch):
    """The decode op passes q, k and v to the split route as the caller
    holds them: the same tensors (so no repeat and no copy of the cache),
    unrepeated at Hkv heads, with blocks left at None taking the model's
    one-row pick.  Head dims 16 and 32 reach it zero-padded to 64, with
    the scale of the true d, and come back cut to d."""
    rec = _Recorder()
    monkeypatch.setattr(K, "flash_attention_split", rec)
    q = torch.empty((8, 1, 16, d), device="meta")
    k = torch.empty((8, 4096, 8, d), device="meta")
    v = torch.empty((8, 4096, 8, d), device="meta")
    out = ops.flash_attention(q, k, v, causal=False)
    assert tuple(out.shape) == (8, 1, 16, d)
    ((gq, gk, gv, kw),) = rec.calls
    assert kw == {"causal": False, "bk": 256, "scale": d ** -0.5}
    if d in K.HEAD_DIMS:
        assert gq is q and gk is k and gv is v
    else:
        assert tuple(gk.shape) == (8, 4096, 8, 64)


def test_prefill_op_hands_the_kernel_kv_at_its_own_heads(monkeypatch):
    """The prefill op passes q, k and v to the tile route as the caller
    holds them: the same tensors, in (B, S, heads, d), the KV heads not
    repeated, at the model's pick."""
    rec = _Recorder()
    monkeypatch.setattr(K, "flash_attention_tile", rec)
    _, (q, k, v) = _qkv(1, 256, 256, 16, 8, 128)
    q, k, v = (t.to("meta") for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=True)
    assert tuple(out.shape) == (1, 256, 16, 128)
    ((gq, gk, gv, kw),) = rec.calls
    assert gq is q and gk is k and gv is v
    assert tuple(gk.shape) == tuple(gv.shape) == (1, 256, 8, 128)
    assert kw == {"causal": True, "bq": 128, "bk": 128, "scale": 128 ** -0.5}
    assert (kw["bq"], kw["bk"]) == ops.tuned_blocks(256, 256, 128)
    assert not hasattr(ops, "tile_operands")


#: ragged prefill shapes, blocks left at None: (b, sq, sk, h, hkv, d)
RAGGED = [(1, s, s, 4, hkv, 64) for s in (48, 100, 200) for hkv in (2, 4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dims", RAGGED, ids=str)
def test_ragged_shapes_match_reference(dims, causal):
    """sq = sk of 48, 100 and 200, no multiple of 64, at GQA 2 and 1 with
    blocks left at None: the reference clamps its 512 and runs; so does
    the op, within 2e-3 of the reference's Pallas kernel and of its
    oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(*dims, seed=dims[1] + dims[4])
    got = ops.flash_attention(q, k, v, causal=causal)
    assert tuple(got.shape) == (1, dims[1], 4, 64)
    pallas = jops.flash_attention(jq, jk, jv, causal=causal, interpret=True)
    for want in (pallas, _oracle(jq, jk, jv, causal)):
        ok, err, tol = _close(got, want)
        assert ok, (err, tol)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("sq,blocks", [(600, {}), (100, {"bq": 64}),
                                       (200, {"bk": 128}), (48, {"bq": 32})],
                         ids=str)
def test_ragged_refused_where_the_reference_refuses(sq, blocks, device,
                                                    monkeypatch):
    """What the reference refuses (its default 512 clamped, or a given
    block, that does not divide the sequence) is refused on the CPU and on
    the card path (``meta`` tensors, the kernel never reached)."""
    monkeypatch.setattr(K, "flash_attention_tile", _Recorder())
    (jq, jk, jv), (q, k, v) = _qkv(1, sq, sq, 2, 1, 64)
    with pytest.raises(AssertionError):
        jops.flash_attention(jq, jk, jv, causal=True, interpret=True, **blocks)
    q, k, v = (t.to(device) for t in (q, k, v))
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(q, k, v, causal=True, **blocks)
    assert not K.flash_attention_tile.calls


@pytest.mark.parametrize("sq,blocks,want", [
    (100, {}, (128, 128)), (100, {"bq": 100, "bk": 100}, (128, 128)),
    (48, {"bq": 48}, (128, 64)), (4096, {"bq": 128}, (128, 128)),
    (4096, {"bq": 128, "bk": 64}, (128, 64)), (4096, {"bk": 256}, (1, 256)),
    (200, {"bq": 1}, (128, 128))], ids=str)
def test_card_path_accepts_what_the_reference_accepts(sq, blocks, want,
                                                      monkeypatch):
    """On the card path (``meta`` tensors, the wrappers replaced) a ragged
    call the reference accepts reaches a kernel at the tiling card_blocks
    chooses: the blocks given where compiled, else the first ranked that
    agrees with a given block, else the first ranked."""
    rec = _Recorder()
    monkeypatch.setattr(K, "flash_attention_tile", rec)
    monkeypatch.setattr(K, "flash_attention_split", rec)
    q = torch.empty((1, sq, 4, 64), device="meta")
    k = torch.empty((1, sq, 2, 64), device="meta")
    out = ops.flash_attention(q, k, k, causal=True, **blocks)
    assert tuple(out.shape) == (1, sq, 4, 64)
    ((_, _, _, kw),) = rec.calls
    assert (kw.get("bq", 1), kw["bk"]) == want


def test_block_candidates_and_card_blocks_on_ragged_lengths():
    """Every compiled prefill tiling is a candidate whether or not it
    divides the sequence; the one-row tilings only where they divide Sk.
    card_blocks is a pure function of the clamped blocks and the ranking."""
    prefill = [t for t in K.TILINGS if t[0] > 1]
    assert attention_block_candidates(100, 100, 64, H100_SXM) == prefill
    assert attention_block_candidates(1, 1000, 128, H100_SXM) == prefill
    assert attention_block_candidates(1, 384, 64, H100_SXM) == prefill + [(1, 128)]
    assert attention_block_candidates(4096, 4096, 16, H100_SXM) == list(K.TILINGS)
    ranked = [r["block"] for r in rank((100, 100, 64), H100_SXM,
                                       objective="attention")]
    assert sorted(ranked) == sorted(prefill) and ranked[0] == (128, 128)
    # at sq = 48 both tiles model alike; the smaller computes fewer masked keys
    assert rank((48, 48, 64), H100_SXM, objective="attention")[0]["block"] == (128, 64)
    # a single query row: the one-row tilings first, on equal predictions
    dec = [r["block"] for r in rank((1, 4096, 128), H100_SXM,
                                    objective="attention", causal=False)]
    assert dec[:2] == [(1, 256), (1, 128)]
    order = [(128, 128), (1, 256), (128, 64), (1, 128)]
    assert ops.card_blocks((None, None), order) == (128, 128)
    assert ops.card_blocks((48, None), order) == (128, 128)
    assert ops.card_blocks((None, 64), order) == (128, 64)
    assert ops.card_blocks((128, 64), order) == (128, 64)
    assert ops.card_blocks((1, None), order) == (1, 256)
    assert ops.card_blocks((100, 100), order) == (128, 128)


@pytest.mark.parametrize("case", ["misaligned", "last_dim", "row_stride", "dtype",
                                  "causal", "head_dim", "tiling", "one_row",
                                  "heads", "shape"])
def test_check_tile_operands_refuses(case):
    """The tile wrapper's host checks, on CPU tensors before any launch:
    views its 16-byte copies cannot address, and every other refusal."""
    q = _strided((2, 100, 8, 64))
    k = _strided((2, 100, 2, 64))
    calls = {
        "misaligned": ((q, _strided((2, 100, 2, 64), offset=2), k), {}, "aligned"),
        "last_dim": ((q, k.transpose(2, 3).contiguous().transpose(2, 3), k), {},
                     "dense last"),
        "row_stride": ((torch.zeros(2, 100, 8, 66)[..., :64], k, k), {}, "strides"),
        "dtype": ((q, k.bfloat16(), k), {}, "one dtype"),
        "causal": ((q[:, :64], k, k), {"causal": True}, "sq == sk"),
        "head_dim": ((_strided((2, 100, 8, 96)), _strided((2, 100, 2, 96)),
                      _strided((2, 100, 2, 96))), {}, "head dims"),
        "tiling": ((q, k, k), {"bq": 128, "bk": 32}, "compiled"),
        "one_row": ((q, k, k), {"bq": 1}, "split route"),
        "heads": ((_strided((2, 100, 6, 64)), _strided((2, 100, 4, 64)),
                   _strided((2, 100, 4, 64))), {}, "multiple"),
        "shape": ((q, k, k[:, :50]), {}, "expected q"),
    }
    ops_, kw, msg = calls[case]
    with pytest.raises(ValueError, match=msg):
        K.check_tile_operands(*ops_, **({"causal": False, "bq": 64, "bk": 64}
                                        | kw), smem_limit=SMEM)


def test_check_tile_operands_takes_strided_views():
    """A q that is a slice of wider heads and k, v slices of a longer
    cache are addressed through their strides, with no copy, at any
    sequence length; bf16 shares the f32 layout."""
    q = _strided((2, 8, 100, 128), torch.bfloat16).transpose(1, 2)[:, :, :4]
    k = _strided((2, 200, 2, 128), torch.bfloat16, cap=4096)
    assert not q.is_contiguous() and not k.is_contiguous()
    assert K.check_tile_operands(q, k, k, causal=False, bq=128, bk=128,
                                 smem_limit=SMEM) == K.smem_bytes(128, 128, 128)


@pytest.mark.parametrize("causal,split_keys", [(False, 32), (False, 96),
                                               (True, 32), (True, 64)])
def test_split_combine_arithmetic(causal, split_keys):
    """The split route's arithmetic in plain form (ref.split_partials,
    ref.combine) equals the oracle within 1e-5, GQA expanded, Sq = Sk = 96.
    Causal, the rows before a split's first key find it empty (l = 0, m =
    -1e30), and no value of an empty split changes the result: the
    combine leaves it out of the max whatever its m (even one above every
    score), and had its keys been scored as masked ones (m = -1e30, l =
    its key count, acc = the sum of its V rows, exp(-1e30 - (-1e30)) = 1
    a key), the finite max of split 0, which always holds key 0 <= row,
    weighs it by exp(-1e30 - M) = 0."""
    rng = np.random.default_rng(7)
    q, k, v = streams_from_numpy(
        [rng.standard_normal((3, 96, 16)).astype(np.float32) for _ in range(3)],
        device="cpu")
    m, l, acc = ref.split_partials(q, k, v, split_keys=split_keys, causal=causal)
    n = -(-96 // split_keys)
    assert m.shape == l.shape == (3, 96, n) and acc.shape == (3, 96, n, 16)
    want = ref.attention(q, k, v, causal=causal)
    assert (ref.combine(m, l, acc) - want).abs().max() <= 1e-5
    jwant = jref.attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                           jnp.asarray(v.numpy()), causal=causal)
    assert np.abs(ref.combine(m, l, acc).numpy() - np.asarray(jwant)).max() <= 1e-5
    if not causal:
        assert bool((l > 0).all())
        return
    rows = torch.arange(96)[:, None]
    empty = rows < torch.arange(n)[None, :] * split_keys
    assert empty.any() and bool((l[:, empty] == 0).all())
    assert bool((l[:, ~empty] > 0).all()) and bool((m[:, empty] == ref.NEG_INF).all())
    got = ref.combine(m, l, acc)
    assert torch.equal(ref.combine(m.masked_fill(empty, 1e30), l, acc), got)
    vsum = torch.stack([v[:, k0:k0 + split_keys].sum(1)
                        for k0 in range(0, 96, split_keys)], 1)   # (3, n, 16)
    scored_l = l.masked_fill(empty, float(split_keys))
    scored_acc = torch.where(empty[None, :, :, None], vsum[:, None], acc)
    assert torch.equal(ref.combine(m, scored_l, scored_acc), got)


def test_card_path_ranks_each_shape_once(monkeypatch):
    """The card path memoizes the ranking per (dims, causal, machine): a
    second call at the same key does not call ``rank`` and takes the same
    tiling; another key ranks anew."""
    import repro_torch.core.autotune as autotune

    calls = []

    def counting_rank(*args, **kw):
        calls.append(args[0])
        return rank(*args, **kw)

    monkeypatch.setattr(autotune, "rank", counting_rank)
    monkeypatch.setattr(ops, "_RANKED", {})
    rec = _Recorder()
    monkeypatch.setattr(K, "flash_attention_tile", rec)
    q = torch.empty((1, 384, 4, 128), device="meta")
    k = torch.empty((1, 384, 2, 128), device="meta")
    for _ in range(3):
        ops.flash_attention(q, k, k, causal=True)
    assert calls == [(384, 384, 128)]
    assert len({(kw["bq"], kw["bk"]) for *_, kw in rec.calls}) == 1
    assert ops.tuned_blocks(384, 384, 128) == ops.ranked_blocks(384, 384, 128)[0]
    assert calls == [(384, 384, 128)]
    ops.flash_attention(q, k, k, causal=False)
    assert calls == [(384, 384, 128)] * 2
    assert ops.ranked_blocks(384, 384, 128) == tuple(
        r["block"] for r in rank((384, 384, 128), H100_SXM,
                                 objective="attention", causal=True))


@pytest.mark.parametrize("operand", [0, 1, 2])
def test_flash_attention_refuses_grad(operand, monkeypatch):
    """The kernel has no backward (the reference's Pallas kernel has
    none either: ``jax.grad`` through it raises), and its CUDA output
    would carry no history: with grad mode on, an operand that requires
    grad raises on the CPU and on the card path (``meta`` tensors, the
    wrapper never reached), so both devices keep one contract.  Under
    ``no_grad`` the op runs as before."""
    _, qkv = _qkv(1, 64, 64, 4, 2, 64)
    args = list(qkv)
    args[operand] = args[operand].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(*args, causal=True)
    rec = _Recorder()
    monkeypatch.setattr(K, "flash_attention_tile", rec)
    meta = [t.detach().to("meta").requires_grad_(i == operand)
            for i, t in enumerate(qkv)]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(*meta, causal=True)
    assert not rec.calls
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(*args, causal=True),
                           ops.flash_attention(*qkv, causal=True))
