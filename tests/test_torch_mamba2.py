"""The port's Mamba2 layer (``repro_torch/models/mamba2.py``) against the
reference's (``repro/models/mamba2.py``) and against the naive per-step
recurrence of tests/test_chunked_equivalence.py: the causal conv with
and without a decode state, the chunked SSD at the reference test's four
``(s, chunk)`` cases (ragged ones padded with ``dt = 0``), the whole
layer in f32 and bf16 (prefill and the single-step decode), and decode
token by token against prefill at the reference's 5e-3."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jm  # noqa: E402
from repro.models.common import materialize as ref_materialize  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels.check import compare  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

#: port dtype, reference dtype, (rtol, atol): the reference's kernel
#: tolerances (tests/test_kernels.py:15-17)
DTYPES = {"f32": (torch.float32, jnp.float32, (1e-4, 1e-5)),
          "bf16": (torch.bfloat16, jnp.bfloat16, (2e-2, 2e-2))}
CFG = dict(d_model=16, d_state=4, head_dim=8, chunk=4)


def _close(got, want, tol):
    ok, err, bound = compare(got.float(), torch.from_numpy(np.array(want, np.float32)),
                             tol=tol)
    assert ok, (err, bound)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """The reference's layer parameters (numpy, f32), with the decay,
    step bias and skip drawn away from their zero and one inits."""
    p = jax.tree.map(np.asarray, ref_materialize(
        jm.mamba2_spec(jm.Mamba2Config(**CFG)), jax.random.key(0)))
    rng = np.random.default_rng(1)
    h = p["a_log"].shape[0]
    return p | {"a_log": _rand(rng, h) * 0.5, "dt_bias": _rand(rng, h) * 0.5,
                "d_skip": 1 + _rand(rng, h) * 0.1, "conv_b": _rand(rng, *p["conv_b"].shape) * 0.1}


def test_softplus_is_the_references():
    x = np.concatenate([np.linspace(-40, 40, 4001, dtype=np.float32),
                        np.array([0.0, -0.0, np.inf, -np.inf], np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = mamba2._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.isnan(mamba2._softplus(torch.tensor([np.nan])).item())


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dt", DTYPES)
def test_causal_conv_matches_reference(dt, with_state):
    """The k taps in order, rounded where the reference rounds; the new
    state is the last k - 1 inputs."""
    tdt, jdt, tol = DTYPES[dt]
    rng = np.random.default_rng(2)
    w, b, x = _rand(rng, 4, 12) * 0.3, _rand(rng, 12) * 0.1, _rand(rng, 2, 7, 12)
    state = _rand(rng, 2, 3, 12) if with_state else None
    want, want_state = jm._causal_conv(
        jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt),
        jnp.asarray(x).astype(jdt),
        state=None if state is None else jnp.asarray(state))
    got, got_state = mamba2._causal_conv(
        torch.from_numpy(w).to(tdt), torch.from_numpy(b).to(tdt),
        torch.from_numpy(x).to(tdt),
        state=None if state is None else torch.from_numpy(state))
    assert got.dtype == got_state.dtype == tdt
    _close(got, want, tol)
    assert np.array_equal(got_state.float().numpy(), np.asarray(want_state, np.float32))


def _ssd_recurrence(x, bmat, cmat, dt, a_log):
    """tests/test_chunked_equivalence.py's naive recurrence (float64)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = h // g
    a = np.exp(np.asarray(a_log, np.float64))
    hst = np.zeros((b, h, n, p))
    ys = np.zeros((b, s, h, p))
    bf = np.repeat(np.asarray(bmat, np.float64), hpg, 2)
    cf = np.repeat(np.asarray(cmat, np.float64), hpg, 2)
    dtf = np.asarray(dt, np.float64)
    for t in range(s):
        at = np.exp(-dtf[:, t][:, :, None, None] * a[None, :, None, None])
        contrib = (dtf[:, t][:, :, None, None] * bf[:, t][:, :, :, None]
                   * np.asarray(x, np.float64)[:, t][:, :, None, :])
        hst = at * hst + contrib
        ys[:, t] = np.einsum("bhn,bhnp->bhp", cf[:, t], hst)
    return ys


@pytest.mark.parametrize("s,chunk", [(8, 4), (12, 5), (16, 16), (7, 3)])
def test_ssd_chunked_matches_reference_and_recurrence(s, chunk):
    rng = np.random.default_rng(s * 10 + chunk)
    b, h, p, g, n = 2, 4, 4, 1, 4
    x, bmat, cmat = _rand(rng, b, s, h, p), _rand(rng, b, s, g, n), _rand(rng, b, s, g, n)
    dt = np.log1p(np.exp(_rand(rng, b, s, h)))
    a_log = np.zeros(h, np.float32)
    jcfg = jm.Mamba2Config(d_model=8, d_state=4, head_dim=4, chunk=chunk)
    cfg = mamba2.Mamba2Config(d_model=8, d_state=4, head_dim=4, chunk=chunk)
    want, want_h = jm._ssd_chunked(jcfg, *map(jnp.asarray, (x, bmat, cmat, dt, a_log)))
    got, got_h = mamba2._ssd_chunked(cfg, *map(torch.from_numpy, (x, bmat, cmat, dt, a_log)))
    assert got.shape == (b, s, h, p) and got_h.shape == (b, h, n, p)
    _close(got, want, (1e-4, 1e-5))
    _close(got_h, want_h, (1e-4, 1e-5))
    np.testing.assert_allclose(got.numpy(), _ssd_recurrence(x, bmat, cmat, dt, a_log),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dt", DTYPES)
def test_layer_matches_reference(params, dt):
    """Prefill (11 steps, chunk 4: two chunks and a ragged one) with its
    final states, then one decode step from them."""
    tdt, jdt, tol = DTYPES[dt]
    jcfg, cfg = jm.Mamba2Config(**CFG), mamba2.Mamba2Config(**CFG)
    pp = params_from_numpy(params, device="cpu")
    u = _rand(np.random.default_rng(3), 2, 12, 16)
    ju, tu = jnp.asarray(u).astype(jdt), torch.from_numpy(u).to(tdt)
    want, (wh, wc) = jm.mamba2_layer(params, jcfg, ju[:, :11], return_state=True)
    got, (gh, gc) = mamba2.mamba2_layer(pp, cfg, tu[:, :11], return_state=True)
    assert got.dtype == tdt and gh.dtype == torch.float32 and gc.dtype == tdt
    _close(got, want, tol)
    _close(gh, wh, tol)
    _close(gc, wc, tol)
    want, (wh, _) = jm.mamba2_layer(params, jcfg, ju[:, 11:], ssm_state=wh,
                                    conv_state=wc, return_state=True)
    got, (gh, _) = mamba2.mamba2_layer(pp, cfg, tu[:, 11:], ssm_state=gh,
                                       conv_state=gc, return_state=True)
    _close(got, want, tol)
    _close(gh, wh, tol)


def test_decode_matches_prefill(params):
    """Token-by-token decode reproduces the chunked full-sequence output
    (tests/test_chunked_equivalence.py:95-114, 5e-3), starting from no
    state."""
    cfg = mamba2.Mamba2Config(**CFG)
    pp = params_from_numpy(params, device="cpu")
    u = torch.from_numpy(_rand(np.random.default_rng(9), 2, 10, 16))
    full = mamba2.mamba2_layer(pp, cfg, u)
    ssm = conv = None
    outs = []
    for t in range(10):
        o, (ssm, conv) = mamba2.mamba2_layer(pp, cfg, u[:, t:t + 1], ssm_state=ssm,
                                             conv_state=conv, return_state=True)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-3, atol=5e-3)
