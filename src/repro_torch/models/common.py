"""Shared model pieces: parameter specs, norms, RoPE, MLPs, embeddings and
the LM losses (the reference's ``repro/models/common.py``).

Parameters are declared as trees of :class:`ParamSpec` (nested dicts with
specs as leaves); :func:`materialize` turns a spec tree into a tree of
tensors on a device, drawn from a ``torch.Generator``.  Every function
takes and returns tensors of the reference's shapes and dtypes, and
rounds where the reference rounds.  The reference's activation
annotations (``shard_annotate``, ``set_activation_rules``) have nothing
to act on in eager PyTorch: the port's forward leaves their calls out.
On a mesh the train and serve steps hand each leaf over as the rank's
block (``dist.collectives.LocalBlock``) and the layers compute on their
blocks, under autograd too (each collective's backward its adjoint): :func:`weight` makes a leaf ready for use (a block gathered over
the axes its use does not split), :func:`block` says which rows of a dim
a rank holds, :func:`rows` takes a range of a dim from the block where
it holds it, :func:`embed` looks its vocabulary block up and
all-reduces, :func:`unembed` is column-parallel over the vocabulary with
the logits all-gathered, :func:`swiglu` and :func:`gelu_mlp` column-
then row-parallel with one all-reduce, :func:`rmsnorm` over a dim split
across ranks all-reduces its sum of squares.  The dry-run's stand-ins are
:func:`abstract`'s fake tensors (``launch/dryrun.py``).
:func:`grad_barrier` is an identity (an XLA scheduling hint in the
reference), and the forward leaves its calls out too.

:func:`remat` is the reference's ``jax.checkpoint``: under autograd it
keeps a function's inputs and recomputes what its backward needs
(``torch.utils.checkpoint``, non-reentrant); with grad off, or when no
input requires grad, it is a plain call.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    """Declarative parameter: shape, logical axes, initializer."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # stddev override
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             f"in rank")


def tree_map(fn, tree):
    """``fn`` on every leaf of a tree of nested dicts, keys in sorted order
    (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def unstack(tree, n: int) -> list:
    """A tree of tensors stacked on a leading axis of ``n`` (the
    reference's scanned layers) as ``n`` trees of views, in order."""
    stacked = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda ts, i=i: ts[i], stacked) for i in range(n)]


def weight(w, dtype=None, *, keep: int | None = None) -> torch.Tensor:
    """A parameter leaf ready for use in ``dtype``: a tensor cast; a
    rank's block on a mesh (``dist.collectives.LocalBlock``) cast, then
    gathered over every mesh axis that shards it but ``model`` along dim
    ``keep``, which stays split."""
    if isinstance(w, torch.Tensor):
        return w if dtype is None else w.to(dtype)
    return w.gathered(dtype, keep=keep)


def block(w, dim: int, axis: str = "model") -> tuple[int, int, bool]:
    """``(start, stop, split)``: the rows of dim ``dim`` that :func:`weight`
    with ``keep=dim`` returns, and whether that dim is split over ``axis``
    (a tensor: its whole dim, unsplit)."""
    if isinstance(w, torch.Tensor):
        return 0, w.shape[dim], False
    return w.block(dim, axis)


def rows(w, lo: int, hi: int, dtype=None, *, dim: int = 0) -> torch.Tensor:
    """Entries ``lo:hi`` of dim ``dim`` of a parameter leaf in ``dtype``:
    from the rank's block where it holds them (:func:`weight` with
    ``keep=dim``), else from the leaf gathered whole."""
    wlo, whi, _ = block(w, dim)
    if wlo <= lo and hi <= whi:
        t = weight(w, dtype, keep=dim)
    else:
        t, wlo = weight(w, dtype), 0
    return t.narrow(dim, lo - wlo, hi - lo)


def _init_array(spec: ParamSpec, generator: torch.Generator, dtype, device):
    dtype = dtype or spec.dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    std = spec.scale
    if std is None:
        # fan-in scaled normal over the last-but-one dim by convention
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, device=device)
    return (x * std).to(dtype)


def materialize(spec_tree, generator: torch.Generator, dtype=None, *,
                device):
    """Spec tree -> tensor tree on ``device`` (the generator's device),
    the leaves drawn from ``generator`` one after another in sorted-key
    order.  The reference's fan-in-scaled normal, not its bits:
    ``jax.random`` and ``torch.randn`` draw different numbers, so tests
    carry the reference's own parameters across instead."""
    return tree_map(lambda s: _init_array(s, generator, dtype, device),
                    spec_tree)


def abstract(spec_tree, dtype=None, *, device):
    """Spec tree -> tree of uninitialized tensors on ``device`` (the
    reference's ``ShapeDtypeStruct`` stand-ins): made by ``torch.empty``,
    so under the caller's ``FakeTensorMode`` they are fake tensors with no
    storage, and no initializer runs (a random draw on a fake CUDA tensor
    needs a card)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype or s.dtype,
                                          device=device), spec_tree)


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


#: the leaves every use takes in f32, not in the compute dtype: the MoE
#: router (``router_dtype``), the Mamba2 decay, step bias and skip,
#: layernorm's scale and bias (applied uncast to the f32 activations) and
#: the sLSTM's recurrent weights
F32_LEAVES = frozenset({"router", "a_log", "dt_bias", "d_skip", "scale",
                        "bias", "r_z", "r_i", "r_f", "r_o"})


def cast_params(params, dtype: torch.dtype):
    """Every floating parameter cast once to ``dtype`` (the compute
    dtype), but the :data:`F32_LEAVES`, which stay as they are.  Every
    other use of a model parameter casts it to the compute dtype first
    (the embedding after its gather, which commutes with the cast), so
    the forward on the cast tree gives the same bits as on the f32 tree,
    without a cast per use."""
    if isinstance(params, dict):
        return {k: v if k in F32_LEAVES else cast_params(v, dtype)
                for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


# ---------------------------------------------------------------------------
# Autograd: the reference's checkpoints and barrier
# ---------------------------------------------------------------------------


def grad_barrier(x):
    """The reference's ``grad_barrier`` (an optimization barrier on the
    value and on its cotangent): an identity in both directions here, as
    eager PyTorch has no scheduler to hold back."""
    return x


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return any(_requires_grad(v) for v in tree)
    # a rank's block (``LocalBlock``) counts by its tensor
    tree = getattr(tree, "tensor", tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


#: the matmuls ``remat(..., mode="dots")`` keeps (the reference's
#: ``checkpoint_dots`` policy: every dot's output saved, the rest
#: recomputed)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots():
    return create_selective_checkpoint_contexts(_dots_policy)


def _labelled(fn):
    """``fn`` inside a profiler range named ``remat``, so a trace tells
    the recompute (the range on the backward's thread) apart."""
    def run(*args):
        with record_function("remat"):
            return fn(*args)
    return run


def remat(fn, *args, mode: str = "full"):
    """``fn(*args)`` under the reference's ``jax.checkpoint``, as ``mode``
    (a config's ``remat``) says: ``"full"`` keeps only the inputs and the
    backward recomputes the rest, ``"dots"`` keeps the matmul outputs too
    (the reference's ``checkpoint_dots``), ``"none"`` is a plain call.
    It checkpoints only when grad mode is on and a tensor among ``args``
    (tensors or dicts and tuples of them: a layer's parameters are passed
    as an argument, not closed over, so that they count; a rank's block
    counts by its tensor) requires grad;
    otherwise a plain call, so a forward with grad off is unchanged."""
    if mode == "none" or not (torch.is_grad_enabled()
                              and _requires_grad(args)):
        return fn(*args)
    kw = {"context_fn": _save_dots} if mode == "dots" else {}
    return checkpoint(_labelled(fn), *args, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(w, x, eps: float = 1e-6, *, split=None):
    """RMSNorm with the reference's rounding: the sum of squares in f32,
    the per-row rsqrt cast to the compute dtype, then ``w * (x * scale)``
    in the compute dtype.  ``split`` ``(mesh, width)``: ``x`` holds a
    block of a normalized dim of ``width`` split over ``model`` (``w``
    the same block), its sum of squares all-reduced over the axis."""
    dt = x.dtype
    xf = x.float()
    ss = torch.einsum("...d,...d->...", xf, xf)[..., None]
    width = x.shape[-1]
    if split is not None:
        from ..dist.collectives import all_reduce

        mesh, width = split
        ss = all_reduce(ss, mesh, "model")
    scale = torch.rsqrt(ss / width + eps).to(dt)
    return weight(w, dt) * (x * scale)


def layernorm_spec(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones"),
            "bias": ParamSpec((d,), ("embed",), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)
    return (weight(p["scale"]) * (xf - mu) * torch.rsqrt(var + eps)
            + weight(p["bias"])).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (with partial-dim support for GLM4)
# ---------------------------------------------------------------------------


def rope_angles(positions, head_dim: int, *, theta: float = 10000.0,
                fraction: float = 1.0):
    """Return (cos, sin) of shape (..., rot_dim/2) for given positions, and
    the rotated dims ``rot``."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv                  # (..., rot/2)
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x, cos, sin, rot: int):
    """x: (B, S, H, D); rotate the first ``rot`` dims in interleaved pairs
    (``0::2`` with ``1::2``).  The rotation is computed in f32 (cos and sin
    are f32 tensors, so a bf16 ``x`` is promoted, as in the reference) and
    returned in f32; the caller casts back."""
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp.to(xr.dtype)], dim=-1) if rot < x.shape[-1] else xr


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_spec(d: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d), ("mlp", "embed")),
    }


def _silu(x):
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``, each op rounded to
    x's dtype as the reference rounds it (``F.silu`` rounds once, which
    differs in the last bf16 place at a third of the points)."""
    return x * (1 / (1 + torch.exp(-x)))


def swiglu(p, x):
    """On a mesh: the gate and up products on the rank's ``mlp`` columns,
    the down product on the same rows, all-reduced over ``model``."""
    dt = x.dtype
    g = x @ weight(p["w_gate"], dt, keep=1)
    u = x @ weight(p["w_up"], dt, keep=1)
    return row_parallel(_silu(g) * u, block(p["w_gate"], 1), p["w_down"], dt)


def row_parallel(h, rows: tuple[int, int, bool], w, dtype):
    """``h @ w`` contracted over ``w``'s leading dims but the last (``w``
    ``(n, *inner, d)``, ``h`` ``(..., n_h, *inner)``), where ``h`` holds
    the rows ``rows`` of the leading one (``(start, stop, split)``,
    :func:`block`): the product of the rows both hold, all-reduced over
    ``model`` where either side is split.  Either side may hold the dim
    whole: the other's block is taken from it."""
    wt = weight(w, dtype, keep=0)
    inner = wt.ndim - 2
    lo, hi, split = rows
    wlo, whi, wsplit = block(w, 0)
    if (lo, hi) != (wlo, whi):
        if not wsplit:
            wt = wt[lo:hi]
        elif not split:
            h = h.narrow(h.ndim - inner - 1, wlo, whi - wlo)
        else:
            raise ValueError(f"rows {(lo, hi)} against a weight's block "
                             f"{(wlo, whi)} of the same dim")
    out = h.flatten(h.ndim - inner - 1) @ wt.reshape(-1, wt.shape[-1])
    if split or wsplit:
        from ..dist.collectives import all_reduce

        out = all_reduce(out, w.mesh, "model")
    return out


def gelu_mlp_spec(d: int, d_ff: int) -> dict:
    return {
        "w_in": ParamSpec((d, d_ff), ("embed", "mlp")),
        "b_in": ParamSpec((d_ff,), ("mlp",), init="zeros"),
        "w_out": ParamSpec((d_ff, d), ("mlp", "embed")),
        "b_out": ParamSpec((d,), ("embed",), init="zeros"),
    }


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, each op in x's
    dtype (the reference's constants round to it first)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype)
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def gelu_mlp(p, x):
    """On a mesh: the input product and its bias on the rank's ``mlp``
    columns, the output product on the same rows all-reduced over
    ``model``, then its bias."""
    dt = x.dtype
    lo, hi, split = block(p["w_in"], 1)
    h = x @ weight(p["w_in"], dt, keep=1) + rows(p["b_in"], lo, hi, dt)
    h = _gelu(h)
    return row_parallel(h, (lo, hi, split), p["w_out"], dt) + weight(p["b_out"], dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding / loss
# ---------------------------------------------------------------------------


def embedding_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)


def embed(table, tokens):
    """Rows of ``table`` at ``tokens`` (any integer dtype).  On a mesh
    with the vocabulary split over ``model``: each rank looks up the
    tokens in its block, zero for the others, and the rows are
    all-reduced (one rank adds each row, the others zeros: exact)."""
    lo, hi, split = block(table, 0)
    t = weight(table, keep=0)
    ids = tokens.reshape(-1)
    if split:
        ids = ids - lo
        held = (ids >= 0) & (ids < hi - lo)
        ids = ids.clamp(0, hi - lo - 1)
    rows = t.index_select(0, ids)
    if split:
        from ..dist.collectives import all_reduce

        rows = all_reduce(rows.masked_fill(~held[:, None], 0), table.mesh,
                          "model")
    return rows.reshape(*tokens.shape, t.shape[-1])


def unembed_spec(d: int, vocab: int) -> ParamSpec:
    return ParamSpec((d, vocab), ("embed", "vocab"))


def unembed(w, x, *, tied: bool = False):
    """``x @ w`` (``w`` (d, vocab)), or with ``tied`` ``x @ w.T`` (``w``
    the (vocab, d) embedding).  On a mesh: the rank's vocabulary columns,
    the logits all-gathered over ``model`` (the reference's serve steps
    return them whole)."""
    vocab = 0 if tied else 1
    wt = weight(w, x.dtype, keep=vocab)
    logits = x @ (wt.t() if tied else wt)
    if block(w, vocab)[2]:
        from ..dist.collectives import all_gather

        logits = all_gather(logits, w.mesh, "model", -1)
    return logits


def _xent_terms(lf, labels, z_loss: float):
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels[..., None].long())[..., 0]
    per_tok = lse - ll
    if z_loss:
        per_tok = per_tok + z_loss * lse**2
    return per_tok


#: (token count, scale) of the data-parallel micro-batch that the rank's
#: rows belong to, set by :func:`xent_over`
_XENT_OVER: list = []


@contextmanager
def xent_over(count: torch.Tensor, scale: int):
    """Inside the block, :func:`masked_xent` with a mask divides the
    masked sum by ``count`` (the mask's sum over the whole data-parallel
    micro-batch, all-reduced, in place of this rank's) and multiplies by
    ``scale`` (the data ranks), so the ranks' losses and gradients
    average to those of the whole micro-batch, however unequally its
    tokens fall to the ranks.  A mean without a mask needs neither: every
    rank has the same number of rows."""
    _XENT_OVER.append((count, scale))
    try:
        yield
    finally:
        _XENT_OVER.pop()


@record_function("masked_xent")
def masked_xent(logits, labels, mask=None, *, vocab: int,
                vocab_padded: int | None = None, z_loss: float = 0.0):
    """Stable masked cross entropy with padded-vocab masking (f32 math).
    Runs inside a profiler range of its name (a train step's device split
    reads it).  Inside :func:`xent_over`, the masked sum is normalized by
    the data-parallel micro-batch's tokens."""
    vpad = vocab_padded or vocab
    lf = logits.float()
    if vpad != vocab:
        pad = torch.arange(vpad, device=lf.device) >= vocab
        lf = lf.masked_fill(pad, -1e30)
    per_tok = _xent_terms(lf, labels, z_loss)
    if mask is None:
        return per_tok.mean()
    maskf = mask.float()
    if not _XENT_OVER:
        return (per_tok * maskf).sum() / maskf.sum().clamp_min(1.0)
    count, scale = _XENT_OVER[-1]
    loss = (per_tok * maskf).sum() / count.clamp_min(1.0)
    return loss if scale == 1 else loss * scale


def softmax_xent(logits, labels, *, z_loss: float = 0.0):
    """Stable per-token cross entropy, mean over tokens (f32 math)."""
    return _xent_terms(logits.float(), labels, z_loss).mean()
