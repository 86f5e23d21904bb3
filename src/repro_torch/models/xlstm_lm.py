"""xLSTM language model: a stack of mLSTM blocks with sLSTM blocks at
configurable depths (Beck et al. 2024), pre-LN residual layout (the
reference's ``repro/models/xlstm_lm.py``).

The xlstm-125m config has d_ff = 0: the feed-forward capacity lives inside
the blocks (mLSTM 2x up-projection, sLSTM 4/3 gated post-MLP).  Layers are
heterogeneous (two parameter structures), so each is a ``layer_{i}``
subtree and the stack a loop.  ``remat`` other than ``"none"``
checkpoints each block (the reference's ``jax.checkpoint``): the backward
keeps a block's input and recomputes the rest; ``"dots"`` keeps the
matmul outputs too, as in :mod:`.lm` (the reference checkpoints it as
``"full"``: the same grads).  Decode carries
per-layer recurrent states (the matrix memory of an mLSTM, the scalar cell
of an sLSTM): O(1) a token.  The cache is ``{"layer_{i}": {...}, "length":
int}`` with the length on the host.  On a mesh (the serve steps of
``train/steps.py``) each state leaf comes as the rank's block
(``dist.collectives.LocalBlock``: its rows, and its heads where the input
profile splits them over ``model``): a rank reads its rows' states with
every head gathered, computes every head, and writes its block back in
place.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import (
    ParamSpec,
    embed,
    tree_map,
    embedding_spec,
    masked_xent,
    remat,
    rmsnorm,
    rmsnorm_spec,
    unembed,
    unembed_spec,
)
from .lm import pad_vocab
from .xlstm import (
    XLSTMConfig,
    mlstm_block,
    mlstm_spec,
    slstm_block,
    slstm_spec,
)


@dataclass(frozen=True)
class XLSTMLMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    vocab: int
    slstm_at: tuple[int, ...] = (3, 7)
    chunk: int = 256
    mlstm_impl: str = "chunked"
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: str = "none"            # none | full | dots (as lm's)
    vocab_pad_multiple: int = 2048
    z_loss: float = 0.0

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab, self.vocab_pad_multiple)

    @property
    def block_cfg(self) -> XLSTMConfig:
        return XLSTMConfig(d_model=self.d_model, n_heads=self.n_heads,
                           chunk=self.chunk, mlstm_impl=self.mlstm_impl)

    def is_slstm(self, i: int) -> bool:
        return i in self.slstm_at


def xlstm_lm_spec(cfg: XLSTMLMConfig) -> dict:
    layers = {}
    for i in range(cfg.n_layers):
        kind = "slstm" if cfg.is_slstm(i) else "mlstm"
        block = (slstm_spec if cfg.is_slstm(i) else mlstm_spec)(cfg.block_cfg)
        layers[f"layer_{i}"] = {"ln": rmsnorm_spec(cfg.d_model), kind: block}
    return {
        "embedding": embedding_spec(cfg.vocab_padded, cfg.d_model),
        "layers": layers,
        "ln_f": rmsnorm_spec(cfg.d_model),
        "unembed": unembed_spec(cfg.d_model, cfg.vocab_padded),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block(p_l, cfg: XLSTMLMConfig, i: int, h, *, state=None,
           return_state=False):
    bc = cfg.block_cfg
    x = rmsnorm(p_l["ln"], h, cfg.norm_eps)
    if cfg.is_slstm(i):
        out = slstm_block(p_l["slstm"], bc, x, state=state,
                          return_state=return_state)
    else:
        out = mlstm_block(p_l["mlstm"], bc, x, state=state,
                          return_state=return_state)
    if return_state:
        o, st = out
        return h + o, st
    return h + out


def hidden_states(params, cfg: XLSTMLMConfig, tokens):
    h = embed(params["embedding"], tokens).to(cfg.dtype)
    for i in range(cfg.n_layers):
        p_l = params["layers"][f"layer_{i}"]
        h = remat(_block, p_l, cfg, i, h, mode=cfg.remat)
    return rmsnorm(params["ln_f"], h, cfg.norm_eps)


def loss_fn(params, cfg: XLSTMLMConfig, batch):
    h = hidden_states(params, cfg, batch["tokens"])
    logits = unembed(params["unembed"], h)
    loss = masked_xent(logits, batch["labels"], batch.get("mask"),
                       vocab=cfg.vocab, vocab_padded=cfg.vocab_padded,
                       z_loss=cfg.z_loss)
    return loss, {"loss": loss, "aux_loss": 0.0}


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: XLSTMLMConfig, batch: int, max_len: int) -> dict:
    """Recurrent decode state (max_len is irrelevant: O(1) state)."""
    bc = cfg.block_cfg
    out: dict = {}
    for i in range(cfg.n_layers):
        if cfg.is_slstm(i):
            shape = (batch, bc.n_heads, bc.s_head_dim)
            axes = ("batch", "heads", None)
            out[f"layer_{i}"] = {
                key: ParamSpec(shape, axes, init="ones" if key == "n" else "zeros",
                               dtype=torch.float32)
                for key in ("c", "n", "hid", "m")}
        else:
            h, p = bc.n_heads, bc.head_dim
            out[f"layer_{i}"] = {
                "c": ParamSpec((batch, h, p, p), ("batch", "heads", None, None),
                               init="zeros", dtype=torch.float32),
                "n": ParamSpec((batch, h, p), ("batch", "heads", None),
                               init="zeros", dtype=torch.float32),
                "m": ParamSpec((batch, h), ("batch", "heads"),
                               init="zeros", dtype=torch.float32),
            }
    out["length"] = ParamSpec((), (), init="zeros", dtype=torch.int32)
    return out


def _state_tuple(cfg: XLSTMLMConfig, i: int, entry: dict | None):
    if entry is None:
        return None
    if cfg.is_slstm(i):
        return (entry["c"], entry["n"], entry["hid"], entry["m"])
    return (entry["c"], entry["n"], entry["m"])


def _state_dict(cfg: XLSTMLMConfig, i: int, st) -> dict:
    if cfg.is_slstm(i):
        c, n, hid, m = st
        return {"c": c, "n": n, "hid": hid, "m": m}
    c, n, m = st
    return {"c": c, "n": n, "m": m}


def _rows_whole(leaf):
    """A state leaf as the rank's rows with every head: a tensor as it
    is, a block with its other dims gathered whole."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return leaf.gathered(keep=0, axis=leaf.sharding.spec[0])


def _run_with_state(params, cfg: XLSTMLMConfig, tokens, cache):
    h = embed(params["embedding"], tokens).to(cfg.dtype)
    new_cache: dict = {}
    for i in range(cfg.n_layers):
        key = f"layer_{i}"
        entry = cache.get(key) if cache else None
        st = _state_tuple(cfg, i, None if entry is None
                          else tree_map(_rows_whole, entry))
        h, st = _block(params["layers"][key], cfg, i, h, state=st,
                       return_state=True)
        new_cache[key] = _state_dict(cfg, i, st)
    return rmsnorm(params["ln_f"], h, cfg.norm_eps), new_cache


def _written(blocks: dict, new_cache: dict) -> dict:
    """The states of ``new_cache`` (the rank's rows, every head) written
    into the part of them that the cache's blocks (``blocks``, a mesh
    step's) hold, in place, and the blocks returned; ``new_cache``
    itself without blocks."""
    if blocks is None:
        return new_cache
    for key, entry in new_cache.items():
        for k, t in entry.items():
            dst = blocks[key][k]
            dst.tensor.copy_(t[(slice(None), *dst.index[1:])])
    return {k: v for k, v in blocks.items() if k != "length"}


def prefill(params, cfg: XLSTMLMConfig, batch, *, max_len: int | None = None,
            cache: dict | None = None):
    """Process the prompt; return (last-token logits, the states after it).
    ``max_len`` is taken for the launcher's signature: the state is O(1).
    ``cache`` (a mesh step's): the rank's blocks of every state leaf,
    written in place."""
    tokens = batch["tokens"]
    h, states = _run_with_state(params, cfg, tokens, None)
    logits = unembed(params["unembed"], h[:, -1:, :])
    return logits, {**_written(cache, states), "length": tokens.shape[1]}


def decode_step(params, cfg: XLSTMLMConfig, cache, batch):
    """One-token decode (each mLSTM on its recurrence, S = 1); returns the
    logits and new states, ``length + 1`` (on a mesh the cache's blocks,
    written in place)."""
    h, states = _run_with_state(params, cfg, batch["tokens"], cache)
    logits = unembed(params["unembed"], h)
    blocks = None if isinstance(cache["layer_0"]["c"], torch.Tensor) else cache
    return logits, {**_written(blocks, states), "length": cache["length"] + 1}
