"""pixtral-12b: mistral-nemo decoder backbone + stub patch-embedding
frontend [hf:mistralai/Pixtral-12B-2409; unverified].

The vision tower is a stub: the batch carries precomputed patch
embeddings (B, 256, d_model), which the LM prepends to the token stream
(``LMConfig.image_prefix``)."""
import torch

from ..models.common import ParamSpec
from ..models.lm import LMConfig
from ._lm_family import lm_arch
from .base import ShapeSpec

SOURCE = "[hf:mistralai/Pixtral-12B-2409; unverified]"


def _patches(shape: ShapeSpec, cfg: LMConfig):
    if shape.kind == "decode":
        return None                     # patches live in the prefill cache
    return ParamSpec((shape.global_batch, cfg.image_prefix, cfg.d_model),
                     ("batch", None, "embed"), dtype=torch.bfloat16)


def full():
    cfg = LMConfig(
        name="pixtral-12b",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, image_prefix=256,
        attn_impl="chunked", remat="full",
    )
    return lm_arch("pixtral-12b", cfg, family="vlm", profile="tp_fsdp",
                   source=SOURCE, extra_inputs={"patch_embeds": _patches},
                   train_accum=8)


def smoke():
    cfg = LMConfig(
        name="pixtral-smoke",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab=512, image_prefix=8,
        attn_impl="dense", vocab_pad_multiple=64,
    )
    return lm_arch("pixtral-12b", cfg, family="vlm", profile="tp_fsdp",
                   source=SOURCE, extra_inputs={"patch_embeds": _patches})
