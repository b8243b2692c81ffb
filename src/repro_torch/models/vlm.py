"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

As in the reference, the vision tower and the multimodal projector are a
stub: the inputs carry precomputed, already projected patch embeddings
``(B, num_image_tokens, d_model)`` (up to 5 anyres tiles of 576 patches =
2880 image tokens).  This module is the language model: the token
embeddings with the leading positions replaced by the patch embeddings, then
the transformer (``models/transformer.py``), whose prefill attention is K1
and whose decode attention is K2 on the card.  The cache is the
transformer's.  ``train_loss`` is the transformer's cross-entropy over the
text positions only.
"""
from __future__ import annotations

import torch

from . import transformer
from .common import ModelConfig
from .layers import embed

init_params = transformer.init_params
init_cache = transformer.init_cache
decode_step = transformer.decode_step


def merge_embeddings(params, tokens, patch_embeds, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings (B,S,d) with positions [0, min(P, S)) overwritten by
    the patch embeddings, cast to the compute dtype."""
    x = embed(params["embed"], tokens, cfg).to(cfg.cdt)
    p = min(patch_embeds.shape[1], x.shape[1])
    x[:, :p] = patch_embeds[:, :p].to(cfg.cdt)
    return x


def _patches(inputs: dict, cfg: ModelConfig) -> torch.Tensor:
    if "patch_embeds" not in inputs:
        raise KeyError(f"{cfg.name}: the vlm family's inputs need 'patch_embeds' "
                       f"(B, {cfg.num_image_tokens}, {cfg.d_model}), the projected image "
                       f"patches, beside 'tokens'; got {sorted(inputs)}")
    return inputs["patch_embeds"]


def forward(params, inputs: dict, cfg: ModelConfig, *, remat: bool = False):
    """inputs: ``tokens`` (B,S) and ``patch_embeds`` (B,P,d).  -> (logits
    (B,S,V), aux 0)."""
    x = merge_embeddings(params, inputs["tokens"], _patches(inputs, cfg), cfg)
    return transformer.forward(params, inputs["tokens"], cfg, input_embeds=x, remat=remat)


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """The cross-entropy over the text positions (those from
    ``num_image_tokens`` on), averaged over them and the batch; the image
    positions add nothing.  -> (loss, {"xent", "aux"})."""
    logits, aux = forward(params, batch, cfg, remat=remat)
    s = batch["tokens"].shape[1]
    text = (torch.arange(s, device=logits.device) >= cfg.num_image_tokens).float()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    loss = torch.sum((logz - ll) * text) / torch.clamp(text.sum() * logits.shape[0], min=1.0)
    loss = loss + aux
    return loss, {"xent": loss, "aux": aux}


def prefill(params, inputs: dict, cfg: ModelConfig, cache_len: int | None = None, *,
            last_pos=None, cache: dict | None = None):
    """The transformer's prefill over the merged embeddings.  -> (last
    logits (B,V), cache).  Raises ``KeyError`` when ``inputs`` holds no
    ``patch_embeds``, where the reference's prefill raises it too.
    ``last_pos`` must be None: the reference's vlm prefill reads the last
    position only, so callers keep exact-length prompts.  ``cache`` is
    written in place, as the transformer's."""
    if last_pos is not None:
        raise ValueError(f"{cfg.name}: the vlm prefill takes exact-length prompts "
                         "(last_pos=None)")
    x = merge_embeddings(params, inputs["tokens"], _patches(inputs, cfg), cfg)
    return transformer.prefill(params, inputs["tokens"], cfg, cache_len, input_embeds=x,
                               cache=cache)
