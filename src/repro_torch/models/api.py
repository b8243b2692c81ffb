"""Family dispatch: one uniform API over every architecture family.

Every family module exposes:
    init_params(cfg, generator, device) -> params
    train_loss(params, batch, cfg, remat=...) -> (loss, metrics)   [not cnn]
    prefill(params, inputs, cfg, cache_len, last_pos=, cache=) -> (last_logits, cache)
    decode_step(params, cache, token, pos, cfg) -> (logits, cache)
    init_cache(cfg, batch, seq, dtype, device)
The language-model families are dense and moe (the transformer), ssm
(RWKV-6), hybrid (RecurrentGemma), audio (the Whisper encoder-decoder) and
vlm (LLaVA-NeXT); the paper's CNN payloads (``cnn``) have ``init_params``
here, then ``cnn.forward``/``cnn.predict``, and no prefill, decode or cache.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device, shardctx

from . import cnn, encdec, hybrid, ssm, transformer, vlm
from .common import ModelConfig, leaf_paths

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "ssm": ssm,
    "hybrid": hybrid,
    "audio": encdec,
    "vlm": vlm,
    "cnn": cnn,
}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"unknown family {cfg.family!r}; the port has "
                                  f"{sorted(_FAMILIES)}")
    return _FAMILIES[cfg.family]


def _lm_module(cfg: ModelConfig):
    """The family module of a language model: the cnn family serves images
    and has no token prefill, decode step or cache."""
    if cfg.family == "cnn":
        raise ValueError(f"{cfg.name}: the cnn family classifies images "
                         "(repro_torch.models.cnn.forward); it has no prefill, "
                         "decode step or cache")
    return module_for(cfg)


def init_params(cfg: ModelConfig, generator, device):
    return module_for(cfg).init_params(cfg, generator, device)


def abstract_params(cfg: ModelConfig):
    """The param tree of ``cfg`` as meta tensors: the shapes and dtypes,
    no memory (what the partition rules read)."""
    meta = torch.device("meta")
    with meta:
        return init_params(cfg, torch.Generator(), meta)


def train_loss(params, batch, cfg: ModelConfig, **kw):
    """-> (loss, {"xent", "aux"}) of ``batch`` (``tokens``, ``labels``, and
    the audio and vlm families' ``frame_embeds`` or ``patch_embeds``)."""
    return _lm_module(cfg).train_loss(params, batch, cfg, **kw)


def seq_partial_leaves(cfg: ModelConfig, params, batch) -> list:
    """Per leaf of ``params`` (``tensor_leaves`` order): whether sequence
    parallelism on the ambient mesh leaves a rank with its share of the
    leaf's gradient over "model" for ``batch``, so that the train step must
    sum it (what the rules cut over "model" is a rank's own whatever this
    says).  Each stack whose stream ``shardctx.seq_cut`` cuts applies every
    leaf to a rank's tokens or inside a block whose gradients are shares
    (the audio family's encoder by its frames, its decoder and positions
    by its tokens, every other family by its tokens), except the
    embedding and unembedding tables: where the rules leave one whole on
    the model axis, every model rank applies it to the whole sequence
    (``layers.embed``, ``unembed``), so its gradient is whole."""
    cut = shardctx.seq_cut(batch["tokens"], 1)
    enc = cfg.family == "audio" and shardctx.seq_cut(batch["frame_embeds"], 1)
    return [False if keys[0] == "embed" else enc if keys[0] in ("enc_layers", "enc_ln_post")
            else cut for keys in leaf_paths(params)]


def prefill(params, inputs, cfg: ModelConfig, cache_len: int | None = None,
            last_pos=None, cache: dict | None = None):
    """``inputs``: ``tokens`` (B,S), and for the audio and vlm families
    their stubbed frontend's ``frame_embeds`` or ``patch_embeds``, which
    those families' prefills take with the whole dict, as the reference's.
    ``last_pos`` (int or (B,) int tensor) selects which position's logits
    to return — the bucketed-prefill hook (right-padded prompts read their
    real last token, not the pad tail).  Only the dense family's callers
    pass one: a recurrent state is length-sensitive and pad tokens would
    change MoE routing, so the other families' callers keep exact-length
    prompts (the ssm, hybrid, audio and vlm prefills refuse a
    ``last_pos``).  ``cache`` is a preallocated cache (or recurrent state)
    written in place."""
    mod = _lm_module(cfg)
    if cfg.family in ("audio", "vlm"):
        return mod.prefill(params, inputs, cfg, cache_len, last_pos=last_pos, cache=cache)
    return mod.prefill(params, inputs["tokens"], cfg, cache_len, last_pos=last_pos,
                       cache=cache)


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    return _lm_module(cfg).decode_step(params, cache, token, pos, cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None, device="cuda"):
    """A zeroed cache (or recurrent state) on ``device``: the card unless
    the caller asks for the CPU; raises when the card is asked for and
    there is none."""
    return _lm_module(cfg).init_cache(cfg, batch, seq, dtype, resolve_device(device))
