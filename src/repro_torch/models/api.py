"""Family dispatch: one uniform API over the ported architecture families.

Every family module exposes:
    init_params(cfg, generator, device) -> params
    prefill(params, tokens, cfg, cache_len, last_pos=, cache=) -> (last_logits, cache)
    decode_step(params, cache, token, pos, cfg) -> (logits, cache)
    init_cache(cfg, batch, seq, dtype, device)
The dense, moe (the transformer with MoE layers) and ssm (RWKV-6) families
are ported so far, and the paper's CNN payloads (``cnn``: ``init_params``
here, then ``cnn.forward``/``cnn.predict``); the cnn family has no prefill,
decode or cache.
"""
from __future__ import annotations

from repro_torch import resolve_device

from . import cnn, ssm, transformer
from .common import ModelConfig

_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": ssm, "cnn": cnn}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP.md Queue 1)")
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


def prefill(params, inputs, cfg: ModelConfig, cache_len: int | None = None,
            last_pos=None, cache: dict | None = None):
    """``last_pos`` (int or (B,) int tensor) selects which position's logits
    to return — the bucketed-prefill hook (right-padded prompts read their
    real last token, not the pad tail).  Only the dense family's callers
    pass one: a recurrent state is length-sensitive and pad tokens would
    change MoE routing, so ssm and moe callers keep exact-length prompts
    (ssm's prefill refuses a ``last_pos``).  ``cache`` is a
    preallocated cache (or recurrent state) written in place."""
    return _lm_module(cfg).prefill(params, inputs["tokens"], cfg, cache_len,
                                   last_pos=last_pos, cache=cache)


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    return _lm_module(cfg).decode_step(params, cache, token, pos, cfg)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None, device="cuda"):
    """A zeroed cache (or recurrent state) on ``device``: the card unless
    the caller asks for the CPU; raises when the card is asked for and
    there is none."""
    return _lm_module(cfg).init_cache(cfg, batch, seq, dtype, resolve_device(device))
