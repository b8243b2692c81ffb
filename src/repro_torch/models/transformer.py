"""Decoder-only transformer LM: dense / GQA / QKV-bias / MoE / sliding window.

The reference stacks layers on a leading axis and scans them; here the layer
stack is a list of per-layer param dicts walked by a Python loop.  The KV
cache keeps the reference layout, a dict of (L,B,S,K,hd) tensors, and is
written in place.  A MoE config (``num_experts > 0``) has a ``moe`` layer
(``models/moe.py``) where a dense one has its ``mlp``; only ``forward``
computes the MoE load-balance loss, as only the reference's training reads
it (its jitted prefill and decode drop it as dead code).

Under a mesh (``repro_torch.shardctx``) the params and the cache are a
rank's local shards and the batch its local rows; the tensor-parallel
collectives are in ``layers.py`` and ``moe.py``.  Where the rules cut the
cache's sequence (``launch.sharding.seq_cut``), a rank's cache holds its
chunk of the positions, and the prefill writes the prompt's keys and
values only where the rank owns them (``layers.write_prompt``).  Under
sequence parallelism (``shardctx.seq_cut`` of the tokens) the residual
stream between blocks is the rank's chunk of the positions: the
embedding's partial sums reduce-scattered to it (a whole ``input_embeds``
cut to it by ``shardctx.seq_scatter``), each block's input gathered along
the sequence and its output reduce-scattered back (``layers.py``,
``moe.py``), the final norm on the rank's tokens, and the prefill's last
positions read after one gather of the stream.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device, shardctx

from . import moe
from .common import ModelConfig, apply_norm, norm_init, remat as checkpointed
from .layers import (attn_init, attention_decode, attention_full, cache_positions, embed,
                     embed_init, mlp_apply, mlp_init, prompt_span, unembed, write_prompt)


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def layer_init(generator, cfg: ModelConfig, device) -> dict:
    p = {
        "ln1": norm_init(cfg.d_model, cfg.norm, cfg.pdt, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, cfg.pdt, device),
        "attn": attn_init(generator, cfg, device),
    }
    if cfg.is_moe:
        p["moe"] = moe.moe_init(generator, cfg, device)
    else:
        p["mlp"] = mlp_init(generator, cfg, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (torch's draws, not JAX's: tests convert reference weights
    with ``repro_torch.models.convert.from_reference`` instead)."""
    return {
        "embed": embed_init(generator, cfg, device),
        "layers": [layer_init(generator, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.pdt, device),
    }


# ----------------------------------------------------------------------
# forward (prefill)
# ----------------------------------------------------------------------

def _ffn(lp, h, cfg: ModelConfig, aux: list | None = None, cut_seq: bool = False):
    """The block's feed-forward: the MLP, or the MoE layer, whose
    load-balance loss is appended to ``aux`` when one is given."""
    if not cfg.is_moe:
        return mlp_apply(lp["mlp"], h, cfg, cut_seq=cut_seq)
    if aux is None:
        return moe.moe_ffn(lp["moe"], h, cfg, cut_seq=cut_seq)
    y, loss = moe.moe_apply(lp["moe"], h, cfg, cut_seq=cut_seq)
    aux.append(loss)
    return y


def _block(x, lp, positions, cfg: ModelConfig, aux: list | None = None,
           cut_seq: bool = False):
    x = shardctx.constrain_batch(x, seq_dim=1)
    h = apply_norm(lp["ln1"], x, cfg.norm)
    a, kv = attention_full(lp["attn"], h, positions, cfg, return_kv=True, cut_seq=cut_seq)
    x = x + a
    h = apply_norm(lp["ln2"], x, cfg.norm)
    return x + _ffn(lp, h, cfg, aux, cut_seq), kv


def _stream(params, tokens, cfg: ModelConfig, input_embeds=None):
    """-> (the stack's input: the tokens' embeddings, or ``input_embeds``
    (B,S,d) when given, in the compute dtype; the positions (S,); whether
    sequence parallelism cuts the stream, which the input then is this
    rank's chunk of)."""
    whole = tokens if input_embeds is None else input_embeds
    cut = shardctx.seq_cut(whole, 1)
    if input_embeds is None:
        x = embed(params["embed"], tokens, cfg, cut_seq=cut)
    else:
        x = input_embeds.to(cfg.cdt)
        x = shardctx.seq_scatter(x) if cut else x
    return x, torch.arange(whole.shape[1], device=x.device), cut


def _hidden(params, tokens, cfg: ModelConfig, on_kv=None, input_embeds=None):
    """The layer stack over the tokens' embeddings, or over ``input_embeds``
    (B,S,d) when given; calls ``on_kv(layer, k, v)`` with each layer's
    (B,S,K,hd) keys and values.  -> final hidden states before the norm,
    whole (gathered where sequence parallelism cut them)."""
    x, positions, cut = _stream(params, tokens, cfg, input_embeds)
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = _block(x, lp, positions, cfg, cut_seq=cut)
        if on_kv is not None:
            on_kv(i, k, v)
    return shardctx.seq_gather(x) if cut else x


def _layer(x, lp, positions, cfg: ModelConfig, cut_seq: bool = False):
    """One layer of ``forward``.  -> (x, the MoE layer's load-balance loss,
    or None for dense)."""
    aux = []
    x, _ = _block(x, lp, positions, cfg, aux, cut_seq)
    return x, (aux[0] if aux else None)


def forward(params, tokens, cfg: ModelConfig, *, input_embeds=None, remat: bool = False):
    """tokens: (B,S) int (or input_embeds (B,S,d)).  -> (logits (B,S,V),
    aux): the MoE layers' load-balance losses summed (0 for dense).  With
    ``remat`` each layer runs under activation checkpointing."""
    x, positions, cut = _stream(params, tokens, cfg, input_embeds)
    layer, aux = checkpointed(_layer, remat), []
    for lp in params["layers"]:
        x, loss = layer(x, lp, positions, cfg, cut)
        if loss is not None:
            aux.append(loss)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    total = torch.stack(aux).sum() if aux else torch.zeros((), device=x.device)
    return unembed(params["embed"], x, cfg, cut_seq=cut), total


# ----------------------------------------------------------------------
# loss
# ----------------------------------------------------------------------

def softmax_xent(logits, labels):
    """Mean cross-entropy of (B,S,V) logits against (B,S) labels, in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - ll).mean()


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """batch: ``tokens`` and ``labels`` (B,S), and ``input_embeds`` (B,S,d)
    where given.  -> (loss, {"xent", "aux"}): the cross-entropy plus the MoE
    load-balance loss (0 for dense)."""
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat,
                          input_embeds=batch.get("input_embeds"))
    loss = softmax_xent(logits, batch["labels"])
    return loss + aux, {"xent": loss, "aux": aux}


# ----------------------------------------------------------------------
# KV cache + decode
# ----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None,
               device="cuda") -> dict:
    device = resolve_device(device)
    dt = dtype or cfg.cdt
    shape = (cfg.num_layers, batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int | None = None,
            *, input_embeds=None, last_pos=None, cache: dict | None = None):
    """Returns (last_logits (B,V), cache dict (L,B,cache_len,K,hd)).
    ``input_embeds`` (B,S,d), when given, stands in for the tokens'
    embeddings (the vlm family's merged patch and token embeddings).

    ``last_pos`` selects which position's logits count as "last": an int or
    a (B,) int tensor of per-row indices.  A captured prefill
    (``serving/graphs.py::PrefillGraph``) always passes the (B,) tensor: an
    int would be baked into the graph.  Bucketed serving right-pads
    prompts to a shared length, so the real last token sits at
    ``length - 1``; causal masking keeps the logits there identical to an
    exact-length prefill (pad tokens only influence positions after
    themselves, which decode overwrites before they are ever attended).

    ``cache``, when given, is a preallocated cache that the prompt's keys and
    values are written into in place (positions past the prompt are zeroed,
    as the reference's padding leaves them, over a span fixed by the
    prompt's length, so fixed per bucket); otherwise a new one is made.
    Only the last positions are normed and unembedded.  With a preallocated
    cache and a (B,) ``last_pos`` nothing here syncs with the host, so the
    call can be captured into a CUDA graph."""
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache is None:
        cache = init_cache(cfg, b, cache_len, device=tokens.device)
    elif cache_positions("k", cache["k"].shape[2]) != cache_len:
        raise ValueError(f"cache holds {cache_positions('k', cache['k'].shape[2])} "
                         f"positions, cache_len is {cache_len}")

    def on_kv(i, k, v):
        write_prompt(cache["k"][i], k, "k")
        write_prompt(cache["v"][i], v, "v")

    x = _hidden(params, tokens, cfg, on_kv, input_embeds=input_embeds)
    m = prompt_span("k", cache["k"].shape[2], s)
    cache["k"][:, :, m:] = 0
    cache["v"][:, :, m:] = 0
    if last_pos is None:
        last = x[:, -1]
    elif isinstance(last_pos, torch.Tensor) and last_pos.dim() == 1:
        last = x[torch.arange(b, device=x.device), last_pos]
    else:
        last = x[:, int(last_pos)]
    last = apply_norm(params["final_norm"], last, cfg.norm)
    return unembed(params["embed"], last, cfg), cache


def decode_step(params, cache: dict, token: torch.Tensor, pos, cfg: ModelConfig):
    """token: (B,) int; pos: int or (B,) int tensor.  -> (logits (B,V), cache),
    where cache is the argument, updated in place."""
    x = embed(params["embed"], token[:, None], cfg).to(cfg.cdt)
    for i, lp in enumerate(params["layers"]):
        x = shardctx.constrain_batch(x)
        h = apply_norm(lp["ln1"], x, cfg.norm)
        a, _, _ = attention_decode(lp["attn"], h, pos, cache["k"][i],
                                   cache["v"][i], cfg)
        y = x + a
        h = apply_norm(lp["ln2"], y, cfg.norm)
        x = y + _ffn(lp, h, cfg)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["embed"], x, cfg)[:, 0], cache
