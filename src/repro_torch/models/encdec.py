"""Whisper-style encoder-decoder transformer backbone (arXiv:2212.04356).

As in the reference, the audio frontend (log-mel spectrogram and conv
feature extractor) is a stub: the inputs carry precomputed frame embeddings
``(B, encoder_seq, d)``.  This module is the transformer: a bidirectional
encoder over the frames and a causal decoder with cross-attention, with
LayerNorm, GELU, learned decoder positions (``MAX_DEC_POS`` of them, the
reference's 32768) and no RoPE.

The reference stacks the layers and scans them; here each stack is a list
of per-layer param dicts walked by a Python loop.  The cache keeps the
reference's layout, ``k``/``v`` (L,B,S,K,hd) and the cross-attention's
``xk``/``xv`` (L,B,encoder_seq,K,hd), and is written in place: the prefill
fills all four, a decode step writes ``k``/``v`` at its position and reads
``xk``/``xv`` unchanged.  No Pallas kernel is on this path in the
reference: the attention is ``sdpa`` or ``attention_chunked``, and so it
is here, on every device.

Under a mesh with a ``model`` axis each rank holds what the rules cut
(``launch/sharding.py``): the attention follows ``layers.py`` (heads cut
inside where the head count does not divide the axis; a self-attention
cache and the cross-attention's ``xk``/``xv`` whose sequence the rules cut
over "model" or "data" hold a rank's chunk of the positions, combined by
their row log-sum-exp through the plain ``sdpa``); the MLP is ``wi``
column-parallel, ``wo`` row-parallel, whose bias is added once, after the
all-reduce; the vocabulary is cut only where it divides the axis
(``layers.embed``/``unembed`` ask the rules).

Under sequence parallelism each stack cuts its own residual stream where
its length divides the model axis (``shardctx.seq_cut``: the frames' for
the encoder, the prompt's for the decoder; 1500 frames divide a model
axis of 2 or 4, not 8 or 16, and there the encoder runs uncut while the
decoder may be cut).  The encoder's frames are cut to the rank's chunk
(``shardctx.seq_scatter``), and its output is gathered whole before the
decoder's cross-attention takes it; each block gathers its normed input
along the sequence and reduce-scatters its ``wo`` partial sums back
(``layers.py``); the decoder's learned positions are the chunk's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, shardctx
from .common import ModelConfig, apply_norm, dense, dense_init, norm_init, row_positions
from .layers import (CHUNK_THRESHOLD, Q_CHUNK, attend_decode, attend_full, attention_chunked,
                     attn_init, cache_positions, chunk_positions, embed, embed_init,
                     enter_block, first_heads, project_heads, prompt_span, row_dense, sdpa,
                     unembed, write_prompt, write_token)
from .transformer import softmax_xent

MAX_DEC_POS = 32768


def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
    """(seq, d) float32: sin then cos of pos * 10000^(-j / (d/2 - 1)), each
    step in float32 as the reference takes it."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    rate = torch.log(torch.full((), 10000.0, device=device)) / (d // 2 - 1)
    ang = pos * torch.exp(-dim * rate)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _kv(p, xkv, cfg: ModelConfig):
    """-> (k, v): whole heads (``layers.project_heads``)."""
    return (project_heads(p, "wk", xkv, cfg.num_kv_heads, cfg),
            project_heads(p, "wv", xkv, cfg.num_kv_heads, cfg))


def _attn(p, xq, kv, attend, cfg: ModelConfig, cut_seq: bool = False):
    """Attention of xq (B,S,d) over ``kv`` (``_kv``) by ``attend(q, k, v)``
    on this rank's heads, then ``wo`` (to this rank's chunk of the
    sequence with ``cut_seq``)."""
    q0, k0 = first_heads(cfg)
    q = project_heads(p, "wq", xq, cfg.num_heads, cfg)
    return row_dense(p, "wo", attend_full(q, q0, kv[0], kv[1], k0, cfg, attend), cfg.q_dim,
                     cut_seq=cut_seq)


def _mlp_init(generator, cfg: ModelConfig, device) -> dict:
    return {"wi": dense_init(generator, cfg.d_model, cfg.d_ff, cfg.pdt, device, bias=True),
            "wo": dense_init(generator, cfg.d_ff, cfg.d_model, cfg.pdt, device, bias=True)}


def _mlp(p, x, cfg: ModelConfig, cut_seq: bool = False):
    x = enter_block(x, cut_seq)
    return row_dense(p, "wo", F.gelu(dense(p["wi"], x), approximate="tanh"), cfg.d_ff,
                     cut_seq=cut_seq)


def _ln(cfg: ModelConfig, device) -> dict:
    return norm_init(cfg.d_model, "layernorm", cfg.pdt, device)


def enc_layer_init(generator, cfg: ModelConfig, device) -> dict:
    return {"ln1": _ln(cfg, device), "ln2": _ln(cfg, device),
            "attn": attn_init(generator, cfg, device),
            "mlp": _mlp_init(generator, cfg, device)}


def dec_layer_init(generator, cfg: ModelConfig, device) -> dict:
    return {"ln1": _ln(cfg, device), "ln2": _ln(cfg, device), "ln3": _ln(cfg, device),
            "attn": attn_init(generator, cfg, device),
            "xattn": attn_init(generator, cfg, device),
            "mlp": _mlp_init(generator, cfg, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's distributions, from ``generator``
    (torch's draws, not JAX's)."""
    dec_pos = torch.randn((MAX_DEC_POS, cfg.d_model), generator=generator, device=device,
                          dtype=torch.float32) * 0.01
    return {
        "embed": embed_init(generator, cfg, device),
        "dec_pos": dec_pos.to(cfg.pdt),
        "enc_layers": [enc_layer_init(generator, cfg, device)
                       for _ in range(cfg.encoder_layers)],
        "dec_layers": [dec_layer_init(generator, cfg, device)
                       for _ in range(cfg.num_layers)],
        "enc_ln_post": _ln(cfg, device),
        "final_norm": _ln(cfg, device),
    }


# ----------------------------------------------------------------------
# encoder
# ----------------------------------------------------------------------

def encode(params, frame_embeds, cfg: ModelConfig) -> torch.Tensor:
    """frame_embeds: (B, Se, d), the stubbed frontend's output.  -> (B, Se,
    d), whole, as the decoder's cross-attention keys and values take it
    (``copy_to``, or gathered along the sequence where sequence
    parallelism cut the encoder)."""
    se = frame_embeds.shape[1]
    cut = shardctx.seq_cut(frame_embeds, 1)
    x = frame_embeds.to(cfg.cdt) + _sinusoid(se, cfg.d_model, frame_embeds.device).to(cfg.cdt)
    if cut:
        x = shardctx.seq_scatter(x)
    full = torch.ones((se, se), dtype=torch.bool, device=x.device)
    for lp in params["enc_layers"]:
        x = shardctx.constrain_batch(x, seq_dim=1)
        h = enter_block(apply_norm(lp["ln1"], x, "layernorm"), cut)
        x = x + _attn(lp["attn"], h, _kv(lp["attn"], h, cfg),
                      lambda q, k, v: sdpa(q, k, v, full), cfg, cut)
        h = apply_norm(lp["ln2"], x, "layernorm")
        x = x + _mlp(lp["mlp"], h, cfg, cut)
    return enter_block(apply_norm(params["enc_ln_post"], x, "layernorm"), cut)


# ----------------------------------------------------------------------
# decoder
# ----------------------------------------------------------------------

def _dec_embed(params, tokens, pos, cfg: ModelConfig, cut_seq: bool = False) -> torch.Tensor:
    """Token embeddings plus learned positions: positions 0..S-1 over a
    prompt (``pos`` None), or each row's position (a (B,) tensor, gathered
    on the device) for one token; this rank's chunk of the prompt's with
    ``cut_seq``."""
    x = embed(params["embed"], tokens, cfg, cut_seq=cut_seq).to(cfg.cdt)
    table = params["dec_pos"]
    if pos is None:
        rows = table[:tokens.shape[1]][None]
        rows = shardctx.seq_slice(rows) if cut_seq else rows
    else:
        rows = table[pos][:, None]
    return x + rows.to(cfg.cdt)


def decode_full(params, tokens, enc_out, cfg: ModelConfig, on_kv=None) -> torch.Tensor:
    """The decoder over the whole prompt, ``enc_out`` the encoder's whole
    output (``encode``); calls ``on_kv(layer, k, v, xk, xv)`` with each
    layer's self- and cross-attention keys and values.  -> the final
    hidden states before the norm (B,S,d): this rank's chunk of the
    sequence where sequence parallelism cuts it (``shardctx.seq_cut`` of
    the tokens)."""
    b, s = tokens.shape
    cut = shardctx.seq_cut(tokens, 1)
    x = _dec_embed(params, tokens, None, cfg, cut)
    pos = torch.arange(s, device=x.device)
    causal = pos[None, :] <= pos[:, None]
    xfull = torch.ones((s, enc_out.shape[1]), dtype=torch.bool, device=x.device)

    def self_attend(q, k, v):
        if s > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
            # memory-bounded: the full (S,S) logits would dominate the memory
            return attention_chunked(q, k, v, pos, pos, 0)
        return sdpa(q, k, v, causal)

    for i, lp in enumerate(params["dec_layers"]):
        x = shardctx.constrain_batch(x, seq_dim=1)
        h = enter_block(apply_norm(lp["ln1"], x, "layernorm"), cut)
        kv = _kv(lp["attn"], h, cfg)
        x = x + _attn(lp["attn"], h, kv, self_attend, cfg, cut)
        h = enter_block(apply_norm(lp["ln2"], x, "layernorm"), cut)
        xkv = _kv(lp["xattn"], enc_out, cfg)
        x = x + _attn(lp["xattn"], h, xkv, lambda q, k, v: sdpa(q, k, v, xfull), cfg, cut)
        h = apply_norm(lp["ln3"], x, "layernorm")
        x = x + _mlp(lp["mlp"], h, cfg, cut)
        if on_kv is not None:
            on_kv(i, *kv, *xkv)
    return x


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------

def _frames(inputs: dict, cfg: ModelConfig) -> torch.Tensor:
    if "frame_embeds" not in inputs:
        raise KeyError(f"{cfg.name}: the audio family's inputs need 'frame_embeds' "
                       f"(B, {cfg.encoder_seq}, {cfg.d_model}) beside 'tokens'; got "
                       f"{sorted(inputs)}")
    return inputs["frame_embeds"]


def forward(params, inputs: dict, cfg: ModelConfig):
    """inputs: ``frame_embeds`` (B,Se,d) and ``tokens`` (B,S).  -> (logits
    (B,S,V), aux 0)."""
    enc_out = encode(params, _frames(inputs, cfg), cfg)
    x = decode_full(params, inputs["tokens"], enc_out, cfg)
    x = apply_norm(params["final_norm"], x, "layernorm")
    return (unembed(params["embed"], x, cfg, cut_seq=shardctx.seq_cut(inputs["tokens"], 1)),
            torch.zeros((), device=x.device))


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """The decoder's cross-entropy against ``batch["labels"]``; ``batch``
    holds ``frame_embeds`` and ``tokens``.  ``remat`` is taken and unused,
    as in the reference, whose encoder-decoder forward has no remat.  ->
    (loss, {"xent", "aux": 0})."""
    logits, aux = forward(params, batch, cfg)
    loss = softmax_xent(logits, batch["labels"])
    return loss, {"xent": loss, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=None, device="cuda") -> dict:
    device = resolve_device(device)
    dt = dtype or cfg.cdt
    hd, l, kh = cfg.resolved_head_dim, cfg.num_layers, cfg.num_kv_heads
    return {name: torch.zeros((l, batch, n, kh, hd), dtype=dt, device=device)
            for name, n in (("k", seq), ("v", seq), ("xk", cfg.encoder_seq),
                            ("xv", cfg.encoder_seq))}


def prefill(params, inputs: dict, cfg: ModelConfig, cache_len: int | None = None, *,
            last_pos=None, cache: dict | None = None):
    """The encoder over the frames, then the decoder over the prompt.  ->
    (last logits (B,V), cache).  ``cache``, when given, is written in place
    (the self-attention positions past the prompt zeroed), else a new one of
    ``cache_len`` positions is made.  Only the last position is normed and
    unembedded.  ``last_pos`` must be None: the reference's audio prefill
    reads the last position only, so callers keep exact-length prompts."""
    if last_pos is not None:
        raise ValueError(f"{cfg.name}: the audio prefill takes exact-length prompts "
                         "(last_pos=None)")
    tokens = inputs["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache is None:
        cache = init_cache(cfg, b, cache_len, device=tokens.device)
    elif cache_positions("k", cache["k"].shape[2]) != cache_len:
        raise ValueError(f"cache holds {cache_positions('k', cache['k'].shape[2])} "
                         f"positions, cache_len is {cache_len}")
    enc_out = encode(params, _frames(inputs, cfg), cfg)

    def on_kv(i, k, v, xk, xv):
        for name, t in (("k", k), ("v", v), ("xk", xk), ("xv", xv)):
            write_prompt(cache[name][i], t, name)

    x = decode_full(params, tokens, enc_out, cfg, on_kv)
    if shardctx.seq_cut(tokens, 1):     # the last position is the last model rank's
        x = shardctx.seq_gather(x)
    m = prompt_span("k", cache["k"].shape[2], s)
    cache["k"][:, :, m:] = 0
    cache["v"][:, :, m:] = 0
    last = apply_norm(params["final_norm"], x[:, -1], "layernorm")
    return unembed(params["embed"], last, cfg), cache


def decode_step(params, cache: dict, token, pos, cfg: ModelConfig):
    """token: (B,) int; pos: an int, or a (B,) int tensor of each row's
    position on the device (written per row, masked per row, its decoder
    position gathered).  -> (logits (B,V), cache), updated in place."""
    b, dev = token.shape[0], token.device
    pos = row_positions(pos, b, dev)
    x = _dec_embed(params, token[:, None], pos, cfg)
    n = cache["k"].shape[2]
    kv_pos = chunk_positions("k", n, dev)
    valid = kv_pos[None, :] <= pos[:, None]
    xvalid = torch.ones((cache["xk"].shape[2],), dtype=torch.bool, device=dev)
    q0, k0 = first_heads(cfg)
    for i, lp in enumerate(params["dec_layers"]):
        ck, cv = cache["k"][i], cache["v"][i]
        x = shardctx.constrain_batch(x)
        h = shardctx.copy_to(apply_norm(lp["ln1"], x, "layernorm"))
        q = project_heads(lp["attn"], "wq", h, cfg.num_heads, cfg)
        k, v = _kv(lp["attn"], h, cfg)
        write_token(ck, cv, k[:, 0], v[:, 0], pos)
        a = attend_decode(q, q0, ck, cv, k0, valid, cfg, kernel=False)
        x = x + row_dense(lp["attn"], "wo", a, cfg.q_dim)
        h = shardctx.copy_to(apply_norm(lp["ln2"], x, "layernorm"))
        xq = project_heads(lp["xattn"], "wq", h, cfg.num_heads, cfg)
        xa = attend_decode(xq, q0, cache["xk"][i], cache["xv"][i], k0, xvalid, cfg, name="xk",
                           kernel=False)
        x = x + row_dense(lp["xattn"], "wo", xa, cfg.q_dim)
        h = apply_norm(lp["ln3"], x, "layernorm")
        x = x + _mlp(lp["mlp"], h, cfg)
    x = apply_norm(params["final_norm"], x, "layernorm")
    return unembed(params["embed"], x, cfg)[:, 0], cache
