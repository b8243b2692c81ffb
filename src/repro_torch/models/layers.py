"""Transformer building blocks: GQA attention (full / windowed / decode), MLP.

Plain PyTorch versions of the reference's blocks.  The two attention hot
spots go through ``repro_torch.kernels.dispatch``: on CUDA tensors that
launches the hand-written Hopper kernels, on CPU tensors it takes the plain
versions below.  Activations are (B,S,H,hd); a layer's KV cache is (B,S,K,hd).

Under a mesh with a ``model`` axis (``repro_torch.shardctx``) the same code
runs on a rank's local shards, Megatron-style (``launch/sharding.py`` cuts
them): q/k/v and the MLP's ``wi``/``wu`` column-parallel on whole heads and
ffn columns (K1 and K2 run on the local heads), ``wo`` and ``wd``
row-parallel, their float32 partial sums all-reduced (``row_dense``), the
embedding sharded over the vocabulary (a masked lookup, then an
all-reduce) and the unembedding over the vocabulary too (the logits
all-gathered).  Whether a weight is cut is the rules' answer
(``launch.sharding.model_cut``), and heads are counted from the weights'
local widths.  Without a mesh every collective is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import shardctx
from repro_torch.launch.sharding import model_cut
from .common import (ModelConfig, activation, apply_rope, dense, dense_init,
                     float32_products)

NEG_INF = -1e30
# torch's CPU softmax sums a row in an order that depends on the row's
# length; padding the key axis with -inf up to a multiple of this makes a
# row's probabilities independent of how many pad keys follow it, so a
# bucketed (right-padded) prompt gives bit-identical rows to the exact one.
SOFTMAX_PAD = 64


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------

def attn_init(generator, cfg: ModelConfig, device) -> dict:
    d, pdt = cfg.d_model, cfg.pdt
    return {
        "wq": dense_init(generator, d, cfg.q_dim, pdt, device, bias=cfg.qkv_bias),
        "wk": dense_init(generator, d, cfg.kv_dim, pdt, device, bias=cfg.qkv_bias),
        "wv": dense_init(generator, d, cfg.kv_dim, pdt, device, bias=cfg.qkv_bias),
        "wo": dense_init(generator, cfg.q_dim, d, pdt, device),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _heads(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B,S,n*hd) -> (B,S,n,hd): as many heads as the (local) width holds."""
    b, s, _ = x.shape
    return x.reshape(b, s, -1, cfg.resolved_head_dim)


def row_dense(p: dict, key: str, x: torch.Tensor, full_in: int) -> torch.Tensor:
    """``dense`` of the row-parallel weight ``p[key]`` (``wo``, ``wd``), whose
    input dim of ``full_in`` the rules may cut over the model axis: then the
    partial products in float32 (``float32_products``), all-reduced, cast
    back, then the bias (the reference's GSPMD reduces its float32
    accumulators the same way)."""
    q = p[key]
    if model_cut((key, "w"), (full_in, q["w"].shape[1])) is None:
        return dense(q, x)
    y = shardctx.reduce_from(float32_products(x, q["w"])).to(x.dtype)
    if "b" in q:
        y = y + q["b"].to(y.dtype)
    return y


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(Sq, Sk) bool mask. window==0 -> plain causal."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def sdpa(q, k, v, mask, *, scale=None):
    """q:(B,Sq,H,hd) k,v:(B,Sk,K,hd) mask:(Sq,Sk) or (B,Sq,Sk) bool.

    The reference keeps operands in their storage dtype with float32
    accumulation; torch has no float32-accumulating bf16 einsum output, so
    the operands are upcast here.  As in the reference, the probabilities are
    cast to v's dtype before PV."""
    b, sq, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    scale = scale if scale is not None else hd ** -0.5
    qf = q.reshape(b, sq, kheads, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qf.float(), k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    sk = logits.shape[-1]
    pad = (-sk) % SOFTMAX_PAD
    probs = torch.softmax(F.pad(logits, (0, pad), value=float("-inf")), dim=-1)[..., :sk]
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


CHUNK_THRESHOLD = 2048   # above this, use the memory-bounded chunked path
Q_CHUNK = 1024


def attention_chunked(q, k, v, q_pos, k_pos, window: int, chunk: int = Q_CHUNK):
    """Memory-bounded attention: loop over query chunks so the logits buffer
    is O(chunk * Sk) — and O(chunk * (chunk + window)) in the windowed case,
    where only the relevant KV band is sliced in.  Same math as ``sdpa``."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    nc = sq // chunk
    band = min(window + chunk, sk) if window else sk
    outs = []
    for ci in range(nc):
        qi = q[:, ci * chunk:(ci + 1) * chunk]
        qp = q_pos[ci * chunk:(ci + 1) * chunk]
        if window and band < sk:
            start = min(max(ci * chunk + chunk - band, 0), sk - band)
            ks, vs = k[:, start:start + band], v[:, start:start + band]
            kp = start + torch.arange(band, dtype=k_pos.dtype, device=k_pos.device)
        else:
            ks, vs, kp = k, v, k_pos
        outs.append(sdpa(qi, ks, vs, causal_window_mask(qp, kp, window)))
    return torch.cat(outs, dim=1)


def attention_full(p: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, *, window: int | None = None,
                   return_kv: bool = False):
    """Full-sequence (prefill) attention.  positions: (S,) == arange(S)."""
    from repro_torch.kernels import dispatch
    win = cfg.attention_window if window is None else window
    s = x.shape[1]
    x = shardctx.copy_to(x)
    q = _heads(dense(p["wq"], x), cfg)
    k = _heads(dense(p["wk"], x), cfg)
    v = _heads(dense(p["wv"], x), cfg)
    q = apply_rope(q, positions[None], cfg.rope_theta)
    k = apply_rope(k, positions[None], cfg.rope_theta)
    if not q.is_cuda and s > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
        out = attention_chunked(q, k, v, positions, positions, win)
    else:
        out = dispatch.flash_attention(q, k, v, window=win)
    y = row_dense(p, "wo", out.reshape(*x.shape[:2], -1), cfg.q_dim)
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(p: dict, x: torch.Tensor, pos, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cfg: ModelConfig, *,
                     window: int | None = None):
    """Single-token decode.  x: (B,1,d); pos: a host int (the current index
    of every row) or a (B,) int tensor of per-row positions on the device
    (the continuous server, and the engine's captured decode step);
    cache_k/v: (B,S,K,hd) with entries < pos valid.

    A device position never leaves the device: the write goes through a
    per-row index and the mask is (B,S), so the step can be captured and
    replayed.  It takes the masked full-cache route; only a host int can
    slice a window's live band out of a longer cache.

    The new k/v are written into cache_k/v IN PLACE (the counterpart of the
    reference's donated cache); returns (y, cache_k, cache_v)."""
    from repro_torch.kernels import dispatch
    win = cfg.attention_window if window is None else window
    b = x.shape[0]
    s = cache_k.shape[1]
    dev = x.device
    x = shardctx.copy_to(x)
    q = _heads(dense(p["wq"], x), cfg)        # (B,1,H,hd)
    k = _heads(dense(p["wk"], x), cfg)        # (B,1,K,hd)
    v = _heads(dense(p["wv"], x), cfg)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        # per-sequence positions: rope per row, write per row, (B,S) mask.
        # Every row writes, active or not, as in the reference.
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        rows = torch.arange(b, device=dev)
        cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
        kv_pos = torch.arange(s, device=dev)
        valid = kv_pos[None, :] <= pos[:, None]                # (B,S)
        if win:
            valid &= (pos[:, None] - kv_pos[None, :]) < win
        out = dispatch.flash_decode(q, cache_k, cache_v, valid)
        y = row_dense(p, "wo", out.reshape(b, 1, -1), cfg.q_dim)
        return y, cache_k, cache_v
    pos = int(pos)
    posv = torch.full((1, 1), pos, dtype=torch.long, device=dev)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    # Windowed decode against a much longer cache: attend to just the live
    # band, so the sweep is O(window), not O(S).
    att_k, att_v, base = cache_k, cache_v, 0
    if win and s > 2 * win:
        base = min(max(pos + 1 - win, 0), s - win)
        att_k, att_v = cache_k[:, base:base + win], cache_v[:, base:base + win]
    kv_pos = base + torch.arange(att_k.shape[1], device=dev)
    valid = kv_pos <= pos
    if win:
        valid &= (pos - kv_pos) < win
    out = dispatch.flash_decode(q, att_k, att_v, valid)
    y = row_dense(p, "wo", out.reshape(b, 1, -1), cfg.q_dim)
    return y, cache_k, cache_v


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------

def mlp_init(generator, cfg: ModelConfig, device, d_ff: int | None = None) -> dict:
    d, f, pdt = cfg.d_model, d_ff or cfg.d_ff, cfg.pdt
    return {
        "wi": dense_init(generator, d, f, pdt, device),      # gate
        "wu": dense_init(generator, d, f, pdt, device),      # up
        "wd": dense_init(generator, f, d, pdt, device),      # down
    }


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    x = shardctx.copy_to(x)
    return row_dense(p, "wd", act(dense(p["wi"], x)) * dense(p["wu"], x), cfg.d_ff)


# ----------------------------------------------------------------------
# Embedding / unembedding
# ----------------------------------------------------------------------

def embed_init(generator, cfg: ModelConfig, device) -> dict:
    e = torch.randn((cfg.vocab_size, cfg.d_model), generator=generator,
                    device=device, dtype=torch.float32)
    p = {"embedding": (e * cfg.d_model ** -0.5).to(cfg.pdt)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                  cfg.pdt, device)
    return p


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-gather
    # without a compute-dtype copy of the whole table
    w = p["embedding"]
    if model_cut(("embedding",), (cfg.vocab_size, cfg.d_model)) is None:
        return F.embedding(tokens, w).to(cfg.cdt)
    # this rank's rows of the vocabulary: a masked lookup, summed over the
    # model axis (exact: one rank holds each token's row)
    local = tokens - shardctx.index("model") * w.shape[0]
    hit = (local >= 0) & (local < w.shape[0])
    x = F.embedding(local.clamp(0, w.shape[0] - 1), w).float() * hit[..., None]
    return shardctx.reduce_from(x).to(cfg.cdt)


def unembed(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """-> logits (..., V).  With the vocabulary cut over the model axis, a
    rank's logits columns are all-gathered (in float32, exact) into the
    whole row on every rank."""
    w = p["embedding"] if cfg.tie_embeddings else p["unembed"]["w"]
    keys, shape = ((("embedding",), (cfg.vocab_size, cfg.d_model)) if cfg.tie_embeddings
                   else (("unembed", "w"), (cfg.d_model, cfg.vocab_size)))
    if model_cut(keys, shape) is None:
        if cfg.tie_embeddings:
            return x @ w.to(x.dtype).T
        return dense(p["unembed"], x)
    x = shardctx.copy_to(x)
    local = x @ w.to(x.dtype).T if cfg.tie_embeddings else dense(p["unembed"], x)
    return shardctx.gather_from(local.float(), "model", -1).to(local.dtype)
