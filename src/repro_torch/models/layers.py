"""Transformer building blocks: GQA attention (full / windowed / decode), MLP.

Plain PyTorch versions of the reference's blocks.  The two attention hot
spots go through ``repro_torch.kernels.dispatch``: on CUDA tensors that
launches the hand-written Hopper kernels, on CPU tensors it takes the plain
versions below.  Activations are (B,S,H,hd); a layer's KV cache is (B,S,K,hd).

Under a mesh with a ``model`` axis (``repro_torch.shardctx``) the same code
runs on a rank's local shards, Megatron-style (``launch/sharding.py`` cuts
them): q/k/v and the MLP's ``wi``/``wu`` column-parallel, ``wo`` and ``wd``
row-parallel, their float32 partial sums all-reduced (``row_dense``), the
embedding sharded over the vocabulary (a masked lookup, then an
all-reduce) and the unembedding over the vocabulary too (the logits
all-gathered).  What a rank holds is the rules' answer alone
(``launch.sharding.model_cut``, ``head_span``, ``seq_cut``):

* heads: the rules cut a projection's columns wherever its width divides
  the model axis, so a rank's columns may end inside a head.  Such
  columns are gathered into whole heads (``shardctx.gather_shards``: its
  backward reduce-scatters, since each rank uses the whole heads for its
  own part of the output); a rank attends with the heads its ``wo`` rows
  touch and keeps its own columns of the output.  A head that straddles
  two ranks is computed on both: at most one extra head a rank at each end
  of its span, and the gather of q, k and v (each rank's columns, to all);
* the KV sequence: a cache whose sequence the rules cut (over "model"
  when the kv heads do not divide it, over "data" for a batch that does
  not divide the data axes) holds a rank's chunk of the positions, all of
  its kv heads.  A prompt's and a new token's keys and values are written
  only where the rank owns the position; a decode step attends with every
  query head that the chunk's kv heads serve (q gathered over "model" when
  "model" cuts the sequence) under a mask of global positions, and the
  chunks' outputs are combined by their row log-sum-exp
  (``shardctx.combine_softmax``); prefill attention is over the whole
  prompt as without a cut.

Under sequence parallelism (``shardctx.seq_cut``: the ambient mesh asks
for it and the prompt's length divides the model axis) the callers hand
these blocks a rank's chunk of the positions and say so (``cut_seq``):
``attention_full`` and ``mlp_apply`` gather the normed input along the
sequence where tensor parallelism has ``copy_to`` (so the attention sees
every position: K1 and the prefill's cache writes are unchanged), and
``row_dense`` reduce-scatters its float32 partial sums along the
sequence where it all-reduces them, its bias added after, on the rank's
tokens; ``embed`` reduce-scatters the vocabulary's partial sums (or, with
the vocabulary whole, cuts its whole lookup to the chunk) and ``unembed``
gathers the rank's normed tokens before its product.

Without a mesh every collective is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import shardctx
from repro_torch.launch.sharding import head_span, model_cut, model_span, seq_cut
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


def row_dense(p: dict, key: str, x: torch.Tensor, full_in: int, *,
              cut_seq: bool = False) -> torch.Tensor:
    """``dense`` of the row-parallel weight ``p[key]`` (``wo``, ``wd``), whose
    input dim of ``full_in`` the rules may cut over the model axis: then the
    partial products in float32 (``float32_products``), all-reduced, cast
    back, then the bias (the reference's GSPMD reduces its float32
    accumulators the same way).  With ``cut_seq`` (x over the whole
    sequence inside a sequence-parallel block) the output is this rank's
    chunk of the sequence: the partial sums reduce-scattered along it, or,
    with the weight whole, the product's chunk."""
    q = p[key]
    if model_cut((key, "w"), (full_in, q["w"].shape[1])) is None:
        y = dense(q, x)
        return shardctx.seq_slice(y) if cut_seq else y
    y = float32_products(x, q["w"])
    y = (shardctx.seq_reduce_scatter(y, x.dtype) if cut_seq
         else shardctx.reduce_from(y).to(x.dtype))
    if "b" in q:
        y = y + q["b"].to(y.dtype)
    return y


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(Sq, Sk) bool mask. window==0 -> plain causal."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def sdpa(q, k, v, mask, *, scale=None, return_lse: bool = False):
    """q:(B,Sq,H,hd) k,v:(B,Sk,K,hd) mask:(Sq,Sk) or (B,Sq,Sk) bool.

    The reference keeps operands in their storage dtype with float32
    accumulation; torch has no float32-accumulating bf16 einsum output, so
    the operands are upcast here.  As in the reference, the probabilities are
    cast to v's dtype before PV.  With ``return_lse`` also each query row's
    natural log-sum-exp of its float32 logits, (B,Sq,H), -inf for a row
    with no valid key (whose output is the mean of V, as the reference's)."""
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
    out = out.reshape(b, sq, h, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(mask.any(-1)[:, None, None], torch.logsumexp(logits, -1), float("-inf"))
    return out, lse.permute(0, 3, 1, 2).reshape(b, sq, h)


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


def project_heads(p: dict, key: str, x: torch.Tensor, n: int, cfg: ModelConfig):
    """The column-parallel projection ``p[key]`` (``wq``, ``wk``, ``wv``) of
    ``n`` heads of x as whole heads (B,S,n',hd): the rank's own heads where
    the rules cut its columns on head boundaries (the first is
    ``first_heads``'), else all n: every head where they leave the weight
    whole, and the ranks' columns gathered where they cut inside a head."""
    hd = cfg.resolved_head_dim
    y = dense(p[key], x)
    span = head_span((key, "w"), (p[key]["w"].shape[0], n * hd), hd)
    if span is not None and not span[2]:
        y = shardctx.gather_shards(y, "model", -1)
    return _heads(y, cfg)


def first_heads(cfg: ModelConfig) -> tuple[int, int]:
    """The index of the first query head and of the first kv head that
    ``project_heads`` gives on this rank (the kv head also the first that
    its KV cache holds): its own first where the rules cut the projection
    on head boundaries, else 0."""
    hd = cfg.resolved_head_dim

    def first(key: str, n: int) -> int:
        span = head_span((key, "w"), (cfg.d_model, n * hd), hd)
        return span[0] if span is not None and span[2] else 0

    return first("wq", cfg.num_heads), first("wk", cfg.num_kv_heads)


def out_heads(cfg: ModelConfig) -> tuple[int, int]:
    """[first, stop) of the query heads whose output columns this rank's
    ``wo`` rows take (all of them where the rules leave ``wo`` whole)."""
    span = head_span(("wo", "w"), (cfg.q_dim, cfg.d_model), cfg.resolved_head_dim)
    return (0, cfg.num_heads) if span is None else span[:2]


def own_columns(out: torch.Tensor, first: int, cfg: ModelConfig) -> torch.Tensor:
    """out (B,S,n,hd), attention outputs of the heads from ``first`` ->
    (B,S,w): the columns of the output that this rank's ``wo`` rows take."""
    flat = out.reshape(*out.shape[:2], -1)
    span = model_span(("wo", "w"), (cfg.q_dim, cfg.d_model))
    if span is None:
        return flat
    start = span[0] - first * cfg.resolved_head_dim
    return flat[..., start:start + span[1] - span[0]]


def select_heads(q, q0: int, k, v, k0: int, lo: int, hi: int, cfg: ModelConfig):
    """Query heads [lo, hi) of q (whose first head is q0) and the kv heads
    they read, of k and v (whose first is k0).  -> (q, k, v), GQA on the
    selection where each selected kv head serves as many of the selected
    query heads, else one kv head per query head (k and v indexed)."""
    g = cfg.num_heads // cfg.num_kv_heads
    kl, kh = lo // g, (hi - 1) // g + 1
    q = q[:, :, lo - q0:hi - q0]
    k, v = k[:, :, kl - k0:kh - k0], v[:, :, kl - k0:kh - k0]
    if kh - kl > 1 and (lo % g or hi % g):
        idx = torch.tensor([h // g - kl for h in range(lo, hi)], device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return q, k, v


def cache_offset(name: str, local_len: int) -> int:
    """The first global position of this rank's chunk of the cache leaf
    ``name`` (``seq_cut``), whose local sequence length is ``local_len``."""
    return shardctx.index(seq_cut(name)) * local_len


def cache_positions(name: str, local_len: int) -> int:
    """The positions of the whole cache leaf ``name`` of which this rank
    holds ``local_len``."""
    return local_len * shardctx.size(seq_cut(name))


def prompt_span(name: str, local_len: int, s: int) -> int:
    """How many of the first positions of this rank's chunk (``local_len``
    of them) of the cache leaf ``name`` a prompt of ``s`` tokens fills; the
    rest the prefill zeroes, as the reference's padding leaves them."""
    return min(max(s - cache_offset(name, local_len), 0), local_len)


def write_prompt(cache: torch.Tensor, t: torch.Tensor, name: str) -> None:
    """t (B,s,K,hd), a prompt's keys or values from position 0, into the
    positions of this rank's chunk (B,S,K,hd) of the cache leaf ``name``
    that the prompt fills (``prompt_span``)."""
    m = prompt_span(name, cache.shape[1], t.shape[1])
    off = cache_offset(name, cache.shape[1])
    cache[:, :m] = t[:, off:off + m].to(cache.dtype)


def chunk_positions(name: str, local_len: int, device) -> torch.Tensor:
    """The global positions (``local_len``,) of this rank's chunk of the
    cache leaf ``name``."""
    off = cache_offset(name, local_len)
    return torch.arange(off, off + local_len, device=device)


def write_token(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, pos: torch.Tensor) -> None:
    """k, v (B,K,hd) into each row's position ``pos`` (B,) of this rank's
    chunks of the key cache and of the value cache (cut alike, ``seq_cut``
    of "k"), on the device; a row whose position another rank owns writes
    nothing."""
    b, n = cache_k.shape[:2]
    rows = torch.arange(b, device=cache_k.device)
    axes = seq_cut("k")
    if not axes:
        cache_k[rows, pos] = k.to(cache_k.dtype)
        cache_v[rows, pos] = v.to(cache_v.dtype)
        return
    local = pos - shardctx.index(axes) * n
    inside = ((local >= 0) & (local < n))[:, None, None]
    idx = local.clamp(0, n - 1)
    for cache, t in ((cache_k, k), (cache_v, v)):
        cache[rows, idx] = torch.where(inside, t.to(cache.dtype), cache[rows, idx])


def attend_full(q, q0: int, k, v, k0: int, cfg: ModelConfig, attend) -> torch.Tensor:
    """Attention over a whole sequence on this rank's heads: ``attend(q, k,
    v)`` on the query heads its ``wo`` rows take and their kv heads.  ->
    (B,S,w), the output columns of its ``wo`` rows."""
    lo, hi = out_heads(cfg)
    qa, ka, va = select_heads(q, q0, k, v, k0, lo, hi, cfg)
    return own_columns(attend(qa.contiguous(), ka.contiguous(), va.contiguous()), lo, cfg)


def attend_decode(q, q0: int, k, v, k0: int, valid, cfg: ModelConfig, *, name: str = "k",
                  kernel: bool = True) -> torch.Tensor:
    """One query per row, q (B,1,n,hd) from head q0, against this rank's
    chunk of the cache leaf ``name`` (k, v (B,S,n_kv,hd) from kv head k0,
    ``valid`` (S,) or (B,S) bool over the chunk): K2 (``kernel``) or
    ``sdpa``; where the rules cut the sequence, with the row log-sum-exp,
    the chunks combined over the cutting axes (``combine_softmax``).  Where
    "model" cuts it, every rank attends with every query head (q gathered)
    and keeps its own.  -> (B,1,w), the output columns of the rank's
    ``wo`` rows."""
    from repro_torch.kernels import dispatch
    axes = seq_cut(name)
    if "model" in axes:
        span = head_span(("wq", "w"), (cfg.d_model, cfg.q_dim), cfg.resolved_head_dim)
        if span is not None and span[2]:
            q = shardctx.all_gather(q, "model", 2)
        q0, (lo, hi) = 0, (0, cfg.num_heads)
    else:
        lo, hi = out_heads(cfg)
    qa, ka, va = select_heads(q, q0, k, v, k0, lo, hi, cfg)
    qa = qa.contiguous()
    if not axes:
        o = (dispatch.flash_decode(qa, ka, va, valid) if kernel
             else sdpa(qa, ka, va, valid[:, None] if valid.dim() == 2 else valid[None]))
    else:
        if k.shape[1] == 0:     # a band that misses this rank's chunk
            o = torch.zeros_like(qa)
            lse = torch.full(qa.shape[::2], float("-inf"), device=qa.device)
        elif kernel:
            o, lse = dispatch.flash_decode(qa, ka, va, valid, return_lse=True)
        else:
            o, lse = sdpa(qa, ka, va, valid[:, None] if valid.dim() == 2 else valid[None],
                          return_lse=True)
            lse = lse[:, 0]
        o = shardctx.combine_softmax(o, lse, axes)
    if "model" in axes:
        lo, hi = out_heads(cfg)
        o = o[:, :, lo:hi]
    return own_columns(o, lo, cfg)


def enter_block(x: torch.Tensor, cut_seq: bool) -> torch.Tensor:
    """A block's normed input as its column-parallel products take it:
    under tensor parallelism as it is (``copy_to``: the gradient
    all-reduced), under sequence parallelism the rank's chunk gathered
    along the sequence (``seq_gather``: the gradient reduce-scattered)."""
    return shardctx.seq_gather(x) if cut_seq else shardctx.copy_to(x)


def attention_full(p: dict, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, *, window: int | None = None,
                   return_kv: bool = False, cut_seq: bool = False):
    """Full-sequence (prefill) attention.  positions: (S,) == arange(S).
    With ``return_kv`` also the keys and values (B,S,K',hd) of the kv heads
    that this rank's cache holds.  With ``cut_seq`` x and the output are
    this rank's chunk of the sequence, the keys and values whole."""
    from repro_torch.kernels import dispatch
    win = cfg.attention_window if window is None else window
    x = enter_block(x, cut_seq)
    s = x.shape[1]
    q = project_heads(p, "wq", x, cfg.num_heads, cfg)
    k = project_heads(p, "wk", x, cfg.num_kv_heads, cfg)
    v = project_heads(p, "wv", x, cfg.num_kv_heads, cfg)
    q0, k0 = first_heads(cfg)
    q = apply_rope(q, positions[None], cfg.rope_theta)
    k = apply_rope(k, positions[None], cfg.rope_theta)

    def attend(qa, ka, va):
        if qa.device.type == "cpu" and s > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
            return attention_chunked(qa, ka, va, positions, positions, win)
        return dispatch.flash_attention(qa, ka, va, window=win)

    y = row_dense(p, "wo", attend_full(q, q0, k, v, k0, cfg, attend), cfg.q_dim,
                  cut_seq=cut_seq)
    if return_kv:
        return y, (k, v)
    return y


def attention_decode(p: dict, x: torch.Tensor, pos, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cfg: ModelConfig, *,
                     window: int | None = None):
    """Single-token decode.  x: (B,1,d); pos: a host int (the current index
    of every row) or a (B,) int tensor of per-row positions on the device
    (the continuous server, and the engine's captured decode step);
    cache_k/v: (B,S,K,hd) with entries < pos valid, or this rank's chunk of
    the positions where the rules cut the sequence (``seq_cut``).

    A device position never leaves the device: the write goes through a
    per-row index and the mask is (B,S), so the step can be captured and
    replayed.  It takes the masked full-cache route; only a host int can
    slice a window's live band out of a longer cache (on a rank, the part
    of the band in its chunk, which may be empty).

    The new k/v are written into cache_k/v IN PLACE (the counterpart of the
    reference's donated cache); returns (y, cache_k, cache_v)."""
    win = cfg.attention_window if window is None else window
    n = cache_k.shape[1]
    dev = x.device
    off = cache_offset("k", n)
    x = shardctx.copy_to(x)
    q = project_heads(p, "wq", x, cfg.num_heads, cfg)         # (B,1,H',hd)
    k = project_heads(p, "wk", x, cfg.num_kv_heads, cfg)      # (B,1,K',hd)
    v = project_heads(p, "wv", x, cfg.num_kv_heads, cfg)
    q0, k0 = first_heads(cfg)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        # per-sequence positions: rope per row, write per row, (B,S) mask.
        # Every row writes, active or not, as in the reference.
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        write_token(cache_k, cache_v, k[:, 0], v[:, 0], pos)
        kv_pos = chunk_positions("k", n, dev)
        valid = kv_pos[None, :] <= pos[:, None]                # (B,S)
        if win:
            valid &= (pos[:, None] - kv_pos[None, :]) < win
        out = attend_decode(q, q0, cache_k, cache_v, k0, valid, cfg)
        return row_dense(p, "wo", out, cfg.q_dim), cache_k, cache_v
    pos = int(pos)
    posv = torch.full((1, 1), pos, dtype=torch.long, device=dev)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    if off <= pos < off + n:
        cache_k[:, pos - off] = k[:, 0].to(cache_k.dtype)
        cache_v[:, pos - off] = v[:, 0].to(cache_v.dtype)
    # Windowed decode against a much longer cache: attend to just the live
    # band, so the sweep is O(window), not O(S).
    total = cache_positions("k", n)
    lo, hi = 0, total
    if win and total > 2 * win:
        lo = min(max(pos + 1 - win, 0), total - win)
        hi = lo + win
    lo = max(lo, off)
    hi = max(min(hi, off + n), lo)
    kv_pos = lo + torch.arange(hi - lo, device=dev)
    valid = kv_pos <= pos
    if win:
        valid &= (pos - kv_pos) < win
    out = attend_decode(q, q0, cache_k[:, lo - off:hi - off], cache_v[:, lo - off:hi - off],
                        k0, valid, cfg)
    return row_dense(p, "wo", out, cfg.q_dim), cache_k, cache_v


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


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              cut_seq: bool = False) -> torch.Tensor:
    act = activation(cfg.act)
    x = enter_block(x, cut_seq)
    return row_dense(p, "wd", act(dense(p["wi"], x)) * dense(p["wu"], x), cfg.d_ff,
                     cut_seq=cut_seq)


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


def embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
          cut_seq: bool = False) -> torch.Tensor:
    """-> (B,S,d) in the compute dtype; with ``cut_seq`` this rank's chunk
    of the sequence (B,S/M,d)."""
    # gather, then cast: the same values as the reference's cast-then-gather
    # without a compute-dtype copy of the whole table
    w = p["embedding"]
    if model_cut(("embedding",), (cfg.vocab_size, cfg.d_model)) is None:
        x = F.embedding(tokens, w).to(cfg.cdt)
        return shardctx.seq_scatter(x) if cut_seq else x
    # this rank's rows of the vocabulary: a masked lookup, summed over the
    # model axis (exact: one rank holds each token's row), or reduce-scattered
    # along the sequence under sequence parallelism
    local = tokens - shardctx.index("model") * w.shape[0]
    hit = (local >= 0) & (local < w.shape[0])
    x = F.embedding(local.clamp(0, w.shape[0] - 1), w).float() * hit[..., None]
    return (shardctx.seq_reduce_scatter(x, cfg.cdt) if cut_seq
            else shardctx.reduce_from(x).to(cfg.cdt))


def unembed(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
            cut_seq: bool = False) -> torch.Tensor:
    """-> logits (..., V).  With the vocabulary cut over the model axis, a
    rank's logits columns are all-gathered (in float32, exact) into the
    whole row on every rank.  With ``cut_seq`` x (B,S/M,d) is this rank's
    chunk of the sequence and the logits (B,S,V) are whole: the chunks are
    gathered before the product (before a vocabulary-parallel one with the
    gradient reduce-scattered back; before one with the whole vocabulary,
    which every model rank then computes alike, with the rank's chunk of
    the gradient kept, as ``embed`` keeps such a table whole)."""
    w = p["embedding"] if cfg.tie_embeddings else p["unembed"]["w"]
    keys, shape = ((("embedding",), (cfg.vocab_size, cfg.d_model)) if cfg.tie_embeddings
                   else (("unembed", "w"), (cfg.d_model, cfg.vocab_size)))
    if model_cut(keys, shape) is None:
        if cut_seq:
            x = shardctx.gather_from(x, "model", 1)
        return x @ w.to(x.dtype).T if cfg.tie_embeddings else dense(p["unembed"], x)
    x = enter_block(x, cut_seq)
    local = x @ w.to(x.dtype).T if cfg.tie_embeddings else dense(p["unembed"], x)
    return shardctx.gather_from(local.float(), "model", -1).to(local.dtype)
