"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local
attention in a repeating pattern (arXiv:2402.19427).

Temporal mixing follows the config's ``pattern`` (``("rglru", "rglru",
"attn")``).  As in the reference, the layers are grouped into pattern units
and a remainder stack covers ``num_layers % len(pattern)`` (the 9B config's
38 = 12 x 3 + 2 layers).  The parameters keep the reference's layout, with
its stacked ``units`` unstacked into a list: ``units[u]["b0".."b2"]`` and
``extra[j]``.  The state keeps the reference's layout as it is: each
``units["b<i>"]`` leaf stacked on a leading ``n_units`` axis, ``extra`` a
list of per-layer dicts (the batch on axis 0).  A state handed to
``prefill``, ``forward`` or ``decode_step`` is updated in place.

* RG-LRU: ``r, i = sigmoid(W_a x), sigmoid(W_x x)``;
  ``a = exp(-c * softplus(L) * r)``;
  ``h_t = a h_{t-1} + sqrt(1 - a^2) * (i * x)``, in float32, over a prompt by
  the reference's log-depth associative scan (``_scan``), one step at a time
  in decode.
* Local attention: MQA with a sliding window; the decode state is a ring
  buffer of the window's size, slot ``p % window`` holding position ``p``.

No Pallas kernel is on this path in the reference: the attention is
``sdpa`` or ``attention_chunked``, and so it is here, on every device.

Under a mesh with a ``model`` axis each rank holds what the rules cut
(``launch/sharding.py``): ``w_in``'s columns over the concatenation
``[xb | gate]`` (at a model axis of 2, rank 0 holds all of ``xb`` and rank
1 all of ``gate``), so they are gathered and each rank keeps its channels
of both; ``conv_w``, ``conv_b``, ``lam`` and the ``conv`` and ``lru``
states by channel; ``wa`` and ``wx`` whole, applied to the gathered input
on every rank, each rank keeping its channels of the gates; ``w_out``
row-parallel, all-reduced.  The local attention's heads and its ring
buffer follow ``layers.py``: the ring is whole over "model" (its window
exempts it from the kv-heads rule), and cut by slot over "data" for a batch
that does not divide the data axes.
``train_loss`` runs functional copies of the blocks (``_train_block``),
from the zero state and writing none, so that autograd sees no in-place
write.

Under sequence parallelism (``shardctx.seq_cut`` of the tokens) the
residual stream is the rank's chunk of the positions: the recurrent
block's causal conv and RG-LRU scan, and the local attention, need the
whole sequence, so each block gathers its normed input along it (the
states a prefill writes are then the whole sequence's), and ``w_out``,
the attention's ``wo`` and the MLP's ``wd`` reduce-scatter their partial
sums back to the chunk.  Inside a block every ``copy_to``,
``gather_from`` and ``scatter_to`` takes ``partial`` (``shardctx``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, shardctx
from repro_torch.launch.sharding import model_cut
from .common import (ModelConfig, apply_norm, apply_rope, dense, dense_init,
                     norm_init, remat as checkpointed, row_positions, tensor_leaves)
from .layers import (CHUNK_THRESHOLD, Q_CHUNK, attend_decode, attend_full, attention_chunked,
                     attn_init, cache_offset, causal_window_mask, chunk_positions, embed,
                     embed_init, enter_block, first_heads, mlp_apply, mlp_init,
                     project_heads, row_dense, sdpa, unembed, write_token)
from .transformer import softmax_xent

LRU_C = 8.0


# ----------------------------------------------------------------------
# RG-LRU recurrent block
# ----------------------------------------------------------------------

def rec_block_init(generator, cfg: ModelConfig, device) -> dict:
    d, pdt = cfg.d_model, cfg.pdt
    dr = d  # lru_width == d_model for RecurrentGemma
    conv_w = torch.randn((cfg.rglru_conv_width, dr), generator=generator, device=device,
                         dtype=torch.float32) * 0.1
    return {
        "w_in": dense_init(generator, d, 2 * dr, pdt, device),
        "conv_w": conv_w.to(pdt),
        "conv_b": torch.zeros((dr,), dtype=pdt, device=device),
        "wa": dense_init(generator, dr, dr, pdt, device, bias=True),
        "wx": dense_init(generator, dr, dr, pdt, device, bias=True),
        "lam": torch.full((dr,), 2.0, dtype=torch.float32, device=device),
        "w_out": dense_init(generator, dr, d, pdt, device),
    }


def _causal_conv(w, b, x, state):
    """Depthwise causal conv of width W.  x: (B,T,dr), state: (B,W-1,dr).
    -> (y, the new state: the last W-1 inputs)."""
    width, t = w.shape[0], x.shape[1]
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = 0
    for i in range(width):
        y = y + xp[:, i:i + t] * w[i].to(x.dtype)
    return y + b.to(x.dtype), xp[:, -(width - 1):]


def _combine(a1, b1, a2, b2):
    """The recurrence's operator, ``(a1, b1)`` the earlier element."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """Elements of ``even`` at 0, 2, ... and of ``odd`` at 1, 3, ... of
    axis 1; ``even`` holds as many as ``odd`` or one more."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _scan(a, b):
    """Inclusive scan of ``_combine`` over axis 1 in log depth: the
    algorithm of ``jax.lax.associative_scan`` (pairs combined, the half
    scanned recursively, the rest filled in), so its sums run in the same
    order.  a, b: (B,T,dr)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = _scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]))
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _width(p) -> int:
    """The recurrence's whole width dr (``w_in``'s input dim: lru_width ==
    d_model for RecurrentGemma, and the rules never cut it)."""
    return p["w_in"]["w"].shape[0]


def _channels_cut(p) -> bool:
    """Whether the rules cut the recurrence's channels over the model axis."""
    return model_cut(("conv_w",), (p["conv_w"].shape[0], _width(p))) is not None


def _gates(p, xf, cut_seq: bool = False):
    """-> (a, the gated input sqrt(1 - a^2) * (i * x)), float32.  Under a
    cut of the channels, ``wa`` and ``wx`` (whole on every rank) take the
    whole input, gathered, and each rank keeps its channels of the gates."""
    cut = _channels_cut(p)
    xin = shardctx.gather_from(xf, "model", -1, partial=cut_seq) if cut else xf
    r = torch.sigmoid(dense(p["wa"], xin, dtype=torch.float32))
    i = torch.sigmoid(dense(p["wx"], xin, dtype=torch.float32))
    if cut:
        r, i = (shardctx.scatter_to(z, "model", -1, partial=cut_seq) for z in (r, i))
    a = torch.exp(-LRU_C * F.softplus(p["lam"].float()) * r)
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)


def _rglru(p, x, h0, cut_seq: bool = False):
    """x: (B,T,dr), h0: (B,dr) float32 -> (y (B,T,dr) in x's dtype, h_T)."""
    a, gated = _gates(p, x.float(), cut_seq)
    # the initial state is absorbed into the first step's b
    b = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None], gated[:, 1:]], dim=1)
    _, h = _scan(a, b)
    return h.to(x.dtype), h[:, -1]


def _rglru_step(p, x, h):
    """x: (B,1,dr), h: (B,dr) float32 -> (y (B,1,dr), the new h)."""
    xf = x[:, 0].float()
    a, gated = _gates(p, xf)
    h = a * h + gated
    return h.to(x.dtype)[:, None], h


def _split_in(p, x, cut_seq: bool = False):
    """(xb, gate): the input projection's two halves, each rank's channels
    of both where the rules cut them.  ``w_in``'s columns are cut over the
    concatenation, so they are gathered first (the gradient reduce-scattered
    back, as each rank uses its own channels of the whole)."""
    y = dense(p["w_in"], x)
    if model_cut(("w_in", "w"), (_width(p), 2 * _width(p))) is None:
        return y.chunk(2, dim=-1)
    if not _channels_cut(p):
        return shardctx.gather_from(y, "model", -1, partial=cut_seq).chunk(2, dim=-1)
    xb, gate = shardctx.gather_shards(y, "model", -1).chunk(2, dim=-1)
    return shardctx.local_slice(xb, "model", -1), shardctx.local_slice(gate, "model", -1)


def _rec(p, x, conv, lru, *, step: bool, cut_seq: bool = False):
    """The recurrent block on x (B,T,d) from the states ``conv`` (B,W-1,dr)
    and ``lru`` (B,dr) float32 (a rank's channels of them under a cut).
    With ``cut_seq`` x and y are this rank's chunk of the sequence, the
    states the whole sequence's.  -> (y, the new conv state, the new lru
    state)."""
    xb, gate = _split_in(p, enter_block(x, cut_seq), cut_seq)
    xc, conv = _causal_conv(p["conv_w"], p["conv_b"], xb, conv)
    y, lru = _rglru_step(p, xc, lru) if step else _rglru(p, xc, lru, cut_seq)
    return (row_dense(p, "w_out", y * F.gelu(gate, approximate="tanh"), _width(p),
                      cut_seq=cut_seq), conv, lru)


def rec_block_apply(p, x, state, cfg: ModelConfig, *, step: bool, cut_seq: bool = False):
    """x: (B,T,d); state {"conv": (B,W-1,dr), "lru": (B,dr) float32},
    updated in place."""
    y, conv, lru = _rec(p, x, state["conv"], state["lru"], step=step, cut_seq=cut_seq)
    state["conv"].copy_(conv)
    state["lru"].copy_(lru)
    return y


def rec_state_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d = cfg.d_model
    return {"conv": torch.zeros((batch, cfg.rglru_conv_width - 1, d), dtype=dtype,
                                device=device),
            "lru": torch.zeros((batch, d), dtype=torch.float32, device=device)}


# ----------------------------------------------------------------------
# Local attention with a ring-buffer window cache
# ----------------------------------------------------------------------

def attn_state_init(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    shape = (batch, cfg.attention_window, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(p, x, positions, cfg: ModelConfig, cut_seq: bool = False):
    """-> (q, k, v), whole heads (``layers.project_heads``; the first of
    each is ``layers.first_heads``'), q and k roped; over the whole
    sequence (gathered) with ``cut_seq``."""
    x = enter_block(x, cut_seq)
    q = project_heads(p, "wq", x, cfg.num_heads, cfg)
    k = project_heads(p, "wk", x, cfg.num_kv_heads, cfg)
    v = project_heads(p, "wv", x, cfg.num_kv_heads, cfg)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _local_attn(p, x, positions, cfg: ModelConfig, cut_seq: bool = False):
    """Windowed attention over the whole prompt.  -> (y, k, v); y this
    rank's chunk of the sequence with ``cut_seq``, k and v whole."""
    s, win = positions.shape[0], cfg.attention_window
    q, k, v = _qkv(p, x, positions[None], cfg, cut_seq)
    q0, k0 = first_heads(cfg)

    def attend(qa, ka, va):
        if s > CHUNK_THRESHOLD and s % Q_CHUNK == 0:
            return attention_chunked(qa, ka, va, positions, positions, win)
        return sdpa(qa, ka, va, causal_window_mask(positions, positions, win))

    out = attend_full(q, q0, k, v, k0, cfg, attend)
    return row_dense(p, "wo", out, cfg.q_dim, cut_seq=cut_seq), k, v


def local_attn_full(p, x, positions, state, cfg: ModelConfig, cut_seq: bool = False):
    """Attention over the whole prompt; its ring buffer is written into
    ``state`` in place: slot ``p % window`` holds position ``p`` when the
    prompt fills the window, else the prompt's positions lead and the rest
    is zero (a rank's slots of it where the rules cut the ring)."""
    s, win = positions.shape[0], cfg.attention_window
    y, k, v = _local_attn(p, x, positions, cfg, cut_seq)
    for name, t in (("k", k), ("v", v)):
        ring = state[name]
        if s >= win:
            # the last window's positions s-win .. s-1 go to their slots
            full = torch.roll(t[:, s - win:], (s - win) % win, dims=1)
        else:
            full = F.pad(t, (0, 0, 0, 0, 0, win - s))
        off = cache_offset(name, ring.shape[1])
        ring.copy_(full[:, off:off + ring.shape[1]])
    return y


def local_attn_step(p, x, pos, state, cfg: ModelConfig):
    """One token against the ring buffer.  pos: (B,) int tensor of each row's
    position, on the device: the ring slot and the absolute position each
    slot holds are computed there, and the new key and value go in by an
    indexed copy, so the step can be captured."""
    win = cfg.attention_window
    q, k, v = _qkv(p, x, pos[:, None], cfg)
    q0, k0 = first_heads(cfg)
    slot = torch.remainder(pos, win)
    write_token(state["k"], state["v"], k[:, 0], v[:, 0], slot)
    idx = chunk_positions("k", state["k"].shape[1], x.device)[None]
    base = (pos - slot)[:, None]
    kv_pos = torch.where(idx <= slot[:, None], base + idx, base - win + idx)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])               # (B, n)
    out = attend_decode(q, q0, state["k"], state["v"], k0, valid, cfg, kernel=False)
    return row_dense(p, "wo", out, cfg.q_dim)


# ----------------------------------------------------------------------
# blocks / units
# ----------------------------------------------------------------------

def block_init(generator, kind: str, cfg: ModelConfig, device) -> dict:
    p = {"ln1": norm_init(cfg.d_model, cfg.norm, cfg.pdt, device),
         "ln2": norm_init(cfg.d_model, cfg.norm, cfg.pdt, device)}
    if kind == "rglru":
        p["rec"] = rec_block_init(generator, cfg, device)
    else:
        p["attn"] = attn_init(generator, cfg, device)
    p["mlp"] = mlp_init(generator, cfg, device)
    return p


def block_apply(p, kind: str, x, positions, state, cfg: ModelConfig, *, step: bool,
                cut_seq: bool = False):
    """One layer; its ``state`` is updated in place.  positions: (S,) over a
    prompt, (B,) at a decode step.  With ``cut_seq`` x is this rank's
    chunk of the prompt."""
    x = shardctx.constrain_batch(x, seq_dim=1)
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "rglru":
        a = rec_block_apply(p["rec"], h, state, cfg, step=step, cut_seq=cut_seq)
    elif step:
        a = local_attn_step(p["attn"], h, positions, state, cfg)
    else:
        a = local_attn_full(p["attn"], h, positions, state, cfg, cut_seq)
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + mlp_apply(p["mlp"], h, cfg, cut_seq=cut_seq)


def _train_block(p, kind: str, x, positions, cfg: ModelConfig, cut_seq: bool = False):
    """One layer for training, from the zero state and writing none."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    if kind == "rglru":
        b, dr = x.shape[0], p["rec"]["conv_w"].shape[-1]    # a rank's channels
        conv = torch.zeros((b, cfg.rglru_conv_width - 1, dr), dtype=cfg.cdt, device=x.device)
        lru = torch.zeros((b, dr), dtype=torch.float32, device=x.device)
        a = _rec(p["rec"], h, conv, lru, step=False, cut_seq=cut_seq)[0]
    else:
        a = _local_attn(p["attn"], h, positions, cfg, cut_seq)[0]
    x = x + a
    h = apply_norm(p["ln2"], x, cfg.norm)
    return x + mlp_apply(p["mlp"], h, cfg, cut_seq=cut_seq)


def _train_unit(x, unit, positions, cfg: ModelConfig, cut_seq: bool = False):
    """One pattern unit (``b0``..) of ``_train_block``s."""
    for i, kind in enumerate(cfg.pattern or ("attn",)):
        x = _train_block(unit[f"b{i}"], kind, x, positions, cfg, cut_seq)
    return x


def block_state_init(kind: str, cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return (rec_state_init(cfg, batch, dtype, device) if kind == "rglru"
            else attn_state_init(cfg, batch, dtype, device))


def _split_layers(cfg: ModelConfig):
    pat = cfg.pattern or ("attn",)
    n_units = cfg.num_layers // len(pat)
    rem = cfg.full_pattern()[n_units * len(pat):]
    return pat, n_units, rem


# ----------------------------------------------------------------------
# init / cache
# ----------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's distributions, from ``generator``
    (torch's draws, not JAX's)."""
    pat, n_units, rem = _split_layers(cfg)
    return {
        "embed": embed_init(generator, cfg, device),
        "units": [{f"b{i}": block_init(generator, kind, cfg, device)
                   for i, kind in enumerate(pat)} for _ in range(n_units)],
        "extra": [block_init(generator, kind, cfg, device) for kind in rem],
        "final_norm": norm_init(cfg.d_model, cfg.norm, cfg.pdt, device),
    }


def init_cache(cfg: ModelConfig, batch: int, seq: int = 0, dtype=None,
               device="cuda") -> dict:
    """The zeroed state, O(window) in length (``seq`` is ignored): the
    reference's layout, ``units`` stacked on a leading ``n_units`` axis."""
    device = resolve_device(device)
    dt = dtype or cfg.cdt
    pat, n_units, rem = _split_layers(cfg)
    units = {f"b{i}": {n: t.expand(n_units, *t.shape).clone() for n, t in
                       block_state_init(kind, cfg, batch, dt, device).items()}
             for i, kind in enumerate(pat)}
    extra = [block_state_init(kind, cfg, batch, dt, device) for kind in rem]
    return {"units": units, "extra": extra}


def cache_batch(cache: dict) -> int:
    """The batch a state holds (axis 1 of a unit's leaf, axis 0 of an extra
    layer's)."""
    if cache["extra"]:
        return next(tensor_leaves(cache["extra"])).shape[0]
    return next(tensor_leaves(cache["units"])).shape[1]


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

def _apply_stack(params, x, positions, cache, cfg: ModelConfig, *, step: bool,
                 cut_seq: bool = False):
    pat, _, rem = _split_layers(cfg)
    for u, unit in enumerate(params["units"]):
        for i, kind in enumerate(pat):
            state = {n: t[u] for n, t in cache["units"][f"b{i}"].items()}
            x = block_apply(unit[f"b{i}"], kind, x, positions, state, cfg, step=step,
                            cut_seq=cut_seq)
    for j, kind in enumerate(rem):
        x = block_apply(params["extra"][j], kind, x, positions, cache["extra"][j], cfg,
                        step=step, cut_seq=cut_seq)
    return x


def _embed(params, tokens, cfg: ModelConfig, cut_seq: bool = False):
    """The token embeddings times sqrt(d_model), the factor rounded to the
    compute dtype first (gemma-style, as the reference); this rank's chunk
    of the sequence with ``cut_seq``."""
    scale = float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdt))
    return embed(params["embed"], tokens, cfg, cut_seq=cut_seq).to(cfg.cdt) * scale


def forward(params, tokens, cfg: ModelConfig, *, cache=None, return_state: bool = False):
    """tokens: (B,T) int.  -> (logits (B,T,V), aux 0), or (logits, state)
    with ``return_state``; a given ``cache`` is the initial state, updated
    in place."""
    b, s = tokens.shape
    cut = shardctx.seq_cut(tokens, 1)
    x = _embed(params, tokens, cfg, cut)
    if cache is None:
        cache = init_cache(cfg, b, device=x.device)
    x = _apply_stack(params, x, torch.arange(s, device=x.device), cache, cfg, step=False,
                     cut_seq=cut)
    logits = unembed(params["embed"], apply_norm(params["final_norm"], x, cfg.norm), cfg,
                     cut_seq=cut)
    if return_state:
        return logits, cache
    return logits, torch.zeros((), device=x.device)


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """The cross-entropy of the logits over ``batch["tokens"]`` against
    ``batch["labels"]``, from the zero state, writing none; with ``remat``
    each pattern unit runs under activation checkpointing (the remainder
    layers do not, as in the reference).  -> (loss, {"xent", "aux": 0})."""
    tokens = batch["tokens"]
    _, _, rem = _split_layers(cfg)
    cut = shardctx.seq_cut(tokens, 1)
    x = _embed(params, tokens, cfg, cut)
    positions = torch.arange(tokens.shape[1], device=x.device)
    unit = checkpointed(_train_unit, remat)
    for up in params["units"]:
        x = unit(x, up, positions, cfg, cut)
    for j, kind in enumerate(rem):
        x = _train_block(params["extra"][j], kind, x, positions, cfg, cut)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    loss = softmax_xent(unembed(params["embed"], x, cfg, cut_seq=cut), batch["labels"])
    return loss, {"xent": loss, "aux": torch.zeros((), device=x.device)}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int | None = None, *,
            last_pos=None, cache: dict | None = None):
    """Returns (last_logits (B,V), state).  ``cache_len`` is ignored (the
    state is O(window)).  ``cache``, when given, is reset to zero and then
    filled in place (so a captured prefill replays exactly); otherwise a new
    one is made.  Only the last position is normed and unembedded.
    ``last_pos`` must be None: pad tokens would advance the recurrent
    state, so callers keep exact-length prompts."""
    if last_pos is not None:
        raise ValueError(f"{cfg.name}: a recurrent state is length-sensitive; "
                         "prefill takes exact-length prompts (last_pos=None)")
    b, s = tokens.shape
    if cache is None:
        cache = init_cache(cfg, b, device=tokens.device)
    else:
        if cache_batch(cache) != b:
            raise ValueError(f"the state holds {cache_batch(cache)} rows, the prompt {b}")
        for t in tensor_leaves(cache):
            t.zero_()
    cut = shardctx.seq_cut(tokens, 1)
    x = _embed(params, tokens, cfg, cut)
    x = _apply_stack(params, x, torch.arange(s, device=x.device), cache, cfg, step=False,
                     cut_seq=cut)
    if cut:     # the last position is the last model rank's
        x = shardctx.seq_gather(x)
    last = apply_norm(params["final_norm"], x[:, -1], cfg.norm)
    return unembed(params["embed"], last, cfg), cache


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    """token: (B,) int; pos: an int, or a (B,) int tensor on the device.
    -> (logits (B,V), cache), updated in place."""
    pos = row_positions(pos, token.shape[0], token.device)
    x = _embed(params, token[:, None], cfg)
    x = _apply_stack(params, x, pos, cache, cfg, step=True)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["embed"], x, cfg)[:, 0], cache
