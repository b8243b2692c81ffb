"""RWKV-6 "Finch" — attention-free RNN with data-dependent decay (arXiv:2404.05892).

Per layer: a *time-mix* block (data-dependent token-shift "ddlerp", per-channel
data-dependent decay ``w_t = exp(-exp(w0 + lora(x)))``, WKV matrix-state
recurrence with bonus ``u``) and a *channel-mix* block (shifted squared-relu
MLP).  The recurrent state is O(1) in sequence length.

Recurrence (per head, key-dim i, value-dim j):
    o_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
    S      = diag(w_t) @ S + k_t (outer) v_t
It goes through ``repro_torch.kernels.dispatch.rwkv_scan``: the Hopper WKV-6
kernel on CUDA tensors, its plain version (``kernels/rwkv/ref.py``) on CPU
tensors.

The reference scans the stacked layers; here the layer stack is a list of
per-layer param dicts walked by a Python loop.  The state keeps the reference
layout, a dict of (L,B,...) tensors, and a state handed to ``forward`` or
``decode_step`` is updated in place (the counterpart of the reference's
donated cache).  ``train_loss`` runs a functional copy of the layer
(``_train_layer``): each layer starts from the zero state and writes no
state, so autograd differentiates K3 through K3-bwd
(``kernels/dispatch.WKV6``) and nothing is overwritten in place.

Under a mesh with a ``model`` axis (``repro_torch.shardctx``) a rank holds
the reference rules' shards (``launch/sharding.py``): ``wr``/``wk``/``wv``/
``wg`` column-parallel by heads, ``u`` and the WKV state by heads, ``wo``
row-parallel (its float32 partial sums all-reduced), and K3 runs on the
rank's heads.  The rules cut two more weights whose outputs are then
gathered: ``mix_w1`` (in their column set, so the token-shift LoRA's
output is cut over its rank) and the channel mix's ``wv``, a down
projection ``(f, d)`` in the column set by name (so its ``d`` columns are
cut: the channel mix gathers its ``f`` hidden units before it and its
output after it).  The state's token shifts are cut over ``d`` by the
cache rules: each layer gathers them and keeps its slice of the new ones.
The decay and the group norm are computed whole and sliced to the rank's
heads.

Under sequence parallelism (``shardctx.seq_cut`` of the tokens) the
residual stream is the rank's chunk of the positions and the norms run on
the rank's tokens.  The token shift crosses the chunks' boundaries, so
each mix gathers its normed input along the sequence (K3 and K3-bwd then
run on the whole sequence, and a prefill's state, the shifts' last token
included, is the whole sequence's); the time mix's ``wo`` reduce-scatters
its partial sums to the chunk, and the channel mix's output, whole after
its gather over columns, is cut to the chunk.  Inside a mix every
``copy_to``, ``gather_from`` and ``scatter_to`` takes ``partial``
(``shardctx``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, shardctx
from repro_torch.kernels import dispatch
from repro_torch.launch.sharding import model_cut
from .common import ModelConfig, apply_norm, dense, dense_init, norm_init, remat as checkpointed
from .layers import embed, embed_init, row_dense, unembed
from .transformer import softmax_xent

MIX_KEYS = ("r", "k", "v", "w", "g")
PREFILL_CHUNK = 8192
GROUP_NORM_EPS = 64e-5


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------

def _tmix_init(generator, cfg: ModelConfig, device) -> dict:
    d, pdt = cfg.d_model, cfg.pdt
    h = cfg.num_heads
    hd = d // h
    lora, dl = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    mix_w1 = dense_init(generator, d, 5 * lora, pdt, device)["w"].reshape(d, 5, lora)
    mix_w2 = dense_init(generator, lora, d, pdt, device, scale=0.01)["w"]
    return {
        "mu_x": torch.full((d,), 0.5, dtype=pdt, device=device),
        "mu": torch.full((5, d), 0.5, dtype=pdt, device=device),
        "mix_w1": mix_w1,
        "mix_w2": mix_w2[None].repeat(5, 1, 1),   # one draw for all five
        "w0": torch.full((d,), -5.0, dtype=torch.float32, device=device),
        "decay_w1": dense_init(generator, d, dl, pdt, device)["w"],
        "decay_w2": dense_init(generator, dl, d, pdt, device, scale=0.01)["w"],
        "u": torch.full((h, hd), 0.5, dtype=torch.float32, device=device),
        "wr": dense_init(generator, d, d, pdt, device),
        "wk": dense_init(generator, d, d, pdt, device),
        "wv": dense_init(generator, d, d, pdt, device),
        "wg": dense_init(generator, d, d, pdt, device),
        "wo": dense_init(generator, d, d, pdt, device, scale=0.0),
        "gn": norm_init(d, "layernorm", pdt, device),   # per-head group norm
    }


def _cmix_init(generator, cfg: ModelConfig, device) -> dict:
    d, f, pdt = cfg.d_model, cfg.d_ff, cfg.pdt
    return {
        "mu_k": torch.full((d,), 0.5, dtype=pdt, device=device),
        "mu_r": torch.full((d,), 0.5, dtype=pdt, device=device),
        "wk": dense_init(generator, d, f, pdt, device),
        "wv": dense_init(generator, f, d, pdt, device),
        "wr": dense_init(generator, d, d, pdt, device),
    }


def layer_init(generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": norm_init(cfg.d_model, "layernorm", cfg.pdt, device),
        "ln2": norm_init(cfg.d_model, "layernorm", cfg.pdt, device),
        "tmix": _tmix_init(generator, cfg, device),
        "cmix": _cmix_init(generator, cfg, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random weights with the reference's distributions (``wo`` included,
    drawn at scale 0), from ``generator`` (torch's draws, not JAX's)."""
    return {
        "embed": embed_init(generator, cfg, device),
        "ln_in": norm_init(cfg.d_model, "layernorm", cfg.pdt, device),
        "layers": [layer_init(generator, cfg, device) for _ in range(cfg.num_layers)],
        "final_norm": norm_init(cfg.d_model, "layernorm", cfg.pdt, device),
    }


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------

def _shift(x, prev):
    """x: (B,T,d), prev: (B,d) -> x shifted right by one with prev injected."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(p, x, xprev, cfg, cut_seq: bool = False):
    """Data-dependent token-shift: returns dict of mixed inputs for r,k,v,w,g."""
    delta = xprev - x
    xx = x + delta * p["mu_x"].to(x.dtype)
    w1 = p["mix_w1"]
    cut = model_cut(("mix_w1",), (cfg.d_model, len(MIX_KEYS), cfg.rwkv_mix_lora)) is not None
    if cut:                                      # the LoRA width cut over "model"
        xx = shardctx.copy_to(xx, partial=cut_seq)
    stacked = torch.tanh(torch.einsum("btd,dfl->fbtl", xx, w1.to(x.dtype)))
    if cut:
        stacked = shardctx.gather_from(stacked, "model", -1, partial=cut_seq)
    adj = torch.einsum("fbtl,fld->fbtd", stacked, p["mix_w2"].to(x.dtype))
    return {key: x + delta * (p["mu"][i].to(x.dtype) + adj[i])
            for i, key in enumerate(MIX_KEYS)}


def time_mix(p, x, state_wkv, shift_prev, cfg: ModelConfig, *, out_state=None,
             cut_seq: bool = False):
    """x: (B,T,d).  Returns (out, new_wkv_state, new_shift (B,d)); the new
    wkv state is written into ``out_state`` when given (it may be
    ``state_wkv``: the kernel updates the state in place).  With
    ``cut_seq`` x and out are this rank's chunk of the sequence; the state
    and the shift are the whole sequence's."""
    if cut_seq:
        x = shardctx.seq_gather(x)
    b, t, d = x.shape
    hd = d // cfg.num_heads
    xprev = _shift(x, shift_prev)
    m = _ddlerp(p, x, xprev, cfg, cut_seq)

    def heads(key):
        return dense(p[key], shardctx.copy_to(m[key[1]], partial=cut_seq)).reshape(b, t, -1, hd)

    r, k, v = (heads(key).float() for key in ("wr", "wk", "wv"))
    g = F.silu(dense(p["wg"], shardctx.copy_to(m["g"], partial=cut_seq)))
    dec = p["w0"] + torch.tanh(m["w"].float() @ p["decay_w1"].float()) \
        @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(dec))                               # (0,1) decay
    gn_scale, gn_bias = p["gn"]["scale"].float(), p["gn"]["bias"].float()
    if model_cut(("wr", "w"), (d, d)) is not None:
        # whole on every rank; this rank's heads of them
        w, gn_scale, gn_bias = (
            shardctx.local_slice(shardctx.copy_to(z, partial=cut_seq), "model", -1)
            for z in (w, gn_scale, gn_bias))
    w = w.reshape(b, t, -1, hd).contiguous()
    o, state_wkv = dispatch.rwkv_scan(r, k, v, w, p["u"].float(), state_wkv,
                                      out_state=out_state)
    # per-head group norm, population variance
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, unbiased=False)
    o = (o - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    o = o.reshape(b, t, -1) * gn_scale + gn_bias
    out = row_dense(p, "wo", o.to(x.dtype) * g, d, cut_seq=cut_seq)
    return out, state_wkv, x[:, -1]


def channel_mix(p, x, shift_prev, cfg: ModelConfig, cut_seq: bool = False):
    """x: (B,T,d) -> (out, the new shift (B,d)); with ``cut_seq`` x and out
    are this rank's chunk of the sequence, the shift the whole's."""
    if cut_seq:
        x = shardctx.seq_gather(x)
    xprev = _shift(x, shift_prev)
    xk = x + (xprev - x) * p["mu_k"].to(x.dtype)
    xr = x + (xprev - x) * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(dense(p["wk"], shardctx.copy_to(xk, partial=cut_seq))))
    d = x.shape[-1]
    if model_cut(("wk", "w"), (d, cfg.d_ff)) is not None:
        k = shardctx.gather_from(k, "model", -1, partial=cut_seq)
    kv = dense(p["wv"], shardctx.copy_to(k, partial=cut_seq))
    out = torch.sigmoid(dense(p["wr"], shardctx.copy_to(xr, partial=cut_seq))) * kv
    if model_cut(("wv", "w"), (cfg.d_ff, d)) is not None:   # and wr's, as wide
        out = shardctx.gather_from(out, "model", -1, partial=cut_seq)
    return (shardctx.seq_slice(out) if cut_seq else out), x[:, -1]


def _layer(x, lp, state, cfg: ModelConfig, cut_seq: bool = False):
    """One layer; ``state`` holds this layer's (B,...) views of the stacked
    state, which are updated in place.  -> x."""
    x = shardctx.constrain_batch(x, seq_dim=1)
    h = apply_norm(lp["ln1"], x, "layernorm")
    a, _, sh_t = time_mix(lp["tmix"], h, state["wkv"], _whole(state, "shift_t", x), cfg,
                          out_state=state["wkv"], cut_seq=cut_seq)
    x = x + a
    h = apply_norm(lp["ln2"], x, "layernorm")
    c, sh_c = channel_mix(lp["cmix"], h, _whole(state, "shift_c", x), cfg, cut_seq)
    state["shift_t"].copy_(_mine(sh_t, "shift_t"))
    state["shift_c"].copy_(_mine(sh_c, "shift_c"))
    return x + c


def _shift_cut(name: str, d: int) -> bool:
    """Whether the cache rules cut the state's token shift ``name`` over
    the model axis."""
    return model_cut((name,), (1, 1, d), cache=True) is not None


def _whole(state, name: str, x):
    """The token shift ``name`` of the state (B, d), gathered when the cache
    rules cut it."""
    shift = state[name]
    return shardctx.gather_from(shift, "model", -1) if _shift_cut(name, x.shape[-1]) else shift


def _mine(new, name: str):
    """The part of the whole new token shift that this rank's state holds."""
    return shardctx.local_slice(new, "model", -1) if _shift_cut(name, new.shape[-1]) else new


def _train_layer(x, lp, cfg: ModelConfig, cut_seq: bool = False):
    """One layer for training, from the zero state (the reference's
    ``forward`` with no state given) and writing none.  -> x."""
    b, _, d = x.shape
    hd = d // cfg.num_heads
    shift = torch.zeros((b, d), dtype=cfg.cdt, device=x.device)
    heads = lp["tmix"]["u"].shape[0]             # this rank's heads
    wkv0 = torch.zeros((b, heads, hd, hd), dtype=torch.float32, device=x.device)
    h = apply_norm(lp["ln1"], x, "layernorm")
    a, _, _ = time_mix(lp["tmix"], h, wkv0, shift, cfg, cut_seq=cut_seq)
    x = x + a
    h = apply_norm(lp["ln2"], x, "layernorm")
    c, _ = channel_mix(lp["cmix"], h, shift, cfg, cut_seq)
    return x + c


def train_loss(params, batch, cfg: ModelConfig, *, remat: bool = True):
    """The cross-entropy of the logits over ``batch["tokens"]`` against
    ``batch["labels"]``, each layer under activation checkpointing with
    ``remat``.  -> (loss, {"xent", "aux": 0})."""
    cut = shardctx.seq_cut(batch["tokens"], 1)
    x = embed(params["embed"], batch["tokens"], cfg, cut_seq=cut).to(cfg.cdt)
    x = apply_norm(params["ln_in"], x, "layernorm")
    layer = checkpointed(_train_layer, remat)
    for lp in params["layers"]:
        x = layer(x, lp, cfg, cut)
    x = apply_norm(params["final_norm"], x, "layernorm")
    loss = softmax_xent(unembed(params["embed"], x, cfg, cut_seq=cut), batch["labels"])
    return loss, {"xent": loss, "aux": torch.zeros((), device=x.device)}


# ----------------------------------------------------------------------
# public API (mirrors transformer.py)
# ----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq: int = 0, dtype=None,
               device="cuda") -> dict:
    """RWKV 'cache' = recurrent state; O(1) in seq (seq arg ignored)."""
    device = resolve_device(device)
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    sdt = dtype or cfg.cdt
    return {
        "wkv": torch.zeros((cfg.num_layers, batch, h, hd, hd), dtype=torch.float32,
                           device=device),
        "shift_t": torch.zeros((cfg.num_layers, batch, d), dtype=sdt, device=device),
        "shift_c": torch.zeros((cfg.num_layers, batch, d), dtype=sdt, device=device),
    }


def _fresh_state(cfg: ModelConfig, batch: int, device) -> dict:
    """A zero state of ``batch`` rows; under a model axis, this rank's
    shards of it, cut where the cache rules cut it."""
    state = init_cache(cfg, batch, device=device)
    for name, t in state.items():
        dim = model_cut((name,), tuple(t.shape), cache=True)
        if dim is not None:
            state[name] = shardctx.local_slice(t, "model", dim).contiguous()
    return state


def _hidden(params, tokens, cfg: ModelConfig, state: dict):
    """The layer stack over tokens (B,T), carrying ``state`` in place.
    -> (final hidden states before the norm, whether sequence parallelism
    cut them: then this rank's chunk of the sequence)."""
    cut = shardctx.seq_cut(tokens, 1)
    x = embed(params["embed"], tokens, cfg, cut_seq=cut).to(cfg.cdt)
    x = apply_norm(params["ln_in"], x, "layernorm")
    for i, lp in enumerate(params["layers"]):
        x = _layer(x, lp, {n: s[i] for n, s in state.items()}, cfg, cut)
    return x, cut


def forward(params, tokens, cfg: ModelConfig, *, state=None, return_state: bool = False):
    """tokens: (B,T) int.  -> (logits (B,T,V), aux 0), or (logits, state)
    with ``return_state``.  A given ``state`` is updated in place."""
    if state is None:
        state = _fresh_state(cfg, tokens.shape[0], tokens.device)
    x, cut = _hidden(params, tokens, cfg, state)
    x = apply_norm(params["final_norm"], x, "layernorm")
    logits = unembed(params["embed"], x, cfg, cut_seq=cut)
    if return_state:
        return logits, state
    return logits, torch.zeros((), device=x.device)


def prefill(params, tokens, cfg: ModelConfig, cache_len: int | None = None, *,
            last_pos=None, cache: dict | None = None, chunk: int = PREFILL_CHUNK):
    """Returns (last_logits (B,V), state).  ``cache_len`` is ignored (the
    state is O(1) in length).

    ``cache``, when given, is a preallocated state that is reset to zero and
    then carried through the prompt in place (so a captured prefill,
    ``serving/graphs.py::PrefillGraph``, replays exactly); otherwise a new
    one is made.
    A prompt over ``chunk`` tokens that is a multiple of it runs chunk by
    chunk with the state carried between them (exact; only the per-chunk
    activations shrink).  Only the last position is normed and unembedded.
    ``last_pos`` must be None: pad tokens would advance the recurrent
    state, so callers keep exact-length prompts."""
    if last_pos is not None:
        raise ValueError(f"{cfg.name}: a recurrent state is length-sensitive; "
                         "prefill takes exact-length prompts (last_pos=None)")
    b, s = tokens.shape
    if cache is None:
        cache = _fresh_state(cfg, b, tokens.device)
    else:
        if cache["wkv"].shape[1] != b:
            raise ValueError(f"the state holds {cache['wkv'].shape[1]} rows, "
                             f"the prompt {b}")
        for t in cache.values():
            t.zero_()
    pieces = tokens.split(chunk, dim=1) if s > chunk and s % chunk == 0 else (tokens,)
    for piece in pieces:
        x, cut = _hidden(params, piece, cfg, cache)
    if cut:     # the last position is the last model rank's
        x = shardctx.seq_gather(x)
    last = apply_norm(params["final_norm"], x[:, -1], "layernorm")
    return unembed(params["embed"], last, cfg), cache


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    """token: (B,) int.  ``pos`` is ignored (stateful recurrence); kept for
    interface parity.  -> (logits (B,V), cache), updated in place."""
    x, _ = _hidden(params, token[:, None], cfg, cache)
    x = apply_norm(params["final_norm"], x, "layernorm")
    return unembed(params["embed"], x, cfg)[:, 0], cache
