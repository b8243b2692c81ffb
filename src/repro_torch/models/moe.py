"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

The single-device path of the reference's ``repro/models/moe.py``.  Per
group of tokens:

  1. router -> top-k (expert id, gate) per token, gates renormalised;
  2. stable argsort of the (token, choice) pairs by expert id;
  3. the slot within an expert = rank - first rank of that expert
     (``searchsorted``); a pair whose slot is past the capacity C is dropped;
  4. the kept tokens are scattered into per-expert buffers (E, C, d) and the
     three expert products run batched over E;
  5. each pair reads its expert's output back, scaled by its gate, and the
     k choices of a token are summed.

Tokens are routed in groups (``DEFAULT_GROUP``) so that C stays bounded;
rows share capacity within a group, so a token's output depends on what is
batched with it, as in the reference.  All groups go through one pass here
(the reference vmaps over them): the buffers are laid out expert-major,
(E, G, C, d), so the products are three ``bmm`` over E.

Nothing here syncs with the host: group size and capacity are Python ints
fixed by the shapes, the drop is a spill row of the buffer that is cut off,
and the combine is deterministic (a sum over the k axis in (token, choice)
order, not an atomic add), so the layer can be captured into a CUDA graph
and its replay gives the uncaptured step's values bit for bit.

Under a mesh with a ``model`` axis (``repro_torch.shardctx``), the
counterpart of the reference's explicit-collective ``_moe_shard_map``: each
rank routes its own rows (the data axes' local batch) in groups, as the
reference's ``shard_map`` body does, and

* EP (``num_experts % model == 0``): the rank holds ``E/model`` experts,
  ``e0 = rank * E_local`` the first, and dispatches only the choices routed
  to them; the rest are dropped here and computed by their owner;
* TP-f (otherwise, ``d_ff % model == 0``): the rank holds an ``f/model``
  slice of every expert and runs the whole dispatch on it;

either way its (E, G, C, d) buffers stay on the rank, and one all-reduce of
the float32 activation-sized partial output combines the ranks.  The
router is replicated and its gates enter the rank's combine through
``shardctx.copy_to``, so that its gradient is whole on every rank.  The
load-balance loss is taken over the tokens of every data rank (the
expert counts all-reduced over the data axes).

Under sequence parallelism (``cut_seq``) the layer takes a rank's chunk
of the sequence: the chunks are gathered before routing (so the groups
and their capacity are the unsharded run's), the partial output is
reduce-scattered back to the chunk, and the gates enter the rank's share
without ``copy_to``: their gradient, and the router's, stay the rank's
share, summed by the gather's reduce-scatter and by the train step.  The
load-balance loss keeps its value, its gradient taken through the rank's
own tokens' probabilities.
"""
from __future__ import annotations

import math

import torch

from repro_torch import shardctx
from repro_torch.launch.mesh import data_axes
from repro_torch.launch.sharding import model_cut
from .common import ModelConfig, activation, dense_init, float32_products

DEFAULT_GROUP = 4096


def moe_init(generator, cfg: ModelConfig, device) -> dict:
    """The router (d, E) float32 N(0, 1/d); ``wi`` and ``wu`` (E, d, f)
    N(0, 1/d) and ``wd`` (E, f, d) N(0, 1/f), drawn in float32 and cast to
    the param dtype, as the reference draws them (the draws are torch's)."""
    d, f, e, pdt = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.pdt

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(pdt)

    return {
        "router": dense_init(generator, d, e, torch.float32, device),
        "wi": normal((e, d, f), d ** -0.5),
        "wu": normal((e, d, f), d ** -0.5),
        "wd": normal((e, f, d), f ** -0.5),
    }


def capacity(group_size: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(group_size * cfg.num_experts_per_tok
                      * cfg.moe_capacity_factor / cfg.num_experts))
    return max(c, 1)


def _route_groups(xg, idx, gate, wi, wu, wd, cfg: ModelConfig, cap: int, *,
                  e0: int = 0, partial: bool = False, ffn_cut: bool = False):
    """Every group at once: xg (G,gs,d), idx/gate (G,gs,k) -> (G,gs,d).

    ``wi`` may hold only a local slice of the experts (expert parallelism):
    ``e0`` is this rank's first expert id; choices routed elsewhere are
    dropped here.  With ``partial`` the output is this rank's float32 share
    of the sum (its experts, or with ``ffn_cut`` its ffn slice), for the
    all-reduce."""
    g, gs, d = xg.shape
    e, k = wi.shape[0], cfg.num_experts_per_tok
    n, dev = gs * k, xg.device
    act = activation(cfg.act)

    eflat = idx.reshape(g, n)                                  # (token, choice) order
    order = torch.argsort(eflat, dim=-1, stable=True)
    sorted_e = torch.gather(eflat, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    ranks = torch.arange(n, device=dev) - first                # slot, in sorted order
    pos = torch.empty_like(ranks).scatter_(1, order, ranks)    # back in (token, choice) order
    local = eflat - e0                                         # the local expert index
    valid = (pos < cap) & (local >= 0) & (local < e)
    slot = (local * g + torch.arange(g, device=dev)[:, None]) * cap + pos
    spill = e * g * cap                                        # the row dropped pairs go to
    dest = torch.where(valid, slot, spill)

    buf = torch.zeros((spill + 1, d), dtype=cfg.cdt, device=dev)
    buf[dest.reshape(-1)] = xg.to(cfg.cdt)[:, :, None].expand(g, gs, k, d).reshape(-1, d)
    buf = buf[:spill].view(e, g * cap, d)

    h = act(torch.bmm(buf, wi)) * torch.bmm(buf, wu)
    if ffn_cut:
        # an ffn slice: the down projection's partial sums in float32
        yb = float32_products(h, wd).reshape(spill, d)
    else:
        yb = torch.bmm(h, wd).reshape(spill, d)

    gflat = gate.reshape(g, n).to(yb.dtype) * valid.to(yb.dtype)
    contrib = yb[torch.where(valid, slot, 0)] * gflat[..., None]
    if partial:
        return contrib.float().view(g, gs, k, d).sum(dim=2)
    # The reference adds each pair into its token's row in sorted order
    # (``y.at[tok].add``); this sums a token's k choices in choice order.
    # The two differ by rounding only (within 1e-5 at float32), and this
    # order is the same on every run.
    return contrib.view(g, gs, k, d).sum(dim=2)


def _dispatch_all_groups(xt, rw, wi, wu, wd, cfg: ModelConfig, group_size: int, *,
                         e0: int = 0, partial: bool = False, ffn_cut: bool = False,
                         cut_seq: bool = False):
    """xt: (T, d) -> (T, d) MoE output (with ``partial``, this rank's
    float32 share of it: the experts or the ffn slice it holds; with
    ``cut_seq`` the gates' gradient left as the rank's share)."""
    t, d = xt.shape
    gs = min(t, group_size)
    if t % gs:
        gs = math.gcd(t, gs)
    g = t // gs
    cap = capacity(gs, cfg)
    xg = xt.reshape(g, gs, d)
    probs = torch.softmax(xg.float() @ rw, dim=-1)             # (G,gs,E)
    gate, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    if partial:
        # the router and the tokens are replicated over the model axis and
        # enter this rank's share of the experts here
        xg = shardctx.copy_to(xg, partial=cut_seq)
        gate = shardctx.copy_to(gate, partial=cut_seq)
    return _route_groups(xg, idx, gate, wi, wu, wd, cfg, cap, e0=e0,
                         partial=partial, ffn_cut=ffn_cut).reshape(t, d)


def _aux_loss(p: dict, x: torch.Tensor, cfg: ModelConfig, cut_seq: bool = False) -> torch.Tensor:
    """Switch-style load-balance loss.  With ``cut_seq`` (x the whole
    sequence, gathered) its gradient is taken through this rank's chunk of
    the tokens alone, so that it is the rank's share as every gradient in
    a sequence-parallel block; its value is the whole loss."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(t, -1).float() @ p["router"]["w"], dim=-1)
    _, idx = torch.topk(probs, k, dim=-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.ones((t * k,), dtype=torch.float32, device=x.device))
    # Under data axes: the token fractions over every rank's tokens; the
    # probs' mean stays this rank's, whose mean over the ranks is the
    # reference's global loss, and whose gradient, averaged as the data
    # ranks' gradients are, is its gradient.
    mesh = shardctx.get_mesh()
    dax = data_axes(mesh) if mesh is not None else ()
    t_all = t * shardctx.size(dax)
    counts = shardctx.all_reduce(counts, dax)
    frac_tokens = counts / float(t_all * k)
    frac_probs = probs.mean(dim=0)
    loss = e * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_weight
    if not cut_seq:
        return loss
    mine = shardctx.local_slice(probs.view(*x.shape[:2], e), "model", 1).sum((0, 1)) / t
    share = e * torch.sum(frac_tokens * mine) * cfg.router_aux_weight
    return loss.detach() + (share - share.detach())


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            group_size: int = DEFAULT_GROUP, *, cut_seq: bool = False) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), the layer's output without its loss (what
    the prefill and the decode step run).  With ``cut_seq`` x and the
    output are this rank's chunk of the sequence."""
    return _ffn(p, shardctx.seq_gather(x) if cut_seq else x, cfg, group_size, cut_seq)


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, group_size: int,
         cut_seq: bool) -> torch.Tensor:
    """``moe_ffn`` of x over the whole sequence."""
    b, s, d = x.shape
    wi = p["wi"]
    # the rules cut the experts (EP, dim 0) or each one's ffn (TP-f, dim 2)
    cut = model_cut(("moe", "wi"), (cfg.num_experts, d, cfg.d_ff))
    sharded = cut is not None
    e0 = shardctx.index("model") * wi.shape[0] if cut == 0 else 0
    y = _dispatch_all_groups(x.reshape(b * s, d), p["router"]["w"], wi.to(cfg.cdt),
                             p["wu"].to(cfg.cdt), p["wd"].to(cfg.cdt), cfg, group_size,
                             e0=e0, partial=sharded, ffn_cut=cut == 2, cut_seq=cut_seq)
    y = y.reshape(b, s, d)
    if sharded:
        y = shardctx.seq_reduce_scatter(y, x.dtype) if cut_seq else shardctx.reduce_from(y)
    elif cut_seq:
        y = shardctx.seq_slice(y)
    return y.to(x.dtype)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              group_size: int = DEFAULT_GROUP, *, cut_seq: bool = False):
    """x: (B, S, d) -> (y, aux_loss); with ``cut_seq`` x and y are this
    rank's chunk of the sequence."""
    x = shardctx.seq_gather(x) if cut_seq else x
    return _ffn(p, x, cfg, group_size, cut_seq), _aux_loss(p, x, cfg, cut_seq)
