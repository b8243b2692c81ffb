"""The collectives that one decode step moves on a rank, from the layout alone.

The analytic side of ``repro_torch.shardctx``'s counts: what the model code
of the dense, MoE, vlm, hybrid, audio and ssm families runs on a rank for
one token of every row, derived from the partition rules of
``launch/sharding.py`` (which widths they cut over "model", where a cut
falls inside a head, which axes cut a cache's sequence) and the mesh's
axis sizes, with no model run.  The bytes are a rank's ring bytes, as
``shardctx`` records them: an all-reduce of S bytes over N ranks moves
``2 S (N-1)/N``, an all-gather to a whole of S bytes ``S (N-1)/N``.

Per layer, with b the rank's rows, d the model width, hd the head dim, e the
compute dtype's bytes, M the model axis and N the ranks that cut the KV
sequence:

* a query, key or value projection whose columns the rules cut inside a
  head: an all-gather of its (b, width) output, in e bytes;
* a KV sequence cut over "model" with the query heads cut on head
  boundaries: an all-gather of q, (b, H, hd) in e bytes;
* a KV sequence cut over N > 1 ranks: the row log-sum-exps all-gathered,
  (b, H') float32, and the weighted outputs all-reduced, (b, H', hd)
  float32, H' the heads the rank attends with (all H where "model" cuts
  the sequence, else those its ``wo`` rows take);
* ``wo``, ``wd``, a MoE layer's experts and the hybrid's ``w_out`` cut over
  M: an all-reduce of the float32 (b, d) partial sums each;
* the hybrid's recurrence under a cut: its input projection's (b, 2 dr)
  gathered, in e bytes, and the gates' float32 (b, dr) input gathered;
* an RWKV-6 layer (ssm): each token shift that the cache rules cut
  (``shift_t``, ``shift_c``) gathered, (b, d) in e bytes; the five
  data-dependent mixes' LoRA activations gathered where ``mix_w1`` is cut,
  (5, b, lora) in e bytes; the channel mix's key, (b, d_ff), where ``wk``
  is cut, and its output, (b, d), where ``wv`` is cut, gathered in e bytes;
  the time mix's ``wo`` as a row-cut projection above;

and once a step, the embedding's float32 (b, d) all-reduce and the
logits' float32 (b, V) all-gather where the vocabulary is cut.
"""
from __future__ import annotations

import torch

from repro_torch import shardctx
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh, axis_size
from repro_torch.models import api, layers, ssm
from repro_torch.models.common import ModelConfig


def decode_step(cfg: ModelConfig, mesh_shape: dict, *, batch: int, cache_len: int,
                model_index: int = 0) -> dict:
    """{kind: (count, bytes)} of one decode step of ``cfg`` at ``batch`` rows
    (the whole request's) over a ``cache_len``-position cache on the rank
    with index ``model_index`` on the model axis of a mesh of
    ``mesh_shape`` (axis name -> size, in mesh order).  What a rank holds
    is asked of ``sharding.model_cut``, ``head_span`` and
    ``layers.out_heads`` under that rank's mesh, as the model code asks."""
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "audio", "ssm"):
        raise ValueError(f"{cfg.name}: no decode plan for the {cfg.family} family")
    mesh = Mesh(axis_names=tuple(mesh_shape), shape=dict(mesh_shape), rank=0,
                coords={a: model_index if a == "model" else 0 for a in mesh_shape},
                device=torch.device("meta"), backend="")
    with shardctx.use_mesh(mesh):
        return _decode_step(cfg, mesh, batch, cache_len)


def _decode_step(cfg: ModelConfig, mesh: Mesh, batch: int, cache_len: int) -> dict:
    m = mesh.size("model")
    spec = sharding.batch_pspec((batch,), mesh)
    b = batch // (axis_size(mesh, spec[0]) if spec[0] is not None else 1)
    e = torch.empty((), dtype=cfg.cdt).element_size()
    d, hd, heads = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    abs_cache = api.init_cache(cfg, batch, cache_len, device="meta")
    seq = sharding.seq_cuts(abs_cache, sharding.cache_pspecs(abs_cache, cfg, mesh, batch=batch))
    out: dict = {}

    def add(kind: str, nbytes: float, n: int) -> None:
        if n > 1:
            count, total = out.get(kind, (0, 0.0))
            out[kind] = (count + 1, total + (2.0 if kind == "all-reduce" else 1.0)
                         * nbytes * (n - 1) / n)

    def cut(keys, shape) -> bool:
        return sharding.model_cut(tuple(keys), tuple(shape)) is not None

    def inside(key: str, width: int) -> bool:
        span = sharding.head_span((key, "w"), (d, width), hd)
        return span is not None and not span[2]

    def row(key: str, full_in: int) -> None:
        if cut((key, "w"), (full_in, d)):
            add("all-reduce", b * d * 4, m)

    def attention(name: str, project_kv: bool) -> None:
        for key, width in (("wq", cfg.q_dim),) + (
                (("wk", cfg.kv_dim), ("wv", cfg.kv_dim)) if project_kv else ()):
            if inside(key, width):
                add("all-gather", b * width * e, m)
        axes = seq.get(name, ())
        n = axis_size(mesh, axes) if axes else 1
        if "model" in axes and cut(("wq", "w"), (d, cfg.q_dim)) and not inside("wq", cfg.q_dim):
            add("all-gather", b * heads * hd * e, m)
        lo, hi = layers.out_heads(cfg)
        h_att = heads if "model" in axes else hi - lo
        add("all-gather", n * b * h_att * 4, n)
        add("all-reduce", b * h_att * hd * 4, n)
        row("wo", cfg.q_dim)

    vocab_keys = (("embedding",), (cfg.vocab_size, d))
    if cut(*vocab_keys):
        add("all-reduce", b * d * 4, m)
    if cfg.family == "ssm":
        for _ in range(cfg.num_layers):
            for name in ("shift_t", "shift_c"):
                if sharding.model_cut((name,), (1, 1, d), cache=True) is not None:
                    add("all-gather", b * d * e, m)
            if cut(("mix_w1",), (d, len(ssm.MIX_KEYS), cfg.rwkv_mix_lora)):
                add("all-gather", len(ssm.MIX_KEYS) * b * cfg.rwkv_mix_lora * e, m)
            row("wo", d)
            if cut(("wk", "w"), (d, cfg.d_ff)):
                add("all-gather", b * cfg.d_ff * e, m)
            if cut(("wv", "w"), (cfg.d_ff, d)):
                add("all-gather", b * d * e, m)
    elif cfg.family == "audio":
        for _ in range(cfg.num_layers):
            attention("k", True)
            attention("xk", False)
            row("wo", cfg.d_ff)
    else:
        for kind in cfg.full_pattern():
            if kind == "rglru":
                if cut(("w_in", "w"), (d, 2 * d)):
                    add("all-gather", b * 2 * d * e, m)
                if cut(("conv_w",), (cfg.rglru_conv_width, d)):
                    add("all-gather", b * d * 4, m)
                row("w_out", d)
            else:
                attention("k", True)
            if cfg.is_moe:
                if cut(("moe", "wi"), (cfg.num_experts, d, cfg.d_ff)):
                    add("all-reduce", b * d * 4, m)
            else:
                row("wd", cfg.d_ff)
    unembed = vocab_keys if cfg.tie_embeddings else (("unembed", "w"), (d, cfg.vocab_size))
    if cut(*unembed):
        add("all-gather", b * cfg.vocab_size * 4, m)
    return out
