"""The collectives that one decode step, and one prefill, move on a rank,
from the layout alone.

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

A prefill (``prefill``) of s positions moves the same collectives with
(b, s, ...) for (b, ...), no KV-sequence combine (its attention is over
the whole prompt), the audio family's cross-attention keys and values
projected from its (b, Se, d) frames in every decoder layer, and after the
stack the last position's logits, (b, V), gathered where the vocabulary
is cut.  Under sequence parallelism (``shardctx.seq_cut``: the flag, and
s dividing M) the stream is cut to (b, s/M, d) between blocks, and

* each block gathers its normed (b, s, d) input in the compute dtype,
  ``e·bsd·(M-1)/M``, where tensor parallelism's ``copy_to`` moves
  nothing (before attention, the MLP, a MoE layer, an RWKV-6 time or
  channel mix, an RG-LRU block; twice in a whisper decoder layer, for the
  self- and the cross-attention's queries);
* each row-cut product's float32 all-reduce, ``2·4·bsd·(M-1)/M``,
  becomes a float32 reduce-scatter, ``4·bsd·(M-1)/M``;
* the embedding's float32 all-reduce becomes a reduce-scatter (half its
  bytes; the vlm family merges its patches into whole embeddings, which
  keep the all-reduce and are then cut), and the stream is gathered
  once, (b, s, d) in e bytes, before the last positions are normed and
  unembedded; whisper's encoder is cut by its frames' length alone and
  gathers its output once for the decoder.

A dense layer's two row-cut products and two gathers then move
``2·(4 + e)·bsd·(M-1)/M`` against ``2·8·bsd·(M-1)/M``: 0.75 of the link
bytes in bf16 (e = 2), 1.0 in float32, in twice the collectives.  A
decode step's length of 1 never divides M > 1, so its plan is the same
with or without the flag.

A train step runs the train forward (the whole sequence's logits, their
all-gather over a cut vocabulary (b, s, V) float32; with the vocabulary
whole and the stream cut, the chunk's logits all-gathered in the compute
dtype), twice inside every layer under remat (``common.remat``
recomputes each layer's forward, collectives included, in the
backward, and stops once the tensors it saved are back, so a layer's last
collective runs once), and each collective's adjoint once: an all-reduce
of ``copy_to`` for each of tensor parallelism's entries (its forward moves
nothing) and nothing for its row-cut all-reduce; for each gather along
the sequence a reduce-scatter and for each reduce-scatter along it an
all-gather, in the compute dtype; a float32 reduce-scatter for each
gather over cut columns (``gather_shards``), an all-gather for each
``scatter_to``; nothing for a ``gather_from`` (its adjoint is a slice).
Then the gradients: an all-reduce over "model" of each leaf that
sequence parallelism leaves as a rank's share
(``api.seq_partial_leaves``), over the data axes of each leaf the data
ranks share, and the grad norm's.  So a cut dense layer's backward moves
the adjoints of its two gathers and two reduce-scatters, ``4e·bsd·
(M-1)/M``, as much as tensor parallelism's two ``copy_to`` all-reduces;
with the forward run twice less its last collective, a cut bf16 dense
layer's train step moves 28 bsd·(M-1)/M bytes against 32.
"""
from __future__ import annotations

import math

import torch

from repro_torch import shardctx
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh, axis_size, data_axes
from repro_torch.models import api, layers, ssm
from repro_torch.models.common import ModelConfig, tensor_leaves


def _fake_mesh(mesh_shape: dict, model_index: int) -> Mesh:
    """The mesh of ``mesh_shape`` (axis name -> size, in mesh order) as the
    rank with index ``model_index`` on the model axis sees it, with no
    process group: what the rules read."""
    return Mesh(axis_names=tuple(mesh_shape), shape=dict(mesh_shape), rank=0,
                coords={a: model_index if a == "model" else 0 for a in mesh_shape},
                device=torch.device("meta"), backend="")


class _Plan:
    """{kind: (count, a rank's ring bytes)} as ``shardctx`` records them,
    with the rules' answers that the model code asks for.  With ``train``
    each autograd pair also records its adjoint, and the forward's
    collectives count ``times`` over (2 inside a layer under remat)."""

    def __init__(self, cfg: ModelConfig, mesh: Mesh, batch: int, train: bool = False):
        self.cfg, self.m, self.out, self.train = cfg, mesh.size("model"), {}, train
        self.times, self.last = 1, None
        spec = sharding.batch_pspec((batch,), mesh)
        self.b = batch // (axis_size(mesh, spec[0]) if spec[0] is not None else 1)
        self.e = torch.empty((), dtype=cfg.cdt).element_size()

    def add(self, kind: str, nbytes: float, n: int | None = None, times: int = 1) -> None:
        n = self.m if n is None else n
        if n > 1:
            count, total = self.out.get(kind, (0, 0.0))
            self.out[kind] = (count + times, total + times * (
                2.0 if kind == "all-reduce" else 1.0) * nbytes * (n - 1) / n)

    def fwd(self, kind: str, nbytes: float, n: int | None = None) -> None:
        self.add(kind, nbytes, n, self.times)
        self.last = (kind, nbytes, n)

    def remat(self, on: bool) -> None:
        """Start a segment of the forward that activation checkpointing
        runs twice (``on``), or once."""
        self.times, self.last = (2 if on else 1), None

    def end_remat(self) -> None:
        """End a rerun segment whose last collective no saved tensor needs:
        torch's checkpoint stops its recompute once the saved tensors are
        back, so that collective runs once."""
        if self.times == 2 and self.last is not None:
            self.add(*self.last, times=-1)
        self.times, self.last = 1, None

    def adj(self, kind: str, nbytes: float) -> None:
        if self.train:
            self.add(kind, nbytes)

    # the autograd pairs of ``shardctx``, by the bytes each side moves
    def copy_to(self, grad_bytes: float) -> None:
        self.adj("all-reduce", grad_bytes)

    def gather_from(self, nbytes: float) -> None:
        self.fwd("all-gather", nbytes)

    def gather_shards(self, nbytes: float, grad_bytes: float) -> None:
        self.fwd("all-gather", nbytes)
        self.adj("reduce-scatter", grad_bytes)

    def scatter_to(self, grad_bytes: float) -> None:
        self.adj("all-gather", grad_bytes)

    def columns(self, n: int, partial: bool, size: int | None = None) -> None:
        """``n`` elements of cut columns (``size`` bytes each, the compute
        dtype's by default) gathered whole: ``gather_from``, or with a
        gradient that is a rank's share, ``gather_shards`` (its adjoint a
        float32 reduce-scatter)."""
        nbytes = n * (size or self.e)
        if partial:
            self.gather_shards(nbytes, n * 4)
        else:
            self.gather_from(nbytes)

    def cut(self, keys, shape) -> bool:
        return sharding.model_cut(tuple(keys), tuple(shape)) is not None

    def inside(self, key: str, width: int) -> bool:
        span = sharding.head_span((key, "w"), (self.cfg.d_model, width),
                                  self.cfg.resolved_head_dim)
        return span is not None and not span[2]

    def projections(self, keys, tokens: int) -> None:
        """The q, k or v projections ``keys`` of ``tokens`` a row whose
        columns the rules cut inside a head: each output gathered."""
        width = {"wq": self.cfg.q_dim, "wk": self.cfg.kv_dim, "wv": self.cfg.kv_dim}
        for key in keys:
            if self.inside(key, width[key]):
                n = self.b * tokens * width[key]
                self.gather_shards(n * self.e, n * 4)

    def row(self, key: str, full_in: int, tokens: int, cut_seq: bool = False) -> None:
        """A row-cut product's float32 (b, tokens, d) partial sums."""
        if self.cut((key, "w"), (full_in, self.cfg.d_model)):
            self.partial_sums(tokens, cut_seq)

    def partial_sums(self, tokens: int, cut_seq: bool) -> None:
        """Float32 (b, tokens, d) partial sums: all-reduced (``reduce_from``),
        or under a cut stream reduce-scattered (its adjoint an all-gather
        in the compute dtype)."""
        n = self.b * tokens * self.cfg.d_model
        if cut_seq:
            self.fwd("reduce-scatter", n * 4)
            self.adj("all-gather", n * self.e)
        else:
            self.fwd("all-reduce", n * 4)

    def enter(self, tokens: int, cut_seq: bool) -> None:
        """A block's normed (b, tokens, d) input: ``copy_to``, or gathered
        along a cut sequence (``seq_gather``, its adjoint a reduce-scatter
        in the compute dtype)."""
        n = self.b * tokens * self.cfg.d_model * self.e
        if cut_seq:
            self.fwd("all-gather", n)
            self.adj("reduce-scatter", n)
        else:
            self.copy_to(n)


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
    mesh = _fake_mesh(mesh_shape, model_index)
    with shardctx.use_mesh(mesh):
        return _decode_step(cfg, mesh, batch, cache_len)


def _decode_step(cfg: ModelConfig, mesh: Mesh, batch: int, cache_len: int) -> dict:
    p = _Plan(cfg, mesh, batch)
    d, hd, heads, b, e = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, p.b, p.e
    abs_cache = api.init_cache(cfg, batch, cache_len, device="meta")
    seq = sharding.seq_cuts(abs_cache, sharding.cache_pspecs(abs_cache, cfg, mesh, batch=batch))

    def attention(name: str, project_kv: bool) -> None:
        p.projections(("wq", "wk", "wv") if project_kv else ("wq",), 1)
        axes = seq.get(name, ())
        n = axis_size(mesh, axes) if axes else 1
        if "model" in axes and p.cut(("wq", "w"), (d, cfg.q_dim)) \
                and not p.inside("wq", cfg.q_dim):
            p.add("all-gather", b * heads * hd * e)
        lo, hi = layers.out_heads(cfg)
        h_att = heads if "model" in axes else hi - lo
        p.add("all-gather", n * b * h_att * 4, n)
        p.add("all-reduce", b * h_att * hd * 4, n)
        p.row("wo", cfg.q_dim, 1)

    vocab_keys = (("embedding",), (cfg.vocab_size, d))
    if p.cut(*vocab_keys):
        p.partial_sums(1, False)
    if cfg.family == "ssm":
        for _ in range(cfg.num_layers):
            for name in ("shift_t", "shift_c"):
                if sharding.model_cut((name,), (1, 1, d), cache=True) is not None:
                    p.add("all-gather", b * d * e)
            if p.cut(("mix_w1",), (d, len(ssm.MIX_KEYS), cfg.rwkv_mix_lora)):
                p.add("all-gather", len(ssm.MIX_KEYS) * b * cfg.rwkv_mix_lora * e)
            p.row("wo", d, 1)
            if p.cut(("wk", "w"), (d, cfg.d_ff)):
                p.add("all-gather", b * cfg.d_ff * e)
            if p.cut(("wv", "w"), (cfg.d_ff, d)):
                p.add("all-gather", b * d * e)
    elif cfg.family == "audio":
        for _ in range(cfg.num_layers):
            attention("k", True)
            attention("xk", False)
            p.row("wo", cfg.d_ff, 1)
    else:
        for kind in cfg.full_pattern():
            if kind == "rglru":
                if p.cut(("w_in", "w"), (d, 2 * d)):
                    p.add("all-gather", b * 2 * d * e)
                if p.cut(("conv_w",), (cfg.rglru_conv_width, d)):
                    p.add("all-gather", b * d * 4)
                p.row("w_out", d, 1)
            else:
                attention("k", True)
            if not cfg.is_moe:
                p.row("wd", cfg.d_ff, 1)
            elif p.cut(("moe", "wi"), (cfg.num_experts, d, cfg.d_ff)):
                p.partial_sums(1, False)
    unembed = vocab_keys if cfg.tie_embeddings else (("unembed", "w"), (d, cfg.vocab_size))
    if p.cut(*unembed):
        p.add("all-gather", b * cfg.vocab_size * 4)
    return p.out


def prefill(cfg: ModelConfig, mesh_shape: dict, *, batch: int, seq: int,
            seq_parallel: bool = False, model_index: int = 0) -> dict:
    """{kind: (count, bytes)} of one prefill of ``cfg`` at ``batch`` rows
    (the whole request's) of ``seq`` positions (the audio family's frames
    ``cfg.encoder_seq``) on the rank with index ``model_index`` on the
    model axis of a mesh of ``mesh_shape``, with the weights cut by the
    rules (``param_pspecs``, no FSDP), with or without sequence
    parallelism: the forward pass the prefill runs (the module docstring)."""
    return _plan(cfg, mesh_shape, batch, seq, seq_parallel, model_index, train=False)


def train_step(cfg: ModelConfig, mesh_shape: dict, *, batch: int, seq: int,
               seq_parallel: bool = False, remat: bool = True, fsdp: bool = False,
               model_index: int = 0) -> dict:
    """{kind: (count, bytes)} of one train step's forward and backward of
    ``cfg`` at ``batch`` rows of ``seq`` tokens on a mesh of ``mesh_shape``
    (the weights cut by the rules, with ``fsdp`` also over "data"), one
    microbatch, with the sums over "model" of the gradients that sequence
    parallelism leaves as a rank's share (the module docstring).  On top
    of it the step runs what the flag leaves alone: FSDP's gathers and
    their reduce-scatters, the gradients' and the metrics' means over the
    data axes, the grad norm's all-reduce."""
    return _plan(cfg, mesh_shape, batch, seq, seq_parallel, model_index, train=True,
                 remat=remat, fsdp=fsdp)


def _plan(cfg, mesh_shape, batch, seq, seq_parallel, model_index, *, train: bool,
          remat: bool = False, fsdp: bool = False) -> dict:
    if cfg.family not in ("dense", "moe", "vlm", "hybrid", "audio", "ssm"):
        raise ValueError(f"{cfg.name}: no plan for the {cfg.family} family")
    mesh = _fake_mesh(mesh_shape, model_index)
    with shardctx.use_mesh(mesh, seq_parallel=seq_parallel):
        p = _Plan(cfg, mesh, batch, train)
        _forward(p, cfg, mesh, batch, seq, remat)
        if train:
            _gradient_sums(p, cfg, mesh, batch, seq, fsdp)
    return p.out


def _forward(p: _Plan, cfg: ModelConfig, mesh: Mesh, batch: int, s: int, remat: bool) -> None:
    """The model's collectives over ``s`` positions: a prefill's (the last
    positions unembedded), or with ``p.train`` the train forward's and
    their adjoints."""
    d, b, e, train = cfg.d_model, p.b, p.e, p.train
    cut = shardctx.seq_cut(torch.empty((batch, s), device="meta"), 1)
    bsd = b * s * d
    vocab_keys = (("embedding",), (cfg.vocab_size, d))
    vocab_cut = p.cut(*vocab_keys)
    if vocab_cut:
        p.partial_sums(s, cut and cfg.family != "vlm")
    if cut and (cfg.family == "vlm" or not vocab_cut):    # whole embeddings, cut
        p.scatter_to(bsd * e)

    def attention(tokens: int, cut_seq: bool) -> None:
        p.enter(tokens, cut_seq)
        p.projections(("wq", "wk", "wv"), tokens)
        p.row("wo", cfg.q_dim, tokens, cut_seq)

    dax = data_axes(mesh)
    if cfg.family == "ssm":
        for _ in range(cfg.num_layers):
            p.remat(remat)
            for name in ("shift_t", "shift_c"):     # the state's shifts (a train step's are 0)
                if not train and sharding.model_cut((name,), (1, 1, d), cache=True) is not None:
                    p.fwd("all-gather", b * d * e)
            if cut:                                           # the time mix
                p.enter(s, cut)
            lora = len(ssm.MIX_KEYS) * b * s * cfg.rwkv_mix_lora
            if p.cut(("mix_w1",), (d, len(ssm.MIX_KEYS), cfg.rwkv_mix_lora)):
                if not cut:
                    p.copy_to(bsd * e)
                p.columns(lora, cut)
            if not cut:
                for _ in ("wr", "wk", "wv", "wg"):
                    p.copy_to(bsd * e)
                if p.cut(("wr", "w"), (d, d)):       # the decay and the group norm
                    for n in (bsd, d, d):
                        p.copy_to(n * 4)
            p.row("wo", d, s, cut)
            if cut:                                           # the channel mix
                p.enter(s, cut)
            bsf = b * s * cfg.d_ff
            if not cut:
                p.copy_to(bsd * e)                            # xk
            if p.cut(("wk", "w"), (d, cfg.d_ff)):
                p.columns(bsf, cut)
            if not cut:
                p.copy_to(bsf * e)                            # k
                p.copy_to(bsd * e)                            # xr
            if p.cut(("wv", "w"), (cfg.d_ff, d)):
                p.columns(bsd, cut)
            p.end_remat()
    elif cfg.family == "audio":
        se = cfg.encoder_seq
        enc = shardctx.seq_cut(torch.empty((batch, se), device="meta"), 1)
        for _ in range(cfg.encoder_layers):
            attention(se, enc)
            p.enter(se, enc)
            p.row("wo", cfg.d_ff, se, enc)
        p.enter(se, enc)                                      # the encoder's output
        for _ in range(cfg.num_layers):
            attention(s, cut)
            p.enter(s, cut)                                   # the cross-attention
            p.projections(("wq",), s)
            p.projections(("wk", "wv"), se)
            p.row("wo", cfg.q_dim, s, cut)
            p.enter(s, cut)
            p.row("wo", cfg.d_ff, s, cut)
    else:
        pattern = cfg.full_pattern()
        # the remat segments: each layer, or each of the hybrid's pattern units
        unit = len(cfg.pattern) or 1
        units = (cfg.num_layers // unit) * unit
        for i, kind in enumerate(pattern):
            if i % unit == 0:
                p.remat(remat and i < units)
            if kind == "rglru":
                p.enter(s, cut)
                channels = p.cut(("conv_w",), (cfg.rglru_conv_width, d))
                if p.cut(("w_in", "w"), (d, 2 * d)):
                    p.columns(2 * bsd, cut or channels)
                if channels:                                  # the gates' input and output
                    p.columns(bsd, cut, 4)
                    if not cut:
                        p.scatter_to(bsd * 4)
                        p.scatter_to(bsd * 4)
                p.row("w_out", d, s, cut)
            else:
                attention(s, cut)
            p.enter(s, cut)
            if not cfg.is_moe:
                p.row("wd", cfg.d_ff, s, cut)
            else:
                if p.cut(("moe", "wi"), (cfg.num_experts, d, cfg.d_ff)):
                    if not cut:                               # the gates, copy_to
                        p.copy_to(b * s * cfg.num_experts_per_tok * 4)
                    p.partial_sums(s, cut)
                if train:                                     # the load-balance counts
                    p.fwd("all-reduce", cfg.num_experts * 4, mesh.size(dax))
            if i % unit == unit - 1 and not cfg.is_moe:     # the MoE loss's ops follow
                p.end_remat()
        p.remat(False)
    unembed = vocab_keys if cfg.tie_embeddings else (("unembed", "w"), (d, cfg.vocab_size))
    out_cut = p.cut(*unembed)
    if not train:
        if cut:                                               # the stream, for the last
            p.enter(s, cut)
        if out_cut:
            p.fwd("all-gather", b * cfg.vocab_size * 4)
        return
    if out_cut:
        p.enter(s, cut)
        p.fwd("all-gather", b * s * cfg.vocab_size * 4)
    elif cut:                                                 # the stream, whole
        p.gather_from(bsd * e)


def _gradient_sums(p: _Plan, cfg: ModelConfig, mesh: Mesh, batch: int, s: int,
                   fsdp: bool) -> None:
    """An all-reduce over "model" of the rank's shard of each leaf's
    gradient (its param dtype) that the cut stream leaves as a rank's share
    and the rules leave whole on the model axis."""
    params = api.abstract_params(cfg)
    specs = sharding.spec_leaves(sharding.param_pspecs(params, cfg, mesh, fsdp=fsdp))
    rows = {"tokens": torch.empty((batch, s), device="meta")}
    if cfg.family == "audio":
        rows["frame_embeds"] = torch.empty((batch, cfg.encoder_seq), device="meta")
    for leaf, spec, share in zip(tensor_leaves(params), specs,
                                 api.seq_partial_leaves(cfg, params, rows)):
        if share and not any("model" in axes for _, axes in sharding.spec_cuts(spec)):
            p.add("all-reduce", math.prod(sharding.local_shape(tuple(leaf.shape), spec, mesh))
                  * leaf.element_size())
