"""Parameter / activation partition rules for every family.

The reference's rules (``repro/launch/sharding.py``) on the port's trees:
Megatron-style tensor parallelism on the ``model`` axis, batch parallelism
on ``("pod", "data")``, path-based over the param tree, a dim sharded only
when it divides the axis size evenly.  The port's trees keep every leaf
name of the reference's, but a stack of layers is a list of per-layer
trees (``layers``, ``units``, ``enc_layers``, ``dec_layers``) where the
reference stacks them on a leading axis.  The rules index dims from the
end, so they read the same on an unstacked leaf; FSDP's rank test and its
"largest unsharded dim" are taken on the reference's stacked shape with the
layer axis left out of the candidates (a port leaf is one layer).  Caches
keep the reference's stacked layout, so ``cache_pspecs`` is the
reference's rule as it is.

A spec is a tuple with one entry per dim (trailing dims may be left out):
``None``, an axis name, or a tuple of axis names, as the entries of the
reference's ``PartitionSpec``; ``()`` is replicated.  A spec tree has the
param tree's structure with a spec at every tensor.  ``shard_tree`` cuts a
rank's local shards (the dim's ``index``-th equal chunk over its axes) and
``gather_tree`` puts whole tensors together again from them: the
counterparts of the reference's ``to_named`` placement.

MoE experts: expert-parallel over ``model`` when num_experts divides the axis
(qwen3: 128/16=8), otherwise tensor-parallel on the per-expert ffn dim
(granite: 40 experts -> shard d_ff=512 16-way).
"""
from __future__ import annotations

import dataclasses
import functools
from contextlib import contextmanager
from types import SimpleNamespace

import torch

from repro_torch import shardctx
from repro_torch.launch.mesh import axis_size, data_axes, model_axis
from repro_torch.models.common import ModelConfig

COL = {"wq", "wk", "wv", "wi", "wu", "wg", "wr", "w_in", "mix_w1"}
ROW = {"wo", "wd", "w_out"}
# the lists of the port's trees that the reference stacks on a leading axis
STACKED = {"layers", "units", "enc_layers", "dec_layers"}


def _div(n: int, size: int) -> bool:
    return size > 1 and n % size == 0


def _spec_for(keys: list, shape: tuple, cfg: ModelConfig, mesh) -> tuple:
    m = model_axis(mesh)
    msz = axis_size(mesh, m)
    if m is None or msz == 1:
        return ()
    # int8-quantized leaves ({"q": int8, "scale": f32} under the weight key):
    # the q tensor shards like the original weight; scales are tiny/replicated
    if len(keys) >= 2 and keys[-1] in ("q", "scale") and (
            keys[-2] in COL | ROW | {"wi", "wu", "wd", "embedding"}
            or (len(keys) >= 3 and keys[-2] == "w")):
        if keys[-1] == "scale":
            return ()
        keys = keys[:-1]
    name = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    gparent = keys[-3] if len(keys) >= 3 else ""

    def col(dim_idx: int) -> tuple:
        if _div(shape[dim_idx], msz):
            spec = [None] * len(shape)
            spec[dim_idx] = m
            return tuple(spec)
        return ()

    # embeddings
    if name == "embedding":
        return col(len(shape) - 2)  # (V, d) -> vocab sharded
    if parent == "unembed" and name == "w":
        return col(len(shape) - 1)
    if name == "dec_pos":
        return ()

    # MoE experts: (E, d, f) / (E, f, d)
    if parent == "moe" or gparent == "moe":
        if name == "router":
            return ()
        e_idx = len(shape) - 3
        if name in ("wi", "wu", "wd"):
            if _div(shape[e_idx], msz):
                spec = [None] * len(shape)
                spec[e_idx] = m
                return tuple(spec)   # expert-parallel
            if name in ("wi", "wu"):
                return col(len(shape) - 1)   # TP on ffn dim
            return col(len(shape) - 2)       # wd: (E, f, d) -> shard f
    if name == "router":
        return ()

    # generic matmul weights (dicts {"w": ..., "b": ...})
    if name == "w":
        if parent in COL:
            return col(len(shape) - 1)
        if parent in ROW:
            return col(len(shape) - 2)
        return ()
    if name == "b":
        if parent in COL:
            return col(len(shape) - 1)
        return ()

    # direct (non-dict) weights
    if name in ("wi", "wu") or name in COL:
        return col(len(shape) - 1)
    if name in ("wd",) or name in ROW:
        return col(len(shape) - 2)

    # rwkv / hybrid specifics
    if name == "u":                       # (H, hd)
        return col(len(shape) - 2)
    if name in ("conv_w",):               # (width, dr) -> last dim
        return col(len(shape) - 1)
    if name in ("conv_b", "lam"):
        return col(len(shape) - 1)
    if parent in ("wa", "wx") and name == "w":
        return col(len(shape) - 1)

    return ()  # norms, scalars, lora adapters, positions: replicated


def _add_fsdp(spec: tuple, shape: tuple, mesh, stacked: bool) -> tuple:
    """Shard the largest still-unsharded dim of a weight over "data" (ZeRO /
    FSDP: weights and moments sharded over the data axis, all-gathered for
    the step).  The reference's test is on its stacked leaf, so a per-layer
    leaf counts its layer axis toward the ">= 2D" rank; the layer axis is
    no candidate here.  Scalars and unstacked 1D leaves stay replicated."""
    if len(shape) + stacked < 2:
        return spec
    dsz = mesh.shape.get("data", 1)
    if dsz <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    cands = [i for i, e in enumerate(entries) if e is None and _div(shape[i], dsz)]
    if not cands:
        return spec
    best = max(cands, key=lambda i: shape[i])
    entries[best] = "data"
    return tuple(entries)


# ----------------------------------------------------------------------
# trees
# ----------------------------------------------------------------------

def _walk(tree, fn, keys=(), stacked=False):
    """``fn(keys, leaf, stacked)`` at every tensor (or spec) leaf of a tree
    of dicts and lists; ``None`` nodes stay ``None``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, keys + (str(k),), stacked) for k, v in tree.items()}
    if isinstance(tree, list):
        inner = stacked or (bool(keys) and keys[-1] in STACKED)
        return [_walk(v, fn, keys, inner) for v in tree]
    if tree is None:
        return None
    return fn(list(keys), tree, stacked)


def _zip(tree, specs, fn):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(v, s, fn) for v, s in zip(tree, specs)]
    if tree is None:
        return None
    return fn(tree, specs)


def spec_leaves(specs) -> list:
    """The specs of a spec tree in ``models.common.tensor_leaves`` order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [] if specs is None else [specs]


def param_pspecs(abs_params, cfg: ModelConfig, mesh, *, fsdp: bool = False):
    """The spec tree of a param tree (tensors or meta tensors, whole
    shapes: ``models.api.abstract_params``)."""
    def assign(keys, leaf, stacked):
        shape = tuple(leaf.shape)
        if shape == ():
            return ()
        spec = _spec_for(keys, shape, cfg, mesh)
        if fsdp:
            spec = _add_fsdp(spec, shape, mesh, stacked)
        return spec
    return _walk(abs_params, assign)


def replicated_pspecs(abs_params):
    """Every leaf whole on every rank: the reference's layout for a small
    model's prefill under a model axis (pure data parallelism; see
    ``replicated``)."""
    return _walk(abs_params, lambda keys, leaf, stacked: ())


def replicated(mesh):
    """The view of ``mesh`` that a step with replicated weights runs under:
    its model axis of size 1, this rank at index 0 on it, and each group
    over axes with "model" the group of the same axes without it.  Under
    it ``model_cut``, ``head_span`` and ``seq_cut`` answer "whole" and the
    model's collectives over "model" are the identity, so every model rank
    repeats the work of its data rank on whole weights (the rows stay cut
    over the data axes alone, as ``batch_pspec`` cuts them); the cache is
    then ``cache_pspecs(..., use_model=False)``."""
    if mesh.shape.get("model", 1) == 1:
        return mesh
    groups = {}
    for axes in mesh.groups:
        rest = tuple(a for a in axes if a != "model")
        if rest:
            groups[axes] = mesh.groups[rest]
    return dataclasses.replace(mesh, shape={**mesh.shape, "model": 1},
                               coords={**mesh.coords, "model": 0}, groups=groups)


def step_mesh(mesh, pspecs):
    """The mesh a step runs under whose weights ``pspecs`` lay out: the
    mesh itself where they cut some leaf over the model axis (then the
    rules' cuts, which the model code asks for), else ``replicated(mesh)``."""
    cut = any("model" in axes for spec in spec_leaves(pspecs) for _, axes in spec_cuts(spec))
    return mesh if cut else replicated(mesh)


def fsdp_cuts(spec: tuple, mesh) -> list:
    """(dim, axes) of each dim of ``spec`` cut over data axes alone: FSDP's
    cuts, which a step gathers whole before it uses the leaf."""
    dax = set(data_axes(mesh))
    return [(dim, axes) for dim, axes in spec_cuts(spec) if set(axes) <= dax]


def gather_fsdp(x: torch.Tensor, cuts: list) -> torch.Tensor:
    """``x`` gathered whole over its FSDP ``cuts`` (``fsdp_cuts``) on the
    ambient mesh: an all-gather each, a reduce-scatter of its gradient
    backward."""
    for dim, axes in reversed(cuts):
        x = shardctx.gather_shards(x, axes, dim)
    return x


def opt_pspecs(abs_opt, param_specs) -> dict:
    """Optimizer moments shard exactly like their parameters.  The port's
    opt state is {"mu": [leaf], "nu": [leaf], "step": ()}, its lists in the
    params' leaf order."""
    flat = spec_leaves(param_specs)
    return {k: (list(flat) if k in ("mu", "nu") else ()) for k in abs_opt}


# ----------------------------------------------------------------------
# activations / inputs
# ----------------------------------------------------------------------

def batch_pspec(shape: tuple, mesh, *, batch_dim: int = 0) -> tuple:
    """Shard the batch dim over ("pod","data") when divisible, else replicate."""
    dax = data_axes(mesh)
    spec = [None] * len(shape)
    if dax and _div(shape[batch_dim], axis_size(mesh, dax)):
        spec[batch_dim] = dax if len(dax) > 1 else dax[0]
    return tuple(spec)


def input_pspecs(input_tree: dict, mesh) -> dict:
    """Specs for a dict of (token/label/embedding) inputs: batch-shard dim 0."""
    return {k: (batch_pspec(tuple(x.shape), mesh) if x.dim() else ())
            for k, x in input_tree.items()}


def _batch_dim(keys: list) -> int:
    """The batch dim of a cache leaf: stacked caches have B at idx 1 (after
    L/U), unstacked ("extra") states at idx 0.  The reference finds it from
    the shape (B at idx 1 when idx 0 is not B), which takes the layer axis
    for the batch when the batch equals the layer count; the port's layout
    is known."""
    return 0 if "extra" in keys else 1


def cache_pspecs(cache_tree, cfg: ModelConfig, mesh, *, batch: int, use_model: bool = True):
    """Decode cache sharding.  Batch shards over data axes when divisible;
    for batch=1 (long_500k) the long KV sequence dim shards over "data"
    instead, and head-like dims shard over "model" when divisible.  With
    ``use_model=False`` (the replicated-weights prefill, ``replicated``)
    the cache is replicated over the model axis too, matching the compute
    layout."""
    dax = data_axes(mesh)
    dsz = axis_size(mesh, dax)
    m = model_axis(mesh) if use_model else None
    msz = axis_size(mesh, m) if use_model else 1
    batch_ok = _div(batch, dsz)
    dspec = dax if len(dax) > 1 else (dax[0] if dax else None)

    def assign(keys, leaf, _stacked):
        shape = tuple(leaf.shape)
        name = keys[-1] if keys else ""
        spec = [None] * len(shape)
        b_idx = _batch_dim(keys)
        if shape and shape[b_idx] == batch and batch_ok:
            spec[b_idx] = dspec
        if name in ("k", "v", "xk", "xv") and len(shape) >= 4:
            s_idx = b_idx + 1
            h_idx = b_idx + 2
            heads_shardable = _div(shape[h_idx], msz)
            seq_axes = []
            if not (batch_ok and dsz > 1) and _div(shape[s_idx], dsz):
                seq_axes.extend(dax)                    # long-KV: seq over data
            if heads_shardable:
                spec[h_idx] = m                         # kv heads over model
            elif (m is not None and cfg.attention_window == 0
                  and _div(shape[s_idx],
                           msz * max(axis_size(mesh, tuple(seq_axes)), 1))):
                # GQA kv-heads don't divide the model axis: shard the KV
                # sequence dim over "model" instead (decode attention then
                # reduces over the sharded seq with partial-softmax
                # all-reduces); skipped for sliding-window caches.
                seq_axes.append(m)
            if seq_axes:
                spec[s_idx] = tuple(seq_axes) if len(seq_axes) > 1 else seq_axes[0]
        if name == "wkv" and len(shape) == 5:           # (L,B,H,hd,hd)
            if _div(shape[2], msz):
                spec[2] = m
        if name in ("shift_t", "shift_c", "lru") and _div(shape[-1], msz):
            spec[-1] = m
        if name == "conv" and _div(shape[-1], msz):
            spec[-1] = m
        return tuple(spec)

    return _walk(cache_tree, assign)


# ----------------------------------------------------------------------
# local shards
# ----------------------------------------------------------------------

def spec_cuts(spec: tuple):
    """(dim, axes) of every sharded dim of ``spec``."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            yield dim, ((entry,) if isinstance(entry, str) else tuple(entry))


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    out = list(shape)
    for dim, axes in spec_cuts(spec):
        out[dim] //= mesh.size(axes)
    return tuple(out)


def shard(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's local shard of the whole tensor ``x``, a new tensor on
    the mesh's device."""
    for dim, axes in spec_cuts(spec):
        x = x.chunk(mesh.size(axes), dim)[mesh.index(axes)]
    return x.to(mesh.device).contiguous().clone()


def gather(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole tensor from every rank's local shard ``x`` (every rank of
    the mesh calls)."""
    with shardctx.use_mesh(mesh):
        for dim, axes in reversed(list(spec_cuts(spec))):
            x = shardctx.all_gather(x, axes, dim)
    return x


def shard_tree(tree, specs, mesh):
    return _zip(tree, specs, lambda x, s: shard(x, s, mesh))


def gather_tree(tree, specs, mesh):
    return _zip(tree, specs, lambda x, s: gather(x, s, mesh))


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of a batch of whole tensors (``input_pspecs``)."""
    return shard_tree(batch, input_pspecs(batch, mesh), mesh)


def local_zeros(abs_tree, specs, mesh):
    """Zeros of each leaf's local shape, dtype as the (meta) leaf's, on the
    mesh's device: a rank's cache."""
    return _zip(abs_tree, specs, lambda x, s: torch.zeros(
        local_shape(tuple(x.shape), s, mesh), dtype=x.dtype, device=mesh.device))


# ----------------------------------------------------------------------
# what the rules cut, for the model code
# ----------------------------------------------------------------------

def model_cut(keys: tuple, shape: tuple, *, cache: bool = False) -> int | None:
    """The dim of a whole leaf of ``shape`` that the rules cut over the
    model axis of the ambient mesh (``shardctx``), or None: no mesh, a
    model axis of 1, or a leaf they leave whole on it.  ``keys`` are the
    trailing names of the leaf's path in the param tree (``("wo", "w")``),
    or with ``cache`` in the cache tree (``("shift_t",)``).  The model code
    asks this wherever the layout decides what a rank holds, so that these
    rules alone decide it."""
    mesh = shardctx.get_mesh()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return _model_cut(tuple(keys), tuple(shape), tuple(mesh.axis_names),
                      tuple(mesh.shape.items()), cache)


@functools.lru_cache(maxsize=None)
def _model_cut(keys, shape, names, sizes, cache):
    mesh = SimpleNamespace(axis_names=names, shape=dict(sizes))
    if cache:
        tree = torch.empty(shape, device="meta")
        for k in reversed(keys):
            tree = {k: tree}
        spec = spec_leaves(cache_pspecs(tree, None, mesh, batch=-1))[0]
    else:
        spec = _spec_for(list(keys), shape, None, mesh)
    return next((dim for dim, axes in spec_cuts(spec) if "model" in axes), None)


def model_span(keys: tuple, shape: tuple) -> tuple[int, int] | None:
    """[start, stop) of the dim ``model_cut`` names that this rank holds
    (its equal chunk over the model axis of the ambient mesh), or None
    where the rules leave the leaf whole on it."""
    dim = model_cut(keys, shape)
    if dim is None:
        return None
    n = shape[dim] // shardctx.size("model")
    i = shardctx.index("model")
    return i * n, (i + 1) * n


def head_span(keys: tuple, shape: tuple, head_dim: int) -> tuple[int, int, bool] | None:
    """The heads of ``head_dim`` entries that this rank's chunk of the cut
    dim (``model_span``) touches, [first, stop), and whether the chunk
    holds exactly those heads whole; None where the rules leave the leaf
    whole.  The rules cut a projection's columns whenever its width divides
    the model axis, so a chunk may start or end inside a head."""
    span = model_span(keys, shape)
    if span is None:
        return None
    lo, hi = span
    return lo // head_dim, -(-hi // head_dim), lo % head_dim == 0 and hi % head_dim == 0


# ----------------------------------------------------------------------
# what the rules cut of a cache's sequence, for the model code
# ----------------------------------------------------------------------

SEQ_LEAVES = ("k", "v", "xk", "xv")


def seq_cuts(abs_cache, specs) -> dict:
    """{leaf name: the axes (a tuple, () for none) that ``specs``
    (``cache_pspecs`` of ``abs_cache``) cut the sequence dim of the
    attention leaves ``k``, ``v``, ``xk``, ``xv`` over}.  Every leaf of one
    name must be cut alike (the hybrid family's ring buffers are)."""
    def look(keys, leaf, _stacked):
        return (keys[-1] if keys else "", _batch_dim(keys) + 1)
    cuts = {}
    for (name, s_idx), spec in zip(spec_leaves(_walk(abs_cache, look)), spec_leaves(specs)):
        if name not in SEQ_LEAVES:
            continue
        entry = spec[s_idx] if len(spec) > s_idx else None
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        if cuts.setdefault(name, axes) != axes:
            raise ValueError(f"cache leaves named {name!r} cut their sequence over both "
                             f"{cuts[name]} and {axes}")
    return cuts


@contextmanager
def use_cache_layout(abs_cache, specs):
    """Make the sequence cuts of the cache that ``specs`` lay out
    (``cache_pspecs`` of the whole ``abs_cache``) ambient for the model
    code: ``seq_cut`` answers from them.  The entry points that cut a
    cache enter it with the mesh."""
    with shardctx.use_seq_cuts(seq_cuts(abs_cache, specs)):
        yield


def seq_cut(name: str) -> tuple:
    """The mesh axes that the ambient cache layout (``use_cache_layout``)
    cuts the sequence dim of the cache leaf ``name`` over: () when it is
    whole, without a mesh, or outside a layout.  A rank holds the
    ``shardctx.index(axes)``-th equal chunk of the positions."""
    if shardctx.get_mesh() is None:
        return ()
    return shardctx.get_seq_cuts().get(name, ())
