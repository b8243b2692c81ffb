"""Step-function builders: the port's counterparts of the reference's
``repro/launch/steps.py``.  A step built here is the uncaptured function,
as the reference's is before its caller jits it: ``train/loop.py::train``
replays it as a CUDA graph (``serving/graphs.py::TrainGraph``), the
counterpart of the reference's ``jax.jit``.  The train step syncs nothing
with the host, so it can be captured.

With a ``mesh`` the step runs on a rank's local shards (its params cut by
``param_pspecs``, its moments like them, its rows of the batch) inside the
ambient mesh (``repro_torch.shardctx``), uncaptured: the model's
tensor-parallel collectives on the ``model`` axis, each leaf that FSDP
specs cut over "data" all-gathered for the step (its gradient
reduce-scattered back), the other leaves' gradients all-reduced over the
data axes, the data ranks' mean taken; the loss is the data ranks' mean.
The float32 accumulators of ``num_micro`` > 1 are the local shards' own,
so they are cut like the params.

The serving steps take a mesh too (``make_prefill_step``,
``make_serve_step``): the rank's shards of the params and the cache, FSDP's
leaves gathered over the data axes before the step, and weights that no
spec cuts over "model" (the reference's replicated small-model prefill) run
under ``sharding.replicated``'s view of the mesh."""
from __future__ import annotations

import torch

from repro_torch import shardctx
from repro_torch.launch import sharding
from repro_torch.launch.mesh import data_axes
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, tensor_leaves
from repro_torch.train.optimizer import AdamW


def choose_microbatch(cfg: ModelConfig, global_batch: int, seq: int,
                      dp_size: int, target_bytes: float = 4e9) -> int:
    """Gradient-accumulation split so the per-device footprint of (a) the
    scan-carry activations (local_micro * S * d * 2B * L) and (b) the fp32
    logits+softmax buffers (local_micro * S * V * 4B * ~3) stays under
    ``target_bytes`` — (b) dominates for small-d/large-V models (whisper)."""
    local_b = max(global_batch // max(dp_size, 1), 1)
    act = local_b * seq * cfg.d_model * 2 * max(cfg.num_layers, 1)
    logits = local_b * seq * max(cfg.vocab_size, 1) * 4 * 3
    need = max(act, logits)
    n = 1
    while need / n > target_bytes and n < local_b:
        n *= 2
    return n


def make_train_step(cfg: ModelConfig, opt: AdamW, *, num_micro: int = 1,
                    mesh=None, param_pspecs=None):
    """One optimizer step, ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``, the params, the moments and the step count
    updated in place, the metrics device tensors.  ``batch``: tensors on the
    params' device.  With ``num_micro`` > 1 the batch is split into
    that many microbatches, whose gradients accumulate in float32 and are
    divided by ``num_micro``; the metrics are then ``xent`` the mean loss
    and ``aux`` 0, as in the reference.  ``mesh``: the rank's
    ``launch.mesh.Mesh``; ``param_pspecs`` (default: the rules' specs,
    no FSDP) the specs the params were cut by."""
    if mesh is None and param_pspecs is not None:
        raise ValueError("make_train_step: param_pspecs without a mesh")
    if mesh is not None:
        return _sharded_train_step(cfg, opt, num_micro, mesh, param_pspecs)

    def grads_of(leaves, params, batch):
        loss, metrics = api.train_loss(params, batch, cfg)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch):
        leaves = [p.requires_grad_() for p in tensor_leaves(params)]
        if num_micro == 1:
            loss, metrics, grads = grads_of(leaves, params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), device=leaves[0].device)
            micro = {k: v.reshape(num_micro, v.shape[0] // num_micro, *v.shape[1:])
                     for k, v in batch.items()}
            for i in range(num_micro):
                mloss, _, g = grads_of(leaves, params, {k: v[i] for k, v in micro.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                loss = loss + mloss.detach()
            grads = [g.div_(num_micro) for g in grads]
            loss = loss / num_micro
            metrics = {"xent": loss, "aux": torch.zeros((), device=loss.device)}
        params, opt_state, om = opt.update(params, grads, opt_state)
        return params, opt_state, {**metrics, **om, "loss": loss.detach()}

    return train_step


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in order, by ``leaves`` (an
    iterator)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves) if isinstance(tree, torch.Tensor) else tree


def _sharded_train_step(cfg: ModelConfig, opt: AdamW, num_micro: int, mesh, pspecs):
    if pspecs is None:
        pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
    specs = sharding.spec_leaves(pspecs)
    dax = data_axes(mesh)
    ranks = mesh.size(dax)
    cuts = [list(sharding.spec_cuts(spec)) for spec in specs]
    # per leaf: the axes that cut it (for the norm), its dims cut over data
    # axes (FSDP: gathered for the step), the data axes that do not cut it
    # (its gradient all-reduced over them)
    shards = [tuple(a for _, axes in c for a in axes) for c in cuts]
    fsdp = [sharding.fsdp_cuts(spec, mesh) for spec in specs]
    over = [tuple(a for a in dax if a not in cut) for cut in shards]

    def grads_of(leaves, params, batch):
        full = _rebuild(params, iter([sharding.gather_fsdp(p, g) for p, g in zip(leaves, fsdp)]))
        loss, metrics = api.train_loss(full, batch, cfg)
        return loss, metrics, torch.autograd.grad(loss, leaves)

    def mean(x, axes=dax):
        return shardctx.all_reduce(x.detach().float(), axes) / ranks if ranks > 1 else x

    def train_step(params, opt_state, batch):
        with shardctx.use_mesh(mesh):
            leaves = [p.requires_grad_() for p in tensor_leaves(params)]
            if num_micro == 1:
                loss, metrics, grads = grads_of(leaves, params, batch)
                metrics = {k: mean(v) for k, v in metrics.items()}
            else:
                grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                loss = torch.zeros((), device=leaves[0].device)
                micro = {k: v.reshape(num_micro, v.shape[0] // num_micro, *v.shape[1:])
                         for k, v in batch.items()}
                for i in range(num_micro):
                    mloss, _, g = grads_of(leaves, params, {k: v[i] for k, v in micro.items()})
                    for acc, gi in zip(grads, g):
                        acc.add_(gi.float())
                    loss = loss + mloss.detach()
                grads = [g.div_(num_micro) for g in grads]
                loss = loss / num_micro
                metrics = {"xent": mean(loss), "aux": torch.zeros((), device=loss.device)}
            # the data ranks' mean gradient: summed by the FSDP gathers'
            # reduce-scatters over the axes that cut a leaf, by an all-reduce
            # over the others
            grads = [mean(g, axes) for g, axes in zip(grads, over)]
            params, opt_state, om = opt.update(params, grads, opt_state, shards=shards)
            return params, opt_state, {**metrics, **om, "loss": mean(loss)}

    return train_step


def _serving_mesh(mesh, param_pspecs, cache_pspecs):
    """(the mesh the step runs under, per leaf its FSDP cuts) of a serving
    step on ``mesh`` whose weights ``param_pspecs`` and cache
    ``cache_pspecs`` lay out; (None, None) without a mesh."""
    if mesh is None:
        if param_pspecs is not None or cache_pspecs is not None:
            raise ValueError("a serving step: specs without a mesh")
        return None, None
    if param_pspecs is None or cache_pspecs is None:
        raise ValueError("a serving step on a mesh needs the param_pspecs and the "
                         "cache_pspecs its weights and cache were cut by")
    fsdp = [sharding.fsdp_cuts(spec, mesh) for spec in sharding.spec_leaves(param_pspecs)]
    return sharding.step_mesh(mesh, param_pspecs), fsdp


def _whole_params(params, fsdp):
    """The params with every FSDP-cut leaf gathered over its data axes (all
    of them before the step, as the train step gathers them)."""
    if not any(fsdp):
        return params
    leaves = tensor_leaves(params)
    return _rebuild(params, iter([sharding.gather_fsdp(p, c) for p, c in zip(leaves, fsdp)]))


def make_prefill_step(cfg: ModelConfig, *, mesh=None, param_pspecs=None, cache_pspecs=None):
    """``prefill_step(params, inputs, cache=None) -> (last logits, cache)``,
    a given ``cache`` written in place (``api.prefill``).  With a ``mesh``:
    ``params`` are the rank's shards under ``param_pspecs`` (FSDP-cut
    leaves gathered over the data axes for the step; weights that no spec
    cuts over "model" run as ``sharding.replicated`` says), ``inputs`` the
    rank's rows, and ``cache`` (required) the rank's shard of a cache of the
    prompt's length laid out by ``cache_pspecs`` (``sharding.cache_pspecs``
    of the whole cache, ``use_model=False`` for replicated weights; made by
    ``sharding.local_zeros``, as the engine makes its own)."""
    on, fsdp = _serving_mesh(mesh, param_pspecs, cache_pspecs)
    if on is None:
        def prefill_step(params, inputs, cache=None):
            return api.prefill(params, inputs, cfg, cache=cache)
        return prefill_step

    def prefill_step(params, inputs, cache=None):
        if cache is None:
            raise ValueError("a prefill step on a mesh writes the rank's shard of the "
                             "cache: pass it (sharding.local_zeros)")
        with shardctx.use_mesh(on), sharding.use_cache_layout(cache, cache_pspecs):
            return api.prefill(_whole_params(params, fsdp), inputs, cfg,
                               inputs["tokens"].shape[1], cache=cache)
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mesh=None, param_pspecs=None, cache_pspecs=None):
    """``serve_step(params, cache, token, pos) -> (logits, cache)``, the
    cache updated in place.  With a ``mesh``: the rank's shards of the
    params (``param_pspecs``, gathered as ``make_prefill_step`` says) and
    of the cache (``cache_pspecs``), its rows of ``token``."""
    on, fsdp = _serving_mesh(mesh, param_pspecs, cache_pspecs)
    if on is None:
        def serve_step(params, cache, token, pos):
            return api.decode_step(params, cache, token, pos, cfg)
        return serve_step

    def serve_step(params, cache, token, pos):
        with shardctx.use_mesh(on), sharding.use_cache_layout(cache, cache_pspecs):
            return api.decode_step(_whole_params(params, fsdp), cache, token, pos, cfg)
    return serve_step
