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
so they are cut like the params."""
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
    fsdp = [[(dim, axes) for dim, axes in c if set(axes) <= set(dax)] for c in cuts]
    over = [tuple(a for a in dax if a not in cut) for cut in shards]

    def whole(p, gathers):
        for dim, axes in reversed(gathers):
            p = shardctx.gather_shards(p, axes, dim)
        return p

    def grads_of(leaves, params, batch):
        full = _rebuild(params, iter([whole(p, g) for p, g in zip(leaves, fsdp)]))
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


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, inputs):
        return api.prefill(params, inputs, cfg)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token, pos):
        return api.decode_step(params, cache, token, pos, cfg)
    return serve_step
