"""Step-function builders: the port's counterparts of the reference's
``repro/launch/steps.py``.  A step built here is the uncaptured function,
as the reference's is before its caller jits it: ``train/loop.py::train``
replays it as a CUDA graph (``serving/graphs.py::TrainGraph``), the
counterpart of the reference's ``jax.jit``.  The train step syncs nothing
with the host, so it can be captured.  The mesh arguments of the
reference's sharded steps are refused until the sharded paths are ported
(ROADMAP.md Queue 1, slice F)."""
from __future__ import annotations

import torch

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
    and ``aux`` 0, as in the reference."""
    if mesh is not None or param_pspecs is not None:
        raise NotImplementedError("make_train_step: a mesh needs the sharded paths, which "
                                  "the port has not yet (ROADMAP.md Queue 1, slice F)")

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


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, inputs):
        return api.prefill(params, inputs, cfg)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache, token, pos):
        return api.decode_step(params, cache, token, pos, cfg)
    return serve_step
