"""AdamW, the cosine schedule and the global gradient norm, as the
reference's ``repro/train/optimizer.py`` defines them, on the port's trees.

The moments are float32 whatever the param dtype, and the update runs in
place on the port's tensors (the reference builds new trees).  On the card
the gradient norm is one pass of K4 (``grad_sumsq``) and the update one
pass of K5 (``adamw_update``) over every leaf, the counterpart of XLA's
fusion of the reference's jitted update; on the CPU both run as the eager
leaf-by-leaf loop (``kernels/optim/ref.py``).  Dispatch is by device
(``kernels/dispatch.py``).

Under a mesh the params, gradients and moments are a rank's local shards
(the moments cut like their params, ``launch/sharding.py::opt_pspecs``):
K5 updates them in place, and K4's sum of squares becomes global, each
group of leaves cut over the same axes summed by one K4 launch and
all-reduced over those axes (a leaf replicated over an axis is counted
once, not once a rank).

Nothing here waits for the host, and nothing that changes from step to step
is a host number: the step count is a device int32 that the update
advances, and the learning rate, the bias corrections and the clip scale
are device tensors computed from it, as the reference computes them inside
its jit.  So a step captured into a CUDA graph (``serving/graphs.py::
TrainGraph``) replays with the current step's values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import shardctx
from repro_torch.kernels import dispatch
from repro_torch.models.common import tensor_leaves


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``: ``lr(step)`` from a step count (a device int
    tensor, or an int) to a float32 tensor on its device, computed as the
    reference computes it."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(grads, shards=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares.
    ``shards``: under a mesh, per leaf the tuple of mesh axes that cut it
    (``()`` for a replicated leaf): each group's local sum is all-reduced
    over its axes on the ambient mesh."""
    leaves = list(tensor_leaves(grads))
    if shards is None:
        return torch.sqrt(dispatch.grad_sumsq(leaves))
    groups: dict[tuple, list] = {}
    for g, axes in zip(leaves, shards):
        groups.setdefault(tuple(axes), []).append(g)
    return torch.sqrt(sum(shardctx.all_reduce(dispatch.grad_sumsq(gs), axes)
                          for axes, gs in groups.items()))


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        """Zero float32 moments beside every leaf, and the step count, a
        device int32 0."""
        leaves = list(tensor_leaves(params))
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        return {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros],
                "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device)}

    @torch.no_grad()
    def update(self, params, grads, state: dict, *, shards=None):
        """One step over the leaves of ``params`` (updated in place, with the
        moments of ``state``, and its step advanced in place) from
        ``grads``, a tree or a list in the same leaf order.  ``shards``:
        under a mesh, the axes that cut each leaf (``global_norm``).  ->
        (params, state, {"grad_norm", "lr"}: device tensors)."""
        step = state["step"].add_(1)
        flat_p, flat_g = list(tensor_leaves(params)), list(tensor_leaves(grads))
        dev = step.device
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else torch.full((), float(self.learning_rate), dtype=torch.float32, device=dev))
        gnorm = global_norm(flat_g, shards)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        stepf = step.to(torch.float32)
        b1c = 1.0 - self.b1 ** stepf
        b2c = 1.0 - self.b2 ** stepf
        scalars = torch.stack([scale, lr, b1c, b2c])
        dispatch.adamw_update(flat_p, flat_g, state["mu"], state["nu"], scalars, b1=self.b1,
                              b2=self.b2, eps=self.eps, weight_decay=self.weight_decay)
        return params, state, {"grad_norm": gnorm, "lr": lr}
