"""AdamW, the cosine schedule and the global gradient norm, as the
reference's ``repro/train/optimizer.py`` defines them, on the port's trees.

The moments are float32 whatever the param dtype, and the update runs in
place on the port's tensors (the reference builds new trees): one leaf at a
time, so its float32 temporaries, at most three of the largest leaf's size
(about 1.7 GB each for deepseek-7b's 102400 x 4096 embedding), are the
update's peak beyond the moments.  Nothing here waits for the device: the
clip scale stays a device tensor and the learning rate a host float.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.models.common import tensor_leaves


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable[[int], float]:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``, in float32 as the reference computes it."""
    def lr(step: int) -> float:
        f = torch.float32
        st = torch.tensor(step, dtype=f)
        if step < warmup:
            return float(base_lr * st / max(warmup, 1))
        prog = torch.clamp((st - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return float(base_lr * 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=f) * prog)))
    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(g.float().square().sum() for g in tensor_leaves(grads)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        """Zero float32 moments beside every leaf, and the step count."""
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in tensor_leaves(params)]
        return {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros], "step": 0}

    @torch.no_grad()
    def update(self, params, grads, state: dict):
        """One step over the leaves of ``params`` (updated in place, with the
        moments of ``state``) from ``grads``, a tree or a list in the same
        leaf order.  -> (params, state, {"grad_norm": device tensor, "lr"})."""
        step = state["step"] + 1
        lr = (self.learning_rate(step) if callable(self.learning_rate)
              else float(self.learning_rate))
        flat_g = list(tensor_leaves(grads))
        gnorm = global_norm(flat_g)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        b1c = 1.0 - float(torch.tensor(self.b1) ** step)
        b2c = 1.0 - float(torch.tensor(self.b2) ** step)
        for p, g, mu, nu in zip(tensor_leaves(params), flat_g, state["mu"], state["nu"]):
            g32 = g.float() * scale
            mu.mul_(self.b1).add_(g32, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g32.mul_(g32), alpha=1.0 - self.b2)
            denom = torch.div(nu, b2c).sqrt_().add_(self.eps)
            delta = torch.div(mu, b1c, out=g32).div_(denom)
            p32 = denom.copy_(p)
            delta.add_(p32, alpha=self.weight_decay)
            p.copy_(p32.sub_(delta, alpha=lr))
        state["step"] = step
        return params, state, {"grad_norm": gnorm, "lr": lr}
