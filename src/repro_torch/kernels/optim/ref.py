"""Plain PyTorch versions of K4 (``grad_sumsq``) and K5 (``adamw_update``),
the eager AdamW of ``train/optimizer.py`` as it ran leaf by leaf before the
kernels: the CPU's path, and what ``chip_smoke.py`` holds the kernels to on
the card.

The update runs in place, one leaf at a time, so its float32 temporaries,
at most three of the largest leaf's size, are its peak beyond the moments.
"""
from __future__ import annotations

import torch


def grad_sumsq_ref(grads) -> torch.Tensor:
    """The float32 sum over every leaf of its float32 sum of squares: the
    reference's ``global_norm`` before the sqrt."""
    return sum(g.float().square().sum() for g in grads)


def adamw_update_ref(params, grads, mu, nu, scalars: torch.Tensor, *, b1: float, b2: float,
                     eps: float, weight_decay: float) -> None:
    """One AdamW step over the leaves, in place on ``params``, ``mu`` and
    ``nu`` (lists in one leaf order); ``scalars``: the float32 (4,) of the
    clip scale, lr, b1c and b2c."""
    scale, lr, b1c, b2c = scalars.unbind()
    for p, g, m, v in zip(params, grads, mu, nu):
        # the reference's order, each product and sum its own operation
        g32 = g.float() * scale
        t = torch.mul(g32, 1.0 - b1)
        m.mul_(b1).add_(t)
        v.mul_(b2).add_(torch.mul(g32, 1.0 - b2, out=t).mul_(g32))
        denom = torch.div(v, b2c).sqrt_().add_(eps)
        delta = torch.div(m, b1c, out=g32).div_(denom)
        p32 = denom.copy_(p)
        delta.add_(torch.mul(p32, weight_decay, out=t))
        p.copy_(p32.sub_(delta.mul_(lr)))
