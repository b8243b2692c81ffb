"""Token sampling: greedy / temperature / top-k."""
from __future__ import annotations

import torch


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def sample_token(logits: torch.Tensor, temperature: float,
                 generator: torch.Generator | None = None, top_k: int = 0,
                 noise: torch.Tensor | None = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64.

    Sampling is an argmax over logits / temperature plus Gumbel noise, which
    is how ``jax.random.categorical`` samples; ``noise`` injects that noise
    (a test feeds the reference's), else it is drawn from ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    l = logits.float() / temperature
    if top_k:
        kth = torch.topk(l, top_k, dim=-1).values[:, -1:]
        l = torch.where(l < kth, float("-inf"), l)
    if noise is None:
        if generator is None:
            raise ValueError("sample_token: temperature > 0 needs a generator or noise")
        noise = gumbel(l.shape, generator, l.device)
    return torch.argmax(noise + l, dim=-1)
