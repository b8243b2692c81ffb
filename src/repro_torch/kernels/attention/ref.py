"""Plain PyTorch version of the flash prefill kernel (K1)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import causal_window_mask, sdpa


def flash_attention_ref(q, k, v, *, window: int = 0):
    """q: (B,S,H,hd); k,v: (B,S,K,hd).  Causal (+window) attention."""
    pos = torch.arange(q.shape[1], device=q.device)
    return sdpa(q, k, v, causal_window_mask(pos, pos, window))
