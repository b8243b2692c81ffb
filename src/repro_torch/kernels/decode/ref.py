"""Plain PyTorch version of the flash-decode kernel (K2)."""
from __future__ import annotations

from repro_torch.models.layers import sdpa


def flash_decode_ref(q, cache_k, cache_v, valid):
    """q: (B,1,H,hd); cache: (B,S,K,hd); valid: (S,) bool shared by every
    row, or (B,S) bool per row."""
    mask = valid[None, None, :] if valid.dim() == 1 else valid[:, None, :]
    return sdpa(q, cache_k, cache_v, mask)
