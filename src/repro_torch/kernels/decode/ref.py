"""Plain PyTorch version of the flash-decode kernel (K2)."""
from __future__ import annotations

from repro_torch.models.layers import sdpa


def flash_decode_ref(q, cache_k, cache_v, valid, *, return_lse: bool = False):
    """q: (B,1,H,hd); cache: (B,S,K,hd); valid: (S,) bool shared by every
    row, or (B,S) bool per row.  -> o, or (o, lse (B,H) float32) with
    ``return_lse``: each row's natural log-sum-exp of its logits, -inf for
    a row with no valid position."""
    mask = valid[None, None, :] if valid.dim() == 1 else valid[:, None, :]
    if not return_lse:
        return sdpa(q, cache_k, cache_v, mask)
    o, lse = sdpa(q, cache_k, cache_v, mask, return_lse=True)
    return o, lse[:, 0]
