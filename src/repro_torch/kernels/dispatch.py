"""Kernel dispatch: by device only.

A CUDA tensor launches the hand-written Hopper kernel (which raises on
anything it does not take); a CPU tensor takes the kernel's plain PyTorch
version.  There is no switch and no fallback: on the card the kernel is the
path.
"""
from __future__ import annotations

from repro_torch.kernels.attention import flash
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.decode.ref import flash_decode_ref


def flash_attention(q, k, v, *, window: int = 0):
    """Causal (+window) prefill attention; q (B,S,H,hd), k/v (B,S,K,hd)."""
    if q.is_cuda:
        return flash.flash_attention(q, k, v, window=window)
    return flash_attention_ref(q, k, v, window=window)


def flash_decode(q, cache_k, cache_v, valid):
    """One query per row against the cache; valid (S,) or (B,S) bool."""
    if q.is_cuda:
        return fd.flash_decode(q, cache_k, cache_v, valid)
    return flash_decode_ref(q, cache_k, cache_v, valid)
