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
from repro_torch.kernels.rwkv import wkv
from repro_torch.kernels.rwkv.ref import wkv6_ref


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


def rwkv_scan(r, k, v, w, u, state, *, out_state=None):
    """The WKV-6 recurrence; r,k,v,w (B,T,H,hd) f32, u (H,hd), state
    (B,H,hd,hd).  -> (o, final state), the final state written into
    ``out_state`` when given (which may be ``state`` itself)."""
    if r.is_cuda:
        return wkv.wkv6(r, k, v, w, u, state, out_state=out_state)
    o, s = wkv6_ref(r, k, v, w, u, state)
    if out_state is not None:
        s = out_state.copy_(s)
    return o, s
