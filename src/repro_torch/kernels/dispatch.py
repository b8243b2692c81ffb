"""Kernel dispatch: by device only.

A CUDA tensor launches the hand-written Hopper kernel (which raises on
anything it does not take); a CPU tensor takes the kernel's plain PyTorch
version.  There is no switch and no fallback: on the card the kernel is the
path.

Where grad mode is on and an input requires grad, the prefill attention and
the WKV-6 scan go through ``torch.autograd.Function``s (``FlashAttention``,
``WKV6``) whose forward and backward dispatch the same way: on the card the
kernel and its backward kernel (K1 and K1-bwd, K3 and K3-bwd), on the CPU
both plain versions.  Otherwise (serving, ``torch.inference_mode``, a
CUDA-graph capture) they launch exactly the forward kernel, as before.

AdamW's two passes dispatch the same way, by the device of the leaves: on
the card K4 (``grad_sumsq``) and K5 (``adamw_update``), on the CPU the
eager leaf-by-leaf loop they replace (``kernels/optim/ref.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash, flash_bwd
from repro_torch.kernels.attention.ref import (flash_attention_bwd_ref,
                                               flash_attention_fwd_ref, flash_attention_ref)
from repro_torch.kernels.decode import flash_decode as fd
from repro_torch.kernels.decode.ref import flash_decode_ref
from repro_torch.kernels.optim import adamw
from repro_torch.kernels.optim.ref import adamw_update_ref, grad_sumsq_ref
from repro_torch.kernels.rwkv import wkv, wkv_bwd
from repro_torch.kernels.rwkv.ref import wkv6_bwd_ref, wkv6_ref


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, window: int = 0):
    """Causal (+window) prefill attention; q (B,S,H,hd), k/v (B,S,K,hd)."""
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, window)
    if q.is_cuda:
        return flash.flash_attention(q, k, v, window=window)
    return flash_attention_ref(q, k, v, window=window)


def flash_attention_fwd(q, k, v, *, window: int = 0):
    """-> (o, the float32 row log-sum-exp (B,H,S) that the backward takes)."""
    if q.is_cuda:
        return flash.flash_attention(q, k, v, window=window, with_lse=True)
    return flash_attention_fwd_ref(q, k, v, window=window)


def flash_attention_bwd(q, k, v, o, do, lse, *, window: int = 0):
    """-> (dq, dk, dv) of the causal (+window) attention."""
    if q.is_cuda:
        return flash_bwd.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    return flash_attention_bwd_ref(q, k, v, o, do, lse, window=window)


def flash_decode(q, cache_k, cache_v, valid, *, return_lse: bool = False):
    """One query per row against the cache; valid (S,) or (B,S) bool.  ->
    o, or (o, the float32 row log-sum-exp (B,H)) with ``return_lse``."""
    if q.is_cuda:
        return fd.flash_decode(q, cache_k, cache_v, valid, return_lse=return_lse)
    return flash_decode_ref(q, cache_k, cache_v, valid, return_lse=return_lse)


def rwkv_scan(r, k, v, w, u, state, *, out_state=None):
    """The WKV-6 recurrence; r,k,v,w (B,T,H,hd) f32, u (H,hd), state
    (B,H,hd,hd).  -> (o, final state), the final state written into
    ``out_state`` when given (which may be ``state`` itself).  Under
    autograd the state is never written in place: ``out_state`` is
    refused."""
    if _needs_grad(r, k, v, w, u, state):
        if out_state is not None:
            raise ValueError("rwkv_scan: out_state writes the state in place, which "
                             "autograd cannot differentiate; pass none when training")
        return WKV6.apply(r, k, v, w, u, state)
    if r.is_cuda:
        return wkv.wkv6(r, k, v, w, u, state, out_state=out_state)
    o, s = wkv6_ref(r, k, v, w, u, state)
    if out_state is not None:
        s = out_state.copy_(s)
    return o, s


def wkv6_bwd(r, k, v, w, u, s0, do, ds_t):
    """-> (dr, dk, dv, dw, du, ds0) of the WKV-6 recurrence."""
    if r.is_cuda:
        return wkv_bwd.wkv6_bwd(r, k, v, w, u, s0, do, ds_t)
    return wkv6_bwd_ref(r, k, v, w, u, s0, do, ds_t)


def grad_sumsq(grads) -> torch.Tensor:
    """The float32 sum of squares over every leaf of ``grads`` (a list), a
    0-d tensor on their device."""
    grads = list(grads)
    if grads[0].is_cuda:
        return adamw.grad_sumsq(grads)
    return grad_sumsq_ref(grads)


def adamw_update(params, grads, mu, nu, scalars, *, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step over the leaf lists, in place on ``params``, ``mu``
    and ``nu``; ``scalars``: the float32 (4,) clip scale, lr, b1c, b2c."""
    fn = adamw.adamw_update if scalars.is_cuda else adamw_update_ref
    fn(params, grads, mu, nu, scalars, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


class FlashAttention(torch.autograd.Function):
    """K1 with K1-bwd as its backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = flash_attention_fwd(q, k, v, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        grads = flash_attention_bwd(q, k, v, o, do.contiguous(), lse, window=ctx.window)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


class WKV6(torch.autograd.Function):
    """K3 with K3-bwd as its backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        o, s = rwkv_scan(r, k, v, w, u, s0)   # grad mode is off here: K3 or its plain version
        ctx.save_for_backward(r, k, v, w, u, s0)
        return o, s

    @staticmethod
    def backward(ctx, do, ds):
        grads = wkv6_bwd(*ctx.saved_tensors, do.contiguous(), ds.contiguous())
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))
