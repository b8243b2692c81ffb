"""Wrapper of the Hopper flash-attention backward (K1-bwd,
``csrc/flash_attention_bwd.cu``).  No TPU kernel stands behind it: the
reference differentiates its plain ``layers.sdpa`` through XLA, its Pallas
kernel having no reverse mode; this computes that gradient on the card.

Takes CUDA tensors only: it checks them, allocates the gradients and the
(B,H,S) scratch of D = rowsum(dO o O), and launches on the current stream.
CPU tensors go to the plain version through ``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.attention.flash import DTYPES, HEAD_DIMS

SOURCE = "flash_attention_bwd"

launches = 0  # wrapper calls that launched (three kernels each); chip_smoke.py reads it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_flash_attention_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor, *, window: int = 0):
    """q, o, do: (B,S,H,hd); k, v: (B,S,K,hd); lse: (B,H,S) float32, from
    K1's forward (``flash.flash_attention(..., with_lse=True)``).  All
    contiguous on one CUDA device; q, k, v, o, do float32 or all bfloat16,
    16-byte aligned; hd in (32, 64, 128).  Causal (+window).  -> (dq, dk,
    dv), dk and dv summed over each kv head's query heads."""
    global launches
    build.refuse_grad("flash_attention_bwd", q, k, v, o, do)
    ins = (q, k, v, o, do, lse)
    if not all(t.is_cuda and t.device == q.device for t in ins):
        raise ValueError("flash_attention_bwd: inputs must be on one CUDA device")
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, o, do)):
        raise ValueError(f"flash_attention_bwd: dtypes {[t.dtype for t in ins[:5]]}; "
                         "all float32 or all bfloat16")
    if q.dim() != 4 or k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: shapes {[tuple(t.shape) for t in ins]}")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd or h % kh:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not in {HEAD_DIMS}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: lse {lse.dtype} {tuple(lse.shape)}, not "
                         f"float32 {(b, h, s)}")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("flash_attention_bwd: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in ins[:5]):
        raise ValueError("flash_attention_bwd: q, k, v, o, do must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    scratch = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(*(t.data_ptr() for t in (q, k, v, o, do, lse, scratch, dq, dk, dv)),
                        b, s, h, kh, hd, int(window), hd ** -0.5, DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: launch failed with CUDA error {err}")
    launches += 1
    return dq, dk, dv
