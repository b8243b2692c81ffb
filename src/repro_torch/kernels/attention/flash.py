"""Wrapper of the Hopper flash-attention prefill kernel (K1,
``csrc/flash_attention.cu``), which replaces the reference's Pallas
``repro/kernels/attention/flash.py::flash_attention``.

Takes CUDA tensors only: it checks them, allocates the output, and launches
on the current stream.  CPU tensors go to the plain version through
``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention"
HEAD_DIMS = (32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches in this process; chip_smoke.py reads and resets it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_flash_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, with_lse: bool = False):
    """q: (B,S,H,hd); k,v: (B,S,K,hd), H % K == 0, all contiguous on one CUDA
    device, float32 or bfloat16 (bfloat16 16-byte aligned), hd in (32, 64,
    128).  Causal (+window).  -> o, or with ``with_lse`` (o, the float32
    log-sum-exp of each row's scaled, masked logits (B,H,S)), which the
    backward (``flash_bwd.py``) takes."""
    global launches
    build.refuse_grad("flash_attention", q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "all float32 or all bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd or h % kh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not match "
                         f"k/v {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k, v must be 16-byte aligned")
    o = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse
           else None)
    if q.numel() == 0:
        return (o, lse) if with_lse else o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        b, s, h, kh, hd, int(window), hd ** -0.5, DTYPES[q.dtype],
                        stream)
    if err:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error {err}")
    launches += 1
    return (o, lse) if with_lse else o
