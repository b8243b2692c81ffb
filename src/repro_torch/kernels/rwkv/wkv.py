"""Wrapper of the Hopper WKV-6 kernel (K3, ``csrc/wkv6.cu``), which replaces
the reference's Pallas ``repro/kernels/rwkv/wkv.py::wkv6`` and its padding
wrapper ``repro/kernels/rwkv/ops.py::wkv6``.

Takes CUDA tensors only: it checks them, allocates the outputs, and launches
on the current stream.  CPU tensors go to the plain version through
``repro_torch.kernels.dispatch``.  Any T >= 1 runs unpadded.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "wkv6"
HEAD_DIMS = (16, 32, 64, 128)

launches = 0  # kernel launches in this process; chip_smoke.py reads and resets it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_wkv6
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *, out_state: torch.Tensor | None = None):
    """r, k, v, w: (B,T,H,hd), T >= 1; u: (H,hd); s0: (B,H,hd,hd); all float32,
    contiguous, on one CUDA device, hd in (16, 32, 64, 128).  Returns
    (o (B,T,H,hd), final state).  The final state goes to ``out_state`` when
    given, which may be ``s0`` itself (the state is then updated in place);
    else to a new tensor."""
    global launches
    ins = (r, k, v, w, u, s0) + (() if out_state is None else (out_state,))
    if not (r.is_cuda and all(t.device == r.device for t in ins)):
        raise ValueError("wkv6: inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"wkv6: dtypes {[t.dtype for t in ins]}; all must be float32")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("wkv6: inputs must be contiguous")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6: r, k, v, w shapes {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not in {HEAD_DIMS}")
    if t < 1 or b < 1 or h < 1:
        raise ValueError(f"wkv6: empty input {tuple(r.shape)}")
    if u.shape != (h, hd) or s0.shape != (b, h, hd, hd):
        raise ValueError(f"wkv6: u {tuple(u.shape)} or s0 {tuple(s0.shape)} does not "
                         f"match r {tuple(r.shape)}")
    if out_state is None:
        out_state = torch.empty_like(s0)
    elif out_state.shape != s0.shape:
        raise ValueError(f"wkv6: out_state {tuple(out_state.shape)} is not {tuple(s0.shape)}")
    o = torch.empty_like(r)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                        u.data_ptr(), s0.data_ptr(), o.data_ptr(), out_state.data_ptr(),
                        b, t, h, hd, stream)
    if err:
        raise RuntimeError(f"wkv6: launch failed with CUDA error {err}")
    launches += 1
    return o, out_state
