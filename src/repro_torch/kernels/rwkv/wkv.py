"""Wrapper of the Hopper WKV-6 kernel (K3, ``csrc/wkv6.cu``), which replaces
the reference's Pallas ``repro/kernels/rwkv/wkv.py::wkv6`` and its padding
wrapper ``repro/kernels/rwkv/ops.py::wkv6``.

Takes CUDA tensors only: it checks them, allocates the outputs, and launches
on the current stream.  CPU tensors go to the plain version through
``repro_torch.kernels.dispatch``.  Any T >= 1 runs unpadded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "wkv6"
HEAD_DIMS = (16, 32, 64, 128)
COLS = 4             # state columns per thread: one 16-byte word (COLS in the source)
ROWS = 4             # state rows per thread: one 16-byte word of r, k, w (ROWS)
THREADS = 128        # threads of a CTA where the head is wide enough (4 warps)
VEC_BYTES = 16

launches = 0  # kernel launches in this process; chip_smoke.py reads and resets it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_wkv6
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.cache
def split_plan(hd: int) -> tuple[int, int, int]:
    """(CTAs per head, columns per CTA, lanes per column) for K3.  A thread
    holds a ROWS x COLS block of a head's state, so a column spans hd / ROWS
    lanes, and a CTA takes as many columns as THREADS threads hold (the
    whole head where it is narrower).  Narrower CTAs, more of them per
    head, were slower on the card (``chip_smoke.py`` phase 6 times the
    engine's prefill under each), so the plan depends on hd alone."""
    lanes = hd // ROWS
    cols = min(hd, COLS * THREADS // lanes)
    return hd // cols, cols, lanes


def _refuse(ins: tuple, r: torch.Tensor) -> None:
    """Raise with the first reason the kernel does not take ``ins``."""
    if not all(t.is_cuda and t.device == r.device for t in ins):
        raise ValueError("wkv6: inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"wkv6: dtypes {[t.dtype for t in ins]}; all must be float32")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("wkv6: inputs must be contiguous")
    raise ValueError(f"wkv6: inputs must be {VEC_BYTES}-byte aligned")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor, *, out_state: torch.Tensor | None = None):
    """r, k, v, w: (B,T,H,hd), T >= 1; u: (H,hd); s0: (B,H,hd,hd); all float32,
    contiguous, 16-byte aligned, on one CUDA device, hd in (16, 32, 64, 128).
    Returns (o (B,T,H,hd), final state).  The final state goes to
    ``out_state`` when given, which may be ``s0`` itself (the state is then
    updated in place); else to a new tensor."""
    global launches
    build.refuse_grad("wkv6", r, k, v, w, u, s0)
    ins = (r, k, v, w, u, s0) if out_state is None else (r, k, v, w, u, s0, out_state)
    dev = r.device
    for t in ins:
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or t.data_ptr() % VEC_BYTES or not t.is_cuda):
            _refuse(ins, r)
    shape = r.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape or w.shape != shape:
        raise ValueError(f"wkv6: r, k, v, w shapes {[tuple(t.shape) for t in (r, k, v, w)]}")
    b, t, h, hd = shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {hd} not in {HEAD_DIMS}")
    if t < 1 or b < 1 or h < 1:
        raise ValueError(f"wkv6: empty input {tuple(shape)}")
    if u.shape != (h, hd) or s0.shape != (b, h, hd, hd):
        raise ValueError(f"wkv6: u {tuple(u.shape)} or s0 {tuple(s0.shape)} does not "
                         f"match r {tuple(shape)}")
    if out_state is None:
        out_state = torch.empty_like(s0)
    elif out_state.shape != s0.shape:
        raise ValueError(f"wkv6: out_state {tuple(out_state.shape)} is not {tuple(s0.shape)}")
    o = torch.empty_like(r)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s0.data_ptr(), o.data_ptr(), out_state.data_ptr(), b, t, h, hd,
            *split_plan(hd), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args)
    if err:
        raise RuntimeError(f"wkv6: launch failed with CUDA error {err}")
    launches += 1
    return o, out_state
