"""Wrapper of the Hopper WKV-6 backward (K3-bwd, ``csrc/wkv6_bwd.cu``).  No
TPU kernel stands behind it: the reference differentiates its plain
``models/ssm.py::wkv_ref`` through XLA, its Pallas kernel having no reverse
mode; this computes that gradient on the card.

Takes CUDA tensors only: it checks them, picks the split plan (each head's
columns over a cluster of CTAs), allocates the gradients and the scratch
(the state at the start of every chunk of 16 steps, and each thread's
share of du), and launches on the current stream.  CPU tensors go to the
plain version through ``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rwkv.wkv import COLS, HEAD_DIMS, ROWS, VEC_BYTES

SOURCE = "wkv6_bwd"
CHUNK = 16           # steps between the kept states (C in the source)
CTA_COLS = 32        # columns a CTA takes where the head is wider (CC in the source)

launches = 0  # wrapper calls that launched; chip_smoke.py reads and resets it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_wkv6_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 16 + [i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


@functools.cache
def split_plan(hd: int) -> tuple[int, int]:
    """(CTAs per head, columns per CTA) for K3-bwd: CTA_COLS columns, or the
    whole head where it is narrower.  A head's CTAs form one thread-block
    cluster (2 at hd 64, 4 at hd 128).  CTAs of 16 columns, more of them
    per head, were slower on the card at every head count tried."""
    cols = min(hd, CTA_COLS)
    return hd // cols, cols


def threads(hd: int) -> int:
    """A CTA's threads: one per ROWS x COLS block of its columns."""
    return split_plan(hd)[1] // COLS * (hd // ROWS)


def scratch_numel(b: int, t: int, h: int, hd: int) -> dict:
    """The scratch a launch needs, in floats: ``ckpt``, a slot for every CTA
    thread's block of the state at the start of every chunk; and
    ``du_part``, each CTA thread's share of du."""
    ctas = b * h * split_plan(hd)[0]
    return {"ckpt": ctas * -(-t // CHUNK) * threads(hd) * ROWS * COLS,
            "du_part": ctas * threads(hd)}


def wkv6_bwd(r, k, v, w, u, s0, do, ds_t):
    """r, k, v, w, do: (B,T,H,hd), T >= 1; u: (H,hd); s0 and ds_t, the
    gradient of the final state: (B,H,hd,hd); all float32, contiguous, on
    one CUDA device, 16-byte aligned; hd in (16, 32, 64, 128).  -> (dr,
    dk, dv, dw, du (H,hd) summed over B and T, ds0)."""
    global launches
    build.refuse_grad("wkv6_bwd", r, k, v, w, u, s0, do)
    ins = (r, k, v, w, u, s0, do, ds_t)
    if not all(t.is_cuda and t.device == r.device for t in ins):
        raise ValueError("wkv6_bwd: inputs must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in ins):
        raise ValueError(f"wkv6_bwd: dtypes {[t.dtype for t in ins]}; all must be float32")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("wkv6_bwd: inputs must be contiguous")
    if any(t.data_ptr() % VEC_BYTES for t in ins):
        raise ValueError(f"wkv6_bwd: inputs must be {VEC_BYTES}-byte aligned")
    shape = r.shape
    if len(shape) != 4 or any(t.shape != shape for t in (k, v, w, do)):
        raise ValueError(f"wkv6_bwd: r, k, v, w, do shapes "
                         f"{[tuple(t.shape) for t in (r, k, v, w, do)]}")
    b, t, h, hd = shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_bwd: head dim {hd} not in {HEAD_DIMS}")
    if t < 1 or b < 1 or h < 1:
        raise ValueError(f"wkv6_bwd: empty input {tuple(shape)}")
    if u.shape != (h, hd) or s0.shape != (b, h, hd, hd) or ds_t.shape != s0.shape:
        raise ValueError(f"wkv6_bwd: u {tuple(u.shape)}, s0 {tuple(s0.shape)} or ds_t "
                         f"{tuple(ds_t.shape)} does not match r {tuple(shape)}")
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du, ds0 = torch.empty_like(u), torch.empty_like(s0)
    sizes = scratch_numel(b, t, h, hd)
    du_part = torch.empty(sizes["du_part"], dtype=torch.float32, device=r.device)
    ckpt = torch.empty(sizes["ckpt"], dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        err = _kernel()(*(x.data_ptr() for x in (r, k, v, w, u, s0, do, ds_t, dr, dk, dv, dw,
                                                 du, ds0, du_part, ckpt)),
                        b, t, h, hd, *split_plan(hd), stream)
    if err:
        raise RuntimeError(f"wkv6_bwd: launch failed with CUDA error {err}")
    launches += 1
    return dr, dk, dv, dw, du, ds0
