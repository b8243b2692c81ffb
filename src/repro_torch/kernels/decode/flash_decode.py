"""Wrapper of the Hopper split-KV flash-decode kernel (K2,
``csrc/flash_decode.cu``), which replaces the reference's Pallas
``repro/kernels/decode/flash_decode.py::flash_decode``.

Takes CUDA tensors only: it checks them, allocates the output and the
split partials, and launches on the current stream.  CPU tensors go to the
plain version through ``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

SOURCE = "flash_decode"
TILE = 64            # cache positions per tile (BKD in the source)
SMS = 132            # streaming multiprocessors of an H100
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches in this process; chip_smoke.py reads and resets it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_flash_decode
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, p, p, p, p, i, i, i, i, i, ll, ll, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_plan(batch: int, kv_heads: int, seq: int) -> tuple[int, int]:
    """(splits, tiles per split): enough splits that batch*kv_heads*splits
    CTAs cover the SMs twice over, no split without a tile."""
    tiles = max(1, math.ceil(seq / TILE))
    want = min(tiles, max(1, math.ceil(2 * SMS / (batch * kv_heads))))
    per = math.ceil(tiles / want)
    return math.ceil(tiles / per), per


def flash_decode(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """q: (B,1,H,hd) contiguous; cache_k/v: (B,S,K,hd) with the last two
    dims contiguous (batch and position strides are free, so a band slice
    of a longer cache needs no copy); valid: (S,) bool shared by every row,
    or (B,S) bool contiguous, per row.  float32 or bfloat16, hd <= 256."""
    global launches
    dev = q.device
    if not (q.is_cuda and cache_k.device == dev and cache_v.device == dev
            and valid.device == dev):
        raise ValueError("flash_decode: q, caches and valid must be on one CUDA device")
    if q.dtype not in DTYPES or cache_k.dtype != q.dtype or cache_v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype}, {cache_k.dtype}, "
                         f"{cache_v.dtype}; all float32 or all bfloat16")
    if q.dim() != 4 or q.shape[1] != 1 or cache_k.dim() != 4 or cache_k.shape != cache_v.shape:
        raise ValueError(f"flash_decode: shapes {tuple(q.shape)}, {tuple(cache_k.shape)}, "
                         f"{tuple(cache_v.shape)}")
    b, _, h, hd = q.shape
    s, kh = cache_k.shape[1], cache_k.shape[2]
    if cache_k.shape[0] != b or cache_k.shape[3] != hd or h % kh or hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match cache "
                         f"{tuple(cache_k.shape)} (hd <= {MAX_HEAD_DIM})")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    for c in (cache_k, cache_v):
        if c.stride(3) != 1 or c.stride(2) != hd:
            raise ValueError("flash_decode: cache (K, hd) dims must be contiguous")
    if cache_k.stride() != cache_v.stride():
        raise ValueError("flash_decode: cache_k and cache_v strides differ")
    if valid.dtype != torch.bool:
        raise ValueError(f"flash_decode: valid must be bool, not {valid.dtype}")
    if valid.shape == (s,) and valid.is_contiguous():
        valid_bstride = 0
    elif valid.shape == (b, s) and valid.is_contiguous():
        valid_bstride = s
    else:
        raise ValueError(f"flash_decode: valid {tuple(valid.shape)} is neither a "
                         f"contiguous ({s},) nor ({b}, {s})")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    nsplit, per = split_plan(b, kh, s)
    part_m = torch.empty((b, h, nsplit), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, h, nsplit), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, h, nsplit, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel()(q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
                        valid.view(torch.uint8).data_ptr(), valid_bstride, o.data_ptr(),
                        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
                        b, s, h, kh, hd, cache_k.stride(0), cache_k.stride(1),
                        nsplit, per, hd ** -0.5, DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_decode: launch failed with CUDA error {err}")
    launches += 1
    return o
