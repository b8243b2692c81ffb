"""Wrapper of the Hopper split-KV flash-decode kernel (K2,
``csrc/flash_decode.cu``), which replaces the reference's Pallas
``repro/kernels/decode/flash_decode.py::flash_decode``.

Takes CUDA tensors only: it checks them, allocates the output and the
split partials (one scratch buffer), and launches on the current stream.
With ``return_lse`` the combine also writes each row's log-sum-exp of its
logits, (B,H) float32, natural log, -inf for a row with no valid position:
the weight under which the outputs over chunks of a sequence-sharded cache
combine (``repro_torch.shardctx.combine_softmax``).  The output is the same
with and without it.
CPU tensors go to the plain version through ``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

SOURCE = "flash_decode"
TILE = 64            # cache positions per tile (BKD in the source)
SMS = 132            # streaming multiprocessors of an H100
CTAS_PER_SM = 8      # split CTAs (4 warps each) per SM that split_plan aims for
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16       # the kernel reads cache rows in 16-byte vectors

launches = 0  # kernel launches in this process; chip_smoke.py reads and resets it

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = build.library(SOURCE).repro_flash_decode
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, p, p, p, p, p, i, i, i, i, i, ll, ll, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def split_plan(batch: int, kv_heads: int, seq: int) -> tuple[int, int]:
    """(splits, tiles per split): enough splits that batch*kv_heads*splits
    CTAs put CTAS_PER_SM on every SM, no split without a tile.  A split's
    warps each take one step of 16 positions per tile (hd=128 bf16), so
    at small batch one tile per split keeps the most cache rows in flight."""
    tiles = max(1, math.ceil(seq / TILE))
    want = min(tiles, max(1, math.ceil(CTAS_PER_SM * SMS / (batch * kv_heads))))
    per = math.ceil(tiles / want)
    return math.ceil(tiles / per), per


def flash_decode(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                 valid: torch.Tensor, *, return_lse: bool = False):
    """q: (B,1,H,hd) contiguous; cache_k/v: (B,S,K,hd) with the last two
    dims contiguous (batch and position strides are free, so a band slice
    of a longer cache needs no copy); valid: (S,) bool shared by every row,
    or (B,S) bool contiguous, per row.  float32 or bfloat16; hd <= 256 and
    a whole number of 16-byte vectors; q, the caches and the cache strides
    16-byte aligned.  -> o (B,1,H,hd), or (o, lse (B,H) float32) with
    ``return_lse``."""
    global launches
    build.refuse_grad("flash_decode", q, cache_k, cache_v)   # K2 has no backward
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
    vec = VEC_BYTES // q.element_size()
    if (cache_k.shape[0] != b or cache_k.shape[3] != hd or h % kh or hd > MAX_HEAD_DIM
            or hd % vec):
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match cache "
                         f"{tuple(cache_k.shape)} (hd <= {MAX_HEAD_DIM}, a multiple of {vec})")
    if not q.is_contiguous():
        raise ValueError("flash_decode: q must be contiguous")
    if cache_k.stride(3) != 1 or cache_k.stride(2) != hd:
        raise ValueError("flash_decode: cache (K, hd) dims must be contiguous")
    if cache_k.stride() != cache_v.stride():
        raise ValueError("flash_decode: cache_k and cache_v strides differ")
    if (any(t.data_ptr() % VEC_BYTES for t in (q, cache_k, cache_v))
            or cache_k.stride(0) % vec or cache_k.stride(1) % vec):
        raise ValueError("flash_decode: q, the caches and their strides must be "
                         f"{VEC_BYTES}-byte aligned")
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
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) if return_lse else None
    if q.numel() == 0:
        return (o, lse) if return_lse else o
    nsplit, per = split_plan(b, kh, s)
    n = b * h * nsplit
    part = torch.empty(n * (hd + 2), dtype=torch.float32, device=dev)   # m, l, acc
    m_ptr = part.data_ptr()
    args = (q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            valid.data_ptr(), valid_bstride, o.data_ptr(),   # bool: one byte, 0 or 1
            lse.data_ptr() if return_lse else None, m_ptr, m_ptr + 4 * n, m_ptr + 8 * n,
            b, s, h, kh, hd,
            cache_k.stride(0), cache_k.stride(1), nsplit, per, hd ** -0.5,
            DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args)
    if err:
        raise RuntimeError(f"flash_decode: launch failed with CUDA error {err}")
    launches += 1
    return (o, lse) if return_lse else o
