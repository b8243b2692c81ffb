"""Wrapper of the Hopper AdamW kernels (``csrc/adamw.cu``): K4 ``grad_sumsq``,
the float32 sum of squares over every gradient leaf, and K5 ``adamw_update``,
AdamW's update of every leaf in one pass.  No Pallas kernel stands behind
them: the reference jits its train step, so XLA fuses its AdamW
(``repro/train/optimizer.py``); these are the port's counterpart of that
fusion.

Takes CUDA tensors only: it checks them, writes the leaves' pointers and
sizes into tables of the kernel's layout (at most ``SUMSQ_LEAVES`` or
``UPDATE_LEAVES`` leaves each, passed by value as a kernel parameter, one
launch a table), allocates K4's partials and result, and launches on the
current stream.  Nothing is copied to the device for the tables, so a
launch can be captured into a CUDA graph.  CPU tensors go to the plain
versions (``kernels/optim/ref.py``) through ``repro_torch.kernels.dispatch``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

SOURCE = "adamw"
THREADS = 256
SUMSQ_TILE = THREADS * 8 * 8      # elements a K4 block sums (SUMSQ_TILE in the source)
UPDATE_TILE = THREADS * 8 * 4     # elements a K5 block updates (UPDATE_TILE)
SUMSQ_LEAVES = 128                # leaves a K4 table holds (SUMSQ_LEAVES)
UPDATE_LEAVES = 64                # leaves a K5 table holds (UPDATE_LEAVES)
VEC_BYTES = 16
DTYPES = (torch.bfloat16, torch.float32)


class Count:
    """One kernel's launch count: wrapper calls that launched it, read and
    reset as ``launches`` like the other wrappers' modules."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"Count({self.name!r}, launches={self.launches})"


SUMSQ = Count("grad_sumsq")        # K4; chip_smoke.py reads and resets both
UPDATE = Count("adamw_update")     # K5


class SumsqLeaf(ctypes.Structure):
    _fields_ = [("x", ctypes.c_void_p), ("n", ctypes.c_longlong), ("first", ctypes.c_int),
                ("bf16", ctypes.c_int)]


class SumsqTable(ctypes.Structure):
    _fields_ = [("leaf", SumsqLeaf * SUMSQ_LEAVES), ("count", ctypes.c_int),
                ("base", ctypes.c_int), ("blocks", ctypes.c_int)]


P_BF16, G_BF16 = 1, 2


class UpdateLeaf(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("mu", ctypes.c_void_p),
                ("nu", ctypes.c_void_p), ("n", ctypes.c_longlong), ("first", ctypes.c_int),
                ("flags", ctypes.c_int)]


class UpdateTable(ctypes.Structure):
    _fields_ = [("leaf", UpdateLeaf * UPDATE_LEAVES), ("count", ctypes.c_int),
                ("blocks", ctypes.c_int)]


_fns = {}


def _kernel(name: str):
    if name not in _fns:
        fn = getattr(build.library(SOURCE), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([p, i, p, i, p, p] if name == "repro_grad_sumsq"
                       else [p, i, p, f, f, f, f, f, f, p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(name: str, tensors, dev, dtypes=DTYPES) -> None:
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: the leaves must be on one CUDA device")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: leaves must be contiguous")
        if t.data_ptr() % VEC_BYTES:
            raise ValueError(f"{name}: leaves must be {VEC_BYTES}-byte aligned")


def _tables(cls, per: int, tile: int, leaves: list, fill) -> tuple[list, int]:
    """Tables of ``cls`` holding ``leaves`` (their non-empty ones) ``per`` at
    a time, ``fill(entry, leaf)`` writing a leaf's pointers; -> (tables,
    blocks over all)."""
    live = [x for x in leaves if x[0].numel()]
    tables, total = [], 0
    for i in range(0, len(live), per):
        t = cls()
        blocks = 0
        for j, leaf in enumerate(live[i:i + per]):
            e = t.leaf[j]
            fill(e, leaf)
            e.n = leaf[0].numel()
            e.first = blocks
            blocks += -(-e.n // tile)
        t.count = len(live[i:i + per])
        t.blocks = blocks
        if hasattr(t, "base"):
            t.base = total
        total += blocks
        tables.append(t)
    return tables, total


def grad_sumsq(grads: list) -> torch.Tensor:
    """K4: the float32 sum over the leaves ``grads`` (bf16 or float32,
    contiguous, 16-byte aligned, on one CUDA device) of their squares, as
    a 0-d float32 device tensor; summed in a fixed order (two runs give the
    same bits)."""
    grads = list(grads)
    if not grads:
        raise ValueError("grad_sumsq: no leaves")
    dev = grads[0].device
    build.refuse_grad("grad_sumsq", *grads)
    _check("grad_sumsq", grads, dev)

    def fill(e, leaf):
        e.x = leaf[0].data_ptr()
        e.bf16 = int(leaf[0].dtype == torch.bfloat16)

    tables, total = _tables(SumsqTable, SUMSQ_LEAVES, SUMSQ_TILE, [(g,) for g in grads], fill)
    out = torch.empty((), dtype=torch.float32, device=dev)
    if not tables:           # every leaf empty
        return out.zero_()
    partials = torch.empty(total, dtype=torch.float64, device=dev)
    arr = (SumsqTable * len(tables))(*tables)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("repro_grad_sumsq")(ctypes.addressof(arr), len(tables),
                                          partials.data_ptr(), total, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"grad_sumsq: launch failed with CUDA error {err}")
    SUMSQ.launches += 1
    return out


def adamw_update(params: list, grads: list, mu: list, nu: list, scalars: torch.Tensor, *,
                 b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """K5: one AdamW step over the leaves, in place on ``params`` (bf16 or
    float32), ``mu`` and ``nu`` (float32) from ``grads`` (bf16 or float32),
    lists in one leaf order, each leaf contiguous, 16-byte aligned, of one
    size across the four, on one CUDA device.  ``scalars``: float32 (4,) on
    that device, the clip scale, lr, b1c and b2c."""
    params, grads, mu, nu = list(params), list(grads), list(mu), list(nu)
    if not params or not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"adamw_update: {len(params)} params, {len(grads)} grads, "
                         f"{len(mu)} and {len(nu)} moments")
    dev = params[0].device
    build.refuse_grad("adamw_update", *grads)
    _check("adamw_update", params + grads, dev)
    _check("adamw_update", mu + nu + [scalars], dev, (torch.float32,))
    if scalars.shape != (4,):
        raise ValueError(f"adamw_update: scalars {tuple(scalars.shape)}, not (4,)")
    for p, g, m, v in zip(params, grads, mu, nu):
        if not p.numel() == g.numel() == m.numel() == v.numel():
            raise ValueError(f"adamw_update: a leaf of {p.numel()} elements has a gradient "
                             f"of {g.numel()} and moments of {m.numel()}, {v.numel()}")

    def fill(e, leaf):
        p, g, m, v = leaf
        e.p, e.g, e.mu, e.nu = (t.data_ptr() for t in leaf)
        e.flags = (P_BF16 * (p.dtype == torch.bfloat16)) | (G_BF16 * (g.dtype == torch.bfloat16))

    tables, _ = _tables(UpdateTable, UPDATE_LEAVES, UPDATE_TILE,
                        list(zip(params, grads, mu, nu)), fill)
    if not tables:
        return
    arr = (UpdateTable * len(tables))(*tables)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel("repro_adamw_update")(ctypes.addressof(arr), len(tables),
                                            scalars.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2,
                                            eps, weight_decay, stream)
    if err:
        raise RuntimeError(f"adamw_update: launch failed with CUDA error {err}")
    UPDATE.launches += 1
