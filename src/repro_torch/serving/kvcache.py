"""KV-cache management utilities for the serving engine.

The counterpart of ``repro.serving.kvcache``.  Three views over the
layer-stacked cache ``{"k","v"}: (L,B,S,K,hd)``:

  * linear   — append at a position (what ``transformer.decode_step`` does)
  * windowed — a validity mask over a fixed window (the hybrid's local
               attention keeps its own ring buffer, ``models/hybrid.py``)
  * paged    — vLLM-style block tables: the cache is a pool of fixed-size
               blocks; sequences own ordered block lists, so batches with
               very different lengths share one pool without padding waste.

The paged view is host-side bookkeeping (allocation and release) over a pool
on the device; ``write_prefill`` is one indexed copy into the pool,
``write_token`` one slice write, and ``gather`` the dense per-sequence view
the attention consumes.  As in the reference, nothing else calls it.  The
pool is updated in place (the counterpart of the reference's donated
pool).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models.common import ModelConfig


# ----------------------------------------------------------------------
# linear view
# ----------------------------------------------------------------------

def append(cache: dict, k_new, v_new, pos) -> dict:
    """cache k/v: (L,B,S,K,hd); k_new/v_new: (L,B,1,K,hd); pos: an int or a
    0-d int tensor (clamped into the cache, as ``dynamic_update_slice``
    clamps).  Writes the cache in place and returns it."""
    s = cache["k"].shape[2]
    if isinstance(pos, torch.Tensor):
        idx = pos.reshape(1).clamp(0, s - 1).to(device=cache["k"].device, dtype=torch.long)
    else:
        idx = torch.tensor([min(max(int(pos), 0), s - 1)], device=cache["k"].device)
    for name, new in (("k", k_new), ("v", v_new)):
        cache[name].index_copy_(2, idx, torch.as_tensor(new).to(cache[name]))
    return cache


def valid_mask(seq: int, pos, window: int = 0, device="cuda") -> torch.Tensor:
    """(seq,) bool: the positions up to ``pos`` and, with a ``window``, less
    than ``window`` behind it.  On ``pos``'s device when it is a tensor,
    else on ``device``."""
    dev = pos.device if isinstance(pos, torch.Tensor) else resolve_device(device)
    idx = torch.arange(seq, device=dev)
    m = idx <= pos
    if window:
        m &= (pos - idx) < window
    return m


# ----------------------------------------------------------------------
# paged view
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PagedPool:
    """Host-side allocator over a block pool on the device.

    pool k/v: (L, n_blocks, block, K, hd).  Block tables map sequence id ->
    ordered block ids.  Device tensors are only touched by the writes and
    ``gather``.
    """
    cfg: ModelConfig
    n_blocks: int
    block: int = 128
    dtype: str = "bfloat16"
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        shape = (self.cfg.num_layers, self.n_blocks, self.block,
                 self.cfg.num_kv_heads, self.cfg.resolved_head_dim)
        dt = getattr(torch, self.dtype)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.free: list[int] = list(range(self.n_blocks))
        self.tables: dict[int, list[int]] = {}
        self.lengths: dict[int, int] = {}

    # ----- allocation ------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int):
        need = -(-n_tokens // self.block)
        if len(self.free) < need:
            raise MemoryError(f"paged pool exhausted: need {need} blocks, "
                              f"{len(self.free)} free")
        blocks = [self.free.pop() for _ in range(need)]
        self.tables[seq_id] = blocks
        self.lengths[seq_id] = n_tokens
        return blocks

    def extend(self, seq_id: int, n_new: int = 1):
        length = self.lengths[seq_id] + n_new
        need = -(-length // self.block)
        while len(self.tables[seq_id]) < need:
            if not self.free:
                raise MemoryError("paged pool exhausted on extend")
            self.tables[seq_id].append(self.free.pop())
        self.lengths[seq_id] = length

    def release(self, seq_id: int):
        self.free.extend(self.tables.pop(seq_id))
        self.lengths.pop(seq_id)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self.free) / self.n_blocks

    # ----- device data movement ---------------------------------------
    def _blocks(self, seq_id: int, n: int | None = None) -> torch.Tensor:
        return torch.as_tensor(self.tables[seq_id][:n], dtype=torch.long, device=self.device)

    def write_prefill(self, seq_id: int, ks, vs):
        """ks/vs: (L, S, K, hd) for one sequence; one indexed copy over the
        sequence's block table.  Tokens past its blocks are cut, and the last
        block's tail is zero-padded, as the reference does."""
        ks, vs = (torch.as_tensor(t).to(self.k) for t in (ks, vs))
        l, s = ks.shape[0], ks.shape[1]
        nb = min(-(-s // self.block), len(self.tables[seq_id]))
        pad = nb * self.block - s
        if pad < 0:
            ks, vs = ks[:, :nb * self.block], vs[:, :nb * self.block]
        elif pad:
            ks, vs = F.pad(ks, (0, 0, 0, 0, 0, pad)), F.pad(vs, (0, 0, 0, 0, 0, pad))
        shape = (l, nb, self.block) + tuple(ks.shape[2:])
        idx = self._blocks(seq_id, nb)
        self.k.index_copy_(1, idx, ks.reshape(shape))
        self.v.index_copy_(1, idx, vs.reshape(shape))

    def write_token(self, seq_id: int, k1, v1):
        """k1/v1: (L, K, hd) — append one token (``extend`` first)."""
        pos = self.lengths[seq_id] - 1
        b, off = self.tables[seq_id][pos // self.block], pos % self.block
        self.k[:, b, off] = torch.as_tensor(k1).to(self.k)
        self.v[:, b, off] = torch.as_tensor(v1).to(self.v)

    def gather(self, seq_id: int, pad_to: int | None = None):
        """Dense (L, S_padded, K, hd) views of one sequence's keys and values,
        and its valid mask."""
        idx = self._blocks(seq_id)
        l, kh, hd = self.k.shape[0], self.k.shape[3], self.k.shape[4]
        ks = self.k.index_select(1, idx).reshape(l, -1, kh, hd)
        vs = self.v.index_select(1, idx).reshape(l, -1, kh, hd)
        nbs = ks.shape[1]
        if pad_to and pad_to > nbs:
            ks = F.pad(ks, (0, 0, 0, 0, 0, pad_to - nbs))
            vs = F.pad(vs, (0, 0, 0, 0, 0, pad_to - nbs))
        mask = torch.arange(ks.shape[1], device=self.device) < self.lengths[seq_id]
        return ks, vs, mask
