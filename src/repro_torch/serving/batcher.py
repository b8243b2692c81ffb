"""Request batching — the knob the paper's related-work section credits
Clipper/TF-Serving with ("highly optimized using caching, batching, ...").

A fixed-capacity batcher with timeout flush: requests queue until either
``max_batch`` accumulate or ``max_wait_s`` elapses since the oldest queued
request.  Prompts are right-padded to the batch max length.  Deterministic:
driven by explicit (virtual or wall) timestamps, so it is testable and
usable inside the serverless simulator.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PendingRequest:
    rid: int
    tokens: list          # prompt token ids
    arrival_s: float
    n_new: int = 16


@dataclasses.dataclass
class Batch:
    rids: list
    tokens: np.ndarray    # (B, S) right-padded
    lengths: np.ndarray   # (B,)
    n_new: int            # batch-wide decode budget (max over requests)
    formed_at_s: float
    # per-request budgets: the engine decodes ``n_new`` steps for the whole
    # batch, then settlement trims each completion to its own request's ask
    # instead of billing every rid for the batch max
    n_new_each: Optional[list] = None


class Batcher:
    def __init__(self, *, max_batch: int = 8, max_wait_s: float = 0.01,
                 pad_id: int = 0):
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.pad_id = pad_id
        self.queue: list[PendingRequest] = []

    def submit(self, req: PendingRequest):
        self.queue.append(req)

    def ready(self, now_s: float) -> bool:
        if not self.queue:
            return False
        if len(self.queue) >= self.max_batch:
            return True
        # 1e-9 tolerance: a caller waking exactly at arrival + max_wait may
        # see (now - arrival) < max_wait by one float ulp and never retry
        return (now_s - self.queue[0].arrival_s) >= self.max_wait_s - 1e-9

    def next_flush_at(self) -> Optional[float]:
        if not self.queue:
            return None
        return self.queue[0].arrival_s + self.max_wait_s

    def form_batch(self, now_s: float, *, force: bool = False) -> Optional[Batch]:
        """Flush up to ``max_batch`` queued requests.

        Honors readiness semantics: returns None until ``max_batch`` requests
        accumulate or ``max_wait_s`` elapses since the oldest queued request.
        ``force=True`` drains regardless (shutdown / end-of-trace flush).
        """
        if not (self.ready(now_s) or (force and self.queue)):
            return None
        take = self.queue[: self.max_batch]
        self.queue = self.queue[self.max_batch:]
        lens = np.array([len(r.tokens) for r in take], np.int32)
        s = int(lens.max())
        toks = np.full((len(take), s), self.pad_id, np.int32)
        for i, r in enumerate(take):
            toks[i, : len(r.tokens)] = r.tokens
        return Batch(rids=[r.rid for r in take], tokens=toks, lengths=lens,
                     n_new=max(r.n_new for r in take), formed_at_s=now_s,
                     n_new_each=[r.n_new for r in take])
