"""Continuous batching (slot-based, vLLM-style scheduling), on the card.

The fixed-size decode batch is a set of *slots*; sequences at different
positions decode together through the per-row-position decode path.  When a
sequence finishes its slot is refilled from the queue at once.

Device state (the (L,slots,max_seq,K,hd) KV cache, last tokens, per-row
positions, the ``active`` mask) lives on the device in static buffers and is
updated in place, so one decode step, captured once into a CUDA graph at the
first chunk (``serving/graphs.py``; eager on the CPU), serves every chunk.  Control state
(``active``/``remaining``/``rid``) is host bookkeeping that evolves
deterministically, copied from the reference unchanged.  ``run()`` decodes
``min(remaining)`` steps between admissions, in power-of-two chunks, and
fetches each chunk's token block in one device-to-host copy; a chunk is
that many replays of the step, where the reference runs one scan.  Rows
outside ``active`` are frozen with ``where(active, ...)`` so the token
streams equal a per-step loop's.  Admission runs one batched prefill per
round (prompts right-padded to a power-of-two bucket, the batch padded to the
slot count), captured into a CUDA graph per bucket and replayed (eager on the
CPU): the graph writes the admitted rows' keys and values into a staging
cache that every bucket shares (a view of one buffer sized for ``max_seq``),
and one eager scatter copies the admitted rows, and only those, into their
slots, through a slot index held in a static device buffer.  A MoE config
admits each request by its own exact-length prefill instead (pad tokens
would change the experts' routing), as the reference jits one per prompt
length: a batch-1 prefill graph per exact length, captured at its first use
into the same pool, which prefills into batch-1 rows of its own and copies
them into the staging cache's row of the request (a row index in a static
device buffer), so that the requests of one round keep their rows; the
round's rows still go through one scatter.  A vlm config is accepted, as
the reference's server accepts it, and admits by the same exact-length
prefill of tokens alone; so admitting a vlm request raises ``KeyError``
naming the missing patch embeddings, at the call where the reference raises
it (its admission hands the vlm prefill no ``patch_embeds`` either).
Greedy decoding.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import api
from repro_torch.models.common import ModelConfig
from repro_torch.serving.engine import bucket_len
from repro_torch.serving.graphs import BLOCK, DecodeGraph, PrefillGraph

# fused-step chunk cap: step counts decompose into powers of two up to this,
# which the decode step's token block holds
MAX_CHUNK = BLOCK


def _chunks(k: int):
    """Decompose k into power-of-two pieces (largest first, capped)."""
    while k > 0:
        c = min(MAX_CHUNK, 1 << (k.bit_length() - 1))
        yield c
        k -= c


def _advance(params, cache, active, cfg: ModelConfig):
    """The greedy decode step over the pool-sized cache at per-row
    positions; rows outside ``active`` keep their carry.  It holds what it
    reads, not the server: no cycle keeps a dropped server's cache and
    graph alive."""
    def advance(tok, pos):
        logits, _ = api.decode_step(params, cache, tok, pos, cfg)
        nxt = torch.argmax(logits, dim=-1)
        return nxt, torch.where(active, nxt, tok), torch.where(active, pos + 1, pos)
    return advance


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    n_new: int = 16


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: list
    steps_in_flight: int


class ContinuousServer:
    def __init__(self, cfg: ModelConfig, *, slots: int = 4, max_seq: int = 128,
                 seed: int = 0, params: dict | None = None, device="cuda"):
        """``params`` (converted reference weights, or an engine's) replaces
        the seeded random draw."""
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: continuous batching drives the transformer "
                             f"KV-cache layout, not the {cfg.family!r} family's state")
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = api.init_params(cfg, gen, self.device)
        self.params = params
        self.cache = api.init_cache(cfg, slots, max_seq, device=self.device)
        # host control plane: deterministic bookkeeping, never syncs device
        self.pos = np.zeros(slots, np.int32)
        self.active = np.zeros(slots, bool)
        self.rid = [-1] * slots
        self.remaining = np.zeros(slots, np.int32)
        self.last_tok = np.zeros(slots, np.int32)
        # device compute state: the decode step's static buffers, set by
        # admission (copied into, never rebound) and advanced by the steps
        self._active_dev = torch.zeros((slots,), dtype=torch.bool, device=self.device)
        self._step = DecodeGraph(slots, self.device,
                                 _advance(self.params, self.cache, self._active_dev, cfg))
        self._tok_dev, self._pos_dev = self._step.tok, self._step.pos
        # admission: a prefill graph per bucket over one staging cache, or
        # (MoE, vlm) per exact length at batch 1, in one memory pool (they
        # never replay concurrently), and the slots that the admitted rows go
        # to; an exact-length graph writes the staging row held in _row_dev
        self._admissions: dict[int, tuple[PrefillGraph, dict]] = {}
        self._exact: dict[int, PrefillGraph] = {}
        self._staging = None
        self._rows = None
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._slots_dev = torch.zeros((slots,), dtype=torch.long, device=self.device)
        self._row_dev = torch.zeros((1,), dtype=torch.long, device=self.device)
        self.out: dict[int, list] = {}
        self.queue: deque[Request] = deque()
        self._done: list[Completion] = []
        self._steps = 0
        self._shapes = {"prefill": set(), "fused_step": set(), "scatter": set()}

    # ------------------------------------------------------------------
    def _staged(self, length: int) -> dict:
        """The staging cache at ``length`` positions: the staging buffer's
        first (L, slots, length, K, hd) elements, made at the first call."""
        if self._staging is None:
            full = api.init_cache(self.cfg, self.slots, self.max_seq, device=self.device)
            self._staging = {n: t.view(-1) for n, t in full.items()}
        shape = (self.cfg.num_layers, self.slots, length) + self.cache["k"].shape[3:]
        n = math.prod(shape)
        return {name: t[:n].view(shape) for name, t in self._staging.items()}

    def _admission(self, bucket: int) -> tuple[PrefillGraph, dict]:
        """The admission prefill at the slot count and ``bucket``, captured
        at its first use, and the cache it writes: the staging buffer's
        first (L, slots, bucket, K, hd) elements."""
        if bucket not in self._admissions:
            cache = self._staged(bucket)
            params, cfg = self.params, self.cfg

            def prefill(tokens, last):
                logits, _ = api.prefill(params, {"tokens": tokens}, cfg, bucket,
                                        last_pos=last, cache=cache)
                return logits

            graph = PrefillGraph(self.slots, bucket, cfg.vocab_size, cfg.cdt, self.device,
                                 prefill, pool=self._pool)
            graph.capture()
            self._admissions[bucket] = graph, cache
        return self._admissions[bucket]

    def _exact_admission(self, length: int) -> PrefillGraph:
        """The batch-1 admission prefill at the exact ``length``, captured
        at its first use into the server's pool: it prefills into batch-1
        rows that every length shares, then copies them into the staging
        cache (at ``max_seq`` positions) at the row that ``_row_dev`` holds
        when it runs.  Its capture's warm-up writes that row too, so the
        caller sets the row first."""
        if length not in self._exact:
            staging = self._staged(self.max_seq)
            if self._rows is None:
                self._rows = api.init_cache(self.cfg, 1, self.max_seq, device=self.device)
            rows, row = self._rows, self._row_dev
            params, cfg, max_seq = self.params, self.cfg, self.max_seq

            def prefill(tokens, last):
                # the exact prompt's last position is its last: no last_pos
                logits, _ = api.prefill(params, {"tokens": tokens}, cfg, max_seq, cache=rows)
                for name, t in staging.items():
                    t.index_copy_(1, row, rows[name])
                return logits

            graph = PrefillGraph(1, length, cfg.vocab_size, cfg.cdt, self.device, prefill,
                                 pool=self._pool)
            graph.capture()
            self._exact[length] = graph
        return self._exact[length]

    def _scatter(self, rows: dict, idx: list):
        """Write admitted rows (L,m,s,K,hd) into slots ``idx`` in place, and
        zero the slots past s, as the reference's padded rows do.  The slot
        index goes through a static device buffer; no other slot is
        written.  Its shape count keys on the rows admitted, as the
        reference's scatter jit, whose rows always span ``max_seq``."""
        self._shapes["scatter"].add(len(idx))
        slots = self._slots_dev[:len(idx)]
        slots.copy_(torch.as_tensor(idx))
        s = rows["k"].shape[2]
        for name in ("k", "v"):
            full = self.cache[name]
            full[:, slots, :s] = rows[name].to(full.dtype)
            full[:, slots, s:] = 0

    def _run_chunk(self, n_steps: int) -> np.ndarray:
        """n_steps replays of the decode step (captured at the first chunk,
        on the carry admission set); returns the (n_steps, slots) token
        block — the single device-to-host copy."""
        self._shapes["fused_step"].add(n_steps)
        self._active_dev.copy_(torch.from_numpy(self.active))   # outside the graph
        self._step.capture()
        toks = self._step.run(n_steps).cpu().numpy()
        self._steps += n_steps
        return toks

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def n_active(self) -> int:
        """Slots currently holding an in-flight sequence."""
        return int(self.active.sum())

    @property
    def steps(self) -> int:
        """Fused decode steps taken so far (the throughput denominator)."""
        return self._steps

    def prefill_pending(self) -> None:
        """Admit queued requests into free slots without decoding."""
        self._admit()

    # ------------------------------------------------------------------
    def _prefill_bucketed(self, reqs):
        """One batched prefill for the whole admission round: batch padded
        to the slot count, prompts right-padded to a shared power-of-two
        bucket."""
        m = len(reqs)
        bucket = min(bucket_len(max(len(r.prompt) for r in reqs)), self.max_seq)
        toks = np.zeros((self.slots, bucket), np.int64)
        last = np.zeros((self.slots,), np.int64)
        for j, r in enumerate(reqs):
            toks[j, :len(r.prompt)] = r.prompt
            last[j] = len(r.prompt) - 1
        self._shapes["prefill"].add((toks.shape, False, bucket))
        graph, cache = self._admission(bucket)
        logits = graph.run(torch.from_numpy(toks), torch.from_numpy(last))
        return logits[:m], {n: t[:, :m] for n, t in cache.items()}

    def _prefill_exact(self, reqs):
        """Per-request exact-length prefills, for families whose pad tokens
        would change real tokens (MoE routing): request j of the round
        replays the graph of its prompt's length into the staging cache's
        row j (each logits row cloned before the next replay); the round's
        rows still merge into one scatter."""
        logits = []
        for j, r in enumerate(reqs):
            self._shapes["prefill"].add(((1, len(r.prompt)), True, self.max_seq))
            self._row_dev.fill_(j)              # outside the graph, before its capture
            graph = self._exact_admission(len(r.prompt))
            logits.append(graph.run(torch.as_tensor([r.prompt])).clone())
        staging = self._staged(self.max_seq)
        return torch.cat(logits, dim=0), {n: t[:, :len(reqs)] for n, t in staging.items()}

    def _admit(self):
        free = [s for s in range(self.slots) if not self.active[s]]
        m = min(len(free), len(self.queue))
        if m == 0:
            return
        reqs = [self.queue.popleft() for _ in range(m)]
        idx = free[:m]
        if self.cfg.family == "dense":
            logits, rows = self._prefill_bucketed(reqs)
        else:
            logits, rows = self._prefill_exact(reqs)
        self._scatter(rows, idx)
        first = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        for j, (s, req) in enumerate(zip(idx, reqs)):
            tok = int(first[j])
            self.active[s] = True
            self.rid[s] = req.rid
            self.pos[s] = len(req.prompt)
            self.remaining[s] = req.n_new - 1
            self.last_tok[s] = tok
            self.out[req.rid] = [tok]
            if req.n_new == 1:
                self._finish(s)
        # resync the device compute state from the host mirrors (H2D only),
        # into the decode step's static buffers
        self._step.start(torch.from_numpy(self.last_tok), torch.from_numpy(self.pos))

    def _finish(self, s: int):
        rid = self.rid[s]
        self._done.append(Completion(rid, list(self.out[rid]), self._steps))
        self.active[s] = False
        self.rid[s] = -1

    # ------------------------------------------------------------------
    def _settle(self, toks: np.ndarray):
        """Apply a token block to the host control plane; finish slots
        whose budget (or cache) ran out."""
        for row in toks:
            for s in range(self.slots):
                if not self.active[s]:
                    continue
                t = int(row[s])
                self.out[self.rid[s]].append(t)
                self.pos[s] += 1
                self.last_tok[s] = t
                self.remaining[s] -= 1
                if self.remaining[s] <= 0 or self.pos[s] >= self.max_seq - 1:
                    self._finish(s)

    def step(self):
        """One fused decode step across all active slots."""
        self._settle(self._run_chunk(1))

    # ------------------------------------------------------------------
    def run(self) -> list:
        """Drain the queue; returns Completions in finish order.

        Between admissions every active slot survives exactly
        ``min(steps-to-finish)`` more steps, so that many are run in chunks
        with one copy each, and settlement is pure host arithmetic."""
        while self.queue or self.active.any():
            self._admit()
            if not self.active.any():
                continue
            k = min(min(int(self.remaining[s]),
                        self.max_seq - 1 - int(self.pos[s]))
                    for s in range(self.slots) if self.active[s])
            for c in _chunks(max(1, k)):
                self._settle(self._run_chunk(c))
        done, self._done = self._done, []
        return done

    # ------------------------------------------------------------------
    def compile_stats(self) -> dict:
        """Distinct prefill shapes, chunk lengths and scatter shapes seen —
        the counterparts of the reference's jit-cache sizes — and the decode
        step (``graphs``) and admission prefills (``prefill_graphs``, by
        bucket and by exact length) captured into CUDA graphs (0 on the
        CPU)."""
        return {**{k: len(v) for k, v in self._shapes.items()},
                "graphs": int(self._step.captured),
                "prefill_graphs": sum(g.captured for g, _ in self._admissions.values())
                + sum(g.captured for g in self._exact.values())}
