"""Request routing and per-function fleet state.

A ``Fleet`` is everything the cluster tracks for one deployed
``FunctionSpec``: its containers, the warm-idle list, in-flight completion
times, the arrival history the scaling policy reads, and (optionally) a
``repro_torch.serving.batcher.Batcher`` when the fleet runs in batching mode.

The ``Router`` maps a workload ``Request`` to a fleet by the request's
``fn`` field (empty string routes to the default fleet), which is what lets
one cluster serve several functions under a shared container cap.

``BarePool`` is the LayeredPool coldstart policy's cluster-shared stock of
bootstrapped-but-unloaded sandboxes: function-agnostic containers parked in
lifecycle state BOOTSTRAPPED that any fleet may claim, paying only the LOAD
phase.

The port's counterpart of ``repro.core.cluster.router``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import providers
from repro_torch.core.container import Container, State, cold_start_breakdown
from repro_torch.core.function import FunctionSpec, normalize_batch_curve
from repro_torch.serving.batcher import Batcher


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    """Batching-aware container mode.

    Requests queue at the fleet and flush as one batch when ``max_batch``
    accumulate or ``max_wait_s`` elapses since the oldest queued request.
    A batch of B runs for ``exec * (1 + amortization * (B - 1))`` wall time
    — i.e. marginal requests cost ``amortization`` of a full pass — and each
    request is billed the per-request share of that wall time.
    """
    max_batch: int = 8
    max_wait_s: float = 0.25
    amortization: float = 0.25


class Fleet:
    def __init__(self, name: str, spec: FunctionSpec,
                 batching: Optional[BatchingConfig] = None):
        self.name = name
        self.spec = spec
        self.batching = batching
        self.batcher = (Batcher(max_batch=batching.max_batch,
                                max_wait_s=batching.max_wait_s)
                        if batching else None)
        self.pending_reqs: dict[int, object] = {}  # rid -> queued Request
        self.containers: dict[int, Container] = {}
        self.live: set[int] = set()               # non-EVICTED cids
        self.idle: list[tuple[float, int]] = []   # (completed_at, cid)
        self.inflight_ends: dict[int, list] = {}  # cid -> in-flight end times
        self.expire_sched: dict[int, float] = {}  # cid -> latest expire event
        self.flush_sched_t: float = float("-inf")  # latest scheduled FLUSH
        self.prewarm_etas: list[float] = []       # PREWARM_READY times due
        self.arrivals: list[float] = []           # scaling-policy history
        self.last_arrival_s: Optional[float] = None
        self.pending_prewarms = 0
        self.cold_starts = 0
        self.evictions = 0
        # ---- hot-path caches: all pure functions of the spec, once
        # recomputed per event (the sim loop's most-repeated redundant
        # work after _active_total).  All routed through the spec's
        # provider profile; the default "lambda" profile reproduces the
        # pre-provider arithmetic bit-for-bit.
        prof = providers.get(spec.provider)
        self.warm_exec_s = prof.exec_time(spec.handler.base_cpu_seconds,
                                          spec.memory_mb)
        self.cold_bd = cold_start_breakdown(spec)
        self.cold_total_s = self.cold_bd.total_s
        self.price_100ms = prof.price_per_100ms(spec.memory_mb)
        self.memory_mb = spec.memory_mb
        # measured batch-efficiency curve (modern handlers); None keeps the
        # analytic amortization model in the cluster's batching path
        self.batch_curve = (normalize_batch_curve(spec.handler.batch_curve)
                            or None)
        # provider-side capacity billing (GPU serverless: the container
        # bills per-second for its whole up-time, idle included)
        self.bill_idle = prof.bill_idle
        self.per_second_usd = prof.per_second_usd
        self.up_seconds = 0.0       # settled container up-time (evictions)
        self.billed_cost = 0.0      # exec $ already billed to requests
        # set on evict(): the idle list may hold a dead cid, so the next
        # _candidates call must prune.  While clear, idle holds only WARM
        # containers and pruning is skipped (the common case).
        self.idle_stale = False

    # ------------------------------------------------------------------
    def add_container(self, c: Container) -> None:
        self.containers[c.cid] = c
        self.live.add(c.cid)

    def evict(self, cid: int) -> None:
        self.containers[cid].state = State.EVICTED
        self.live.discard(cid)
        self.evictions += 1
        self.idle_stale = True

    def active_count(self) -> int:
        """Containers that occupy cluster capacity.  Provisioning prewarms
        are already in ``containers`` (state PROVISIONING), so the live set
        covers them."""
        return len(self.live)

    def prune_idle(self) -> None:
        # .get(): under the bounded-memory streaming discipline evicted
        # containers are deleted outright, not just flagged EVICTED
        cs = self.containers
        self.idle = [(ts, cid) for ts, cid in self.idle
                     for c in (cs.get(cid),)
                     if c is not None and c.state == State.WARM]
        self.idle_stale = False

    def inflight(self, cid: int) -> int:
        return len(self.inflight_ends.get(cid, ()))

    def earliest_free_s(self) -> Optional[float]:
        """Earliest time this fleet gains serving capacity: a running
        request completing, or a pending prewarm becoming warm."""
        ends = [e for ends in self.inflight_ends.values() for e in ends]
        ends += self.prewarm_etas
        return min(ends) if ends else None


class BarePool:
    """Cluster-shared stock of bare (bootstrapped, model-less) sandboxes.

    The cluster parks sandboxes here as their PROVISION/BOOTSTRAP phase
    chains finish; a claim hands the earliest-ready sandbox to a fleet
    (oldest first, so idle-billing is FIFO-fair) and the caller re-specs it
    to the claiming fleet's tier.  ``idle_sandbox_s`` accumulates the
    bare idle time billed by ``repro_torch.core.billing.sandbox_idle_cost``.
    """

    def __init__(self):
        self.ready: list[tuple[float, int]] = []     # (ready_at, cid)
        self.sandboxes: dict[int, Container] = {}    # all unclaimed, by cid
        self.claims = 0
        self.idle_sandbox_s = 0.0

    def add(self, c: Container) -> None:
        self.sandboxes[c.cid] = c

    def park(self, c: Container, t: float) -> None:
        """A sandbox finished BOOTSTRAP at ``t`` and is now claimable."""
        self.ready.append((t, c.cid))

    def claim(self, t: float) -> Optional[Container]:
        """Pop the earliest-ready sandbox, or None if none is ready yet."""
        if not self.ready:
            return None
        self.ready.sort()
        ready_at, cid = self.ready.pop(0)
        c = self.sandboxes.pop(cid)
        self.claims += 1
        self.idle_sandbox_s += max(0.0, t - ready_at)
        return c

    def settle(self, t_end: float) -> None:
        """Account idle time of still-unclaimed ready sandboxes at run end."""
        for ready_at, _ in self.ready:
            self.idle_sandbox_s += max(0.0, t_end - ready_at)


class Router:
    def __init__(self, fleets: dict[str, Fleet], default: str):
        self.fleets = fleets
        self.default = default

    def route(self, req) -> Fleet:
        fn = getattr(req, "fn", "") or self.default
        try:
            return self.fleets[fn]
        except KeyError:
            raise KeyError(f"request {req.rid} targets unknown function "
                           f"{fn!r}; deployed: {sorted(self.fleets)}")
