"""Policy-driven discrete-event cluster simulator.

Generalizes the original single-function ``Simulator`` event loop into a
multi-function cluster with pluggable placement / keep-alive / scaling /
cold-start policies, optional per-container concurrency, and batching-aware
fleets (``repro_torch.serving.batcher`` wired into the event loop).

Backwards compatibility is a hard invariant: with the default policy stack
(MRU placement, fixed-TTL keep-alive, Lambda-implicit scaling, FullCold
cold starts, concurrency 1, no batching) the event sequence — heap
tie-breaking, RNG draw order, container id allocation — is identical to the
old monolith, so the produced ``RequestRecord`` streams match bit-for-bit.

Event kinds (events.py): ARRIVAL / REQUEUE feed the router; COMPLETE frees a
container slot; EXPIRE evaluates the keep-alive deadline; PREWARM_READY
warms a predictively-provisioned container; FLUSH fires a batching fleet's
``max_wait_s`` deadline; PHASE_DONE advances a cold-starting container one
lifecycle phase (PROVISION -> BOOTSTRAP -> LOAD / RESTORE).

Cold starts are phase-resolved: a ``ColdStartPolicy`` plans which phases a
container still owes (a bare-pool claim owes only LOAD, a snapshot hit
PROVISION + RESTORE, ...), one jitter draw covers the remaining total (the
same RNG discipline for every policy), and — for every policy except the
bit-parity-pinned FullCold — PHASE_DONE events walk the container through
the intermediate states at the jitter-scaled phase boundaries.  Per-phase
wall times land on the ``RequestRecord`` either way.

The port's counterpart of ``repro.core.cluster.cluster``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import gc as _gc
from collections import deque
from heapq import heappop, heappush
from math import ceil as _ceil
from typing import Optional, Union

import numpy as np

from repro_torch.core import billing, resources
from repro_torch.core.autoscaler import ARRIVAL_HISTORY_S
from repro_torch.core.cluster import events as ev
from repro_torch.core.cluster.events import EventQueue, RecordArray
from repro_torch.core.cluster.policies import (ColdStartPolicy, FixedTTL, FullCold,
                                               KeepalivePolicy, LambdaImplicit,
                                               MRUPlacement, PlacementPolicy,
                                               ScalingPolicy, make_coldstart,
                                               make_keepalive, make_placement,
                                               make_scaling)
from repro_torch.core.cluster.router import BarePool, Fleet, Router
from repro_torch.core.container import Container, Phase, State
from repro_torch.core.faults import _SALT_BACKOFF, _u01
from repro_torch.core.function import FunctionSpec, Handler, batch_rel_cost
from repro_torch.core.workload import Request
from repro_torch.serving.batcher import PendingRequest

REQUEUE = ev.REQUEUE          # throttled arrival re-entering the loop
BATCH_RETRY = ev.BATCH_RETRY  # throttled formed batch retrying as a unit
_ARRIVAL_HISTORY_S = ARRIVAL_HISTORY_S  # arrival history fleets retain

# hot-loop constants (locals beat module attribute walks in the event loop)
_NET_S = resources.NETWORK_OVERHEAD_S
_TICK_S = billing.TICK_S
_NEG_INF = float("-inf")
_EMPTY: dict = {}
# pre-drawn jitter factors per refill; one lognormal(0, jitter) block drawn
# from the same generator IS the sequential scalar stream (numpy Generator
# array fills use the per-value sampler), so parity holds draw for draw
_JIT_CHUNK = 4096

# sentinel distinguishing "axis kwarg omitted" from an explicitly passed
# default, so the stack=-conflict guard sees every explicit argument
_UNSET = object()
# the legacy per-axis kwarg defaults — the single table the platform shim
# and PolicyStack.from_kwargs mirror (tests pin the shim equivalence)
AXIS_DEFAULTS = {"placement": "mru", "keepalive": None, "scaling": None,
                 "coldstart": None, "concurrency": 1, "batching": None,
                 "max_containers": 0, "sharding": None, "reliability": None}
_AXIS_DEFAULTS = AXIS_DEFAULTS
# seed offset for the gang lanes' sandbox-reclaim RNG: an independent
# stream so sharded runs never perturb the default stack's jitter draw
# order (any fixed offset works; a prime keeps it recognizable)
_RECLAIM_SEED_OFFSET = 104729
# success latencies a fleet remembers for the hedge-delay estimate, and
# the minimum history before the percentile replaces the warm-exec guess
_HEDGE_OBS = 256
_HEDGE_MIN_OBS = 16


class _RelState:
    """In-flight reliability bookkeeping for one request: every launched
    attempt's billed cost (``pending`` until the attempt resolves), the
    accumulated bill, and the retry/hedge scheduling flags.  Lives in
    ``ClusterSimulator._rel`` from first dispatch to final record."""

    __slots__ = ("req", "fname", "attempts", "pending", "cost", "done",
                 "prev_delay", "retry_pending", "hedged")

    def __init__(self, req, fname: str):
        self.req = req
        self.fname = fname          # serving fleet (degrade may reroute)
        self.attempts = 0           # attempts launched so far
        self.pending = {}           # attempt index -> its billed cost
        self.cost = 0.0             # total billed across attempts
        self.done = False           # a record has been written
        self.prev_delay = 0.0       # decorrelated-jitter backoff memory
        self.retry_pending = False  # a RETRY event is in the heap
        self.hedged = False         # the speculative duplicate is armed


class ClusterSimulator:
    """Multi-function serverless cluster with pluggable scheduling policies.

    Parameters
    ----------
    specs: one FunctionSpec, a list of them, or ``{name: spec}``.  Requests
        route by ``Request.fn`` (empty -> the first/default fleet).
    stack: a ``repro_torch.core.stack.PolicyStack`` — the preferred, serializable
        way to configure every policy axis at once.  ``stack.materialize()``
        builds fresh policy instances, so two simulators constructed from
        the same stack never share mutable policy state.  The stack owns
        every policy axis, so combining it with any per-axis kwarg below
        (or with ``keepalive_s``) raises — derive a variant with
        ``stack.with_(...)`` instead.
    placement / keepalive / scaling / coldstart: the legacy per-axis
        surface — policy instances or registry names
        (``"mru"|"lru"|"least_loaded"``, ``"fixed"|"adaptive"``,
        ``"lambda"|"predictive"``,
        ``"full"|"snapshot"|"layered"|"package_cache"``).  Instances are
        used as-is (the escape hatch for hand-written policy subclasses a
        stack cannot express); state isolation is then the caller's job.
    concurrency: in-flight requests a single container may hold; requests
        beyond the first slow each other down by ``contention`` each.
    batching: a ``BatchingConfig`` applied to every fleet, or a
        ``{fleet_name: BatchingConfig}`` for per-function batching.
    max_containers: shared cluster-wide cap across all fleets (0 = unlimited).
    """

    def __init__(self, specs: Union[FunctionSpec, list, dict], *,
                 stack=None,
                 placement=_UNSET, keepalive=_UNSET, scaling=_UNSET,
                 coldstart=_UNSET, keepalive_s: Optional[float] = None,
                 seed: int = 0,
                 jitter: float = 0.03, max_containers=_UNSET,
                 concurrency=_UNSET, contention: float = 0.3,
                 batching=_UNSET, sharding=_UNSET, reliability=_UNSET,
                 faults=None, max_requeue_rounds: int = 1000,
                 record_sink=None):
        axes = {"placement": placement, "keepalive": keepalive,
                "scaling": scaling, "coldstart": coldstart,
                "concurrency": concurrency, "batching": batching,
                "max_containers": max_containers, "sharding": sharding,
                "reliability": reliability}
        if stack is not None:
            if keepalive_s is not None:
                # keepalive_s is not one of the stack's axes, so it would
                # be dropped silently — make the conflict loud instead
                raise ValueError(
                    "keepalive_s conflicts with stack=; set the TTL on the "
                    "stack's KeepaliveConfig (stack.with_(keepalive="
                    "KeepaliveConfig(ttl_s=...))) instead")
            conflicts = [n for n, v in axes.items() if v is not _UNSET]
            if conflicts:
                raise ValueError(
                    f"{conflicts} conflict with stack= (the stack owns "
                    f"every policy axis); derive a variant with "
                    f"stack.with_(...) instead")
            # duck-typed (PolicyStack lives above this module in the import
            # graph): fresh policy instances per construction, centralizing
            # the state-isolation rules callers used to deep-copy for
            axes = stack.materialize()
        else:
            axes = {n: (_AXIS_DEFAULTS[n] if v is _UNSET else v)
                    for n, v in axes.items()}
        placement = axes["placement"]
        keepalive = axes["keepalive"]
        scaling = axes["scaling"]
        coldstart = axes["coldstart"]
        concurrency = axes["concurrency"]
        batching = axes["batching"]
        max_containers = axes["max_containers"]
        sharding = axes["sharding"]
        reliability = axes["reliability"]
        self.stack = stack
        if isinstance(specs, FunctionSpec):
            specs = {specs.name: specs}
        elif isinstance(specs, (list, tuple)):
            specs = {s.name: s for s in specs}
        if not specs:
            raise ValueError("ClusterSimulator needs at least one function")
        batch_by_fleet = (batching if isinstance(batching, dict)
                          else {name: batching for name in specs})
        fleets = {name: Fleet(name, spec, batch_by_fleet.get(name))
                  for name, spec in specs.items()}
        self.router = Router(fleets, default=next(iter(fleets)))
        self._fleets = fleets                       # hot-path alias
        self._default_fleet = fleets[self.router.default]

        # ---- distributed inference (gang-scheduled shard fan-out) ------
        # A normalized ShardingConfig (kind "none" flattens to None, the
        # single fast-path gate).  Each routed fleet gets ``fanout`` lane
        # fleets holding the shard sandboxes; lanes are NOT in the router
        # (requests route to the parent, the gang path fans out), but they
        # ARE in ``_evfleets`` so event handlers and eviction accounting
        # see them.
        if sharding is not None and getattr(sharding, "kind", "gang") == \
                "none":
            sharding = None
        self.sharding = sharding
        self._gang: dict[str, list] = {}      # parent fleet -> lane fleets
        self._plans: dict = {}                # parent fleet -> ShardPlan
        self._channels: dict = {}             # parent fleet -> CommsChannel
        self._lane_parent: dict[str, str] = {}
        self._reclaim_f: dict[int, float] = {}   # cid -> TTL reclaim factor
        self._comms_bytes = 0.0       # activation bytes moved via channels
        self._comms_cost = 0.0        # their per-GB transfer dollars
        self._gang_prewarm_cost = 0.0
        self._gang_prewarm_until = _NEG_INF
        if sharding is not None:
            from repro_torch.core import distributed, providers
            for name, fleet in fleets.items():
                plan = distributed.plan_for_spec(fleet.spec, sharding.fanout)
                lspec = distributed.lane_spec(fleet.spec, plan)
                lanes = [Fleet(f"{name}#s{i}", lspec)
                         for i in range(plan.fanout)]
                self._gang[name] = lanes
                self._plans[name] = plan
                for lane in lanes:
                    self._lane_parent[lane.name] = name
                prof = providers.get(fleet.spec.provider)
                self._channels[name] = prof.comms_channel(sharding.channel)
            self._reclaim_rng = np.random.default_rng(
                seed + _RECLAIM_SEED_OFFSET)
            self._evfleets = dict(fleets)
            for lanes in self._gang.values():
                for lane in lanes:
                    self._evfleets[lane.name] = lane
        else:
            self._evfleets = fleets

        # ---- reliability axis + fault injection (DESIGN.md §11) --------
        # A normalized ReliabilityConfig (kind "none" flattens to None via
        # materialize(), the fast-path gate key) and a built FaultModel
        # (an all-zeros FaultConfig flattens to None the same way).
        if reliability is not None and hasattr(reliability, "materialize"):
            reliability = reliability.materialize()
        self.reliability = reliability
        if faults is not None and hasattr(faults, "build"):
            faults = faults.build()
        self.faults = faults
        self._rel_path = reliability is not None or faults is not None
        if self._rel_path and any(b is not None
                                  for b in batch_by_fleet.values()):
            raise ValueError(
                "batching cannot be combined with reliability= or faults= "
                "(a formed batch has no per-request attempt identity); "
                "drop one of the two axes")
        self._rel: dict[int, _RelState] = {}   # rid -> in-flight state
        self._recent_fails: deque = deque()    # failure times (shed window)
        self._lat_obs: dict[str, deque] = {}   # fleet -> success latencies
        # capacity-requeue starvation cap: after this many REQUEUE /
        # BATCH_RETRY rounds a request stops waiting and cold-starts past
        # the shared cap (the bounded-starvation guarantee); the surviving
        # round count lands on the record's ``requeues`` field
        self.max_requeue_rounds = int(max_requeue_rounds)
        self._requeue_rounds: dict[int, int] = {}

        self.placement: PlacementPolicy = make_placement(placement)
        self.keepalive: KeepalivePolicy = make_keepalive(
            keepalive, 480.0 if keepalive_s is None else keepalive_s)
        self.scaling: ScalingPolicy = make_scaling(scaling)
        self.coldstart: ColdStartPolicy = make_coldstart(coldstart)

        self.rng = np.random.default_rng(seed)
        # Fast paths that also pin default-stack bit-parity: FixedTTL never
        # needs lazy idle re-checks, LambdaImplicit never tracks arrivals,
        # FullCold charges the whole cold anatomy in one collapsed step
        # instead of PHASE_DONE events.
        self._lazy_evict = not isinstance(self.keepalive, FixedTTL)
        self._track_arrivals = not isinstance(self.scaling, LambdaImplicit)
        self._phased = not isinstance(self.coldstart, FullCold)
        # more hot-path specializations, all behaviour-neutral: a constant
        # TTL is read without a method call, FixedTTL's no-op gap observer
        # is skipped, and exact-type MRU placement inlines to max()
        self._ttl_const = (self.keepalive.ttl_s
                           if type(self.keepalive) is FixedTTL else None)
        self._observe_gaps = type(self.keepalive) is not FixedTTL
        self._mru = type(self.placement) is MRUPlacement
        self._jit_buf = None       # pre-drawn lognormal jitter factors
        self._jit_pos = 0
        self.jitter = jitter
        self.max_containers = max_containers
        self.concurrency = max(1, int(concurrency))
        self.contention = contention
        # record_sink: an alternative record sink (e.g. a fold/spill-mode
        # ``StreamingRecordArray`` for day-scale runs).  A folded sink
        # flips the bounded-memory discipline on: evicted containers are
        # deleted from their fleet instead of lingering as EVICTED husks,
        # so cluster state stays O(live containers) over a 10M-request day.
        self.records = RecordArray() if record_sink is None else record_sink
        self._drop_evicted = getattr(self.records, "fold", None) is not None
        self.prewarms = 0
        self.events = 0            # loop iterations (simloop_bench reads it)
        self._active_n = 0         # O(1) live-container count across fleets
        # LayeredPool infrastructure: the cluster-shared bare-sandbox pool
        self.pool: Optional[BarePool] = (BarePool()
                                         if self.coldstart.pool_size > 0
                                         else None)
        # The fused fast loop (``_run_fast``) serves exactly the policy
        # region whose specializations above are all engaged: fixed TTL,
        # no prewarming, collapsed FullCold, exact-type MRU, concurrency 1,
        # no shared cap, no batching, no bare pool.  Inside it, dispatch /
        # complete / expire are handled inline with no per-event method
        # calls — the bit-parity contract still holds (same RNG draw
        # order, same heap tie-breaking, same container id allocation).
        self._fast = (self._mru and self._ttl_const is not None
                      and not self._lazy_evict and not self._track_arrivals
                      and not self._phased and self.concurrency == 1
                      and not self.max_containers and self.pool is None
                      and self.sharding is None and not self._rel_path
                      and all(f.batcher is None for f in fleets.values())
                      # bill-idle (GPU serverless) fleets need per-eviction
                      # up-time accounting the fused loops skip
                      and not any(f.bill_idle for f in fleets.values()))
        self._pool_spec: Optional[FunctionSpec] = None
        self.mitigation_cost = 0.0  # snapshot storage + pool idle + idle
        self.sim_end_s = 0.0        #  GPU capacity ($, by _finalize)
        self.idle_capacity_cost = 0.0  # bill-idle fleets: capacity $ beyond
                                       # the exec ticks already billed

    # ------------------------------------------------------------- accessors
    @property
    def fleets(self) -> dict[str, Fleet]:
        return self.router.fleets

    @property
    def containers(self) -> dict[int, Container]:
        out: dict[int, Container] = {}
        for f in self.fleets.values():
            out.update(f.containers)
        return out

    @property
    def cold_starts(self) -> int:
        return sum(f.cold_starts for f in self.fleets.values())

    @property
    def evictions(self) -> int:
        # _evfleets includes the gang lane fleets (the shard sandboxes are
        # where sharded evictions actually happen); without sharding it IS
        # the router's fleet dict
        return sum(f.evictions for f in self._evfleets.values())

    # ------------------------------------------------------------------ util
    def _jit(self, x: float) -> float:
        """``x`` scaled by one lognormal(0, jitter) draw.

        Draws come from a pre-drawn block refilled ``_JIT_CHUNK`` at a time:
        a numpy ``Generator`` array fill consumes the bit stream exactly
        like the same number of scalar calls, so the factors — and every
        record derived from them — are bit-identical to the pre-buffering
        scalar path."""
        if self.jitter <= 0:
            return x
        buf, i = self._jit_buf, self._jit_pos
        if buf is None or i >= _JIT_CHUNK:
            buf = self._jit_buf = self.rng.lognormal(0.0, self.jitter,
                                                     _JIT_CHUNK)
            i = 0
        self._jit_pos = i + 1
        return float(x * buf[i])

    def _active_total(self) -> int:
        """Live containers across all fleets — an O(1) counter maintained by
        ``_add_container``/``_evict`` (recomputing per arrival/prewarm was
        the sim loop's hottest redundant work; simloop_bench tracks it)."""
        return self._active_n

    def _add_container(self, fleet: Fleet, c: Container) -> None:
        fleet.add_container(c)
        self._active_n += 1

    def _evict(self, fleet: Fleet, cid: int, t: float = 0.0) -> None:
        if fleet.bill_idle:
            # per-second provider billing covers the container's whole
            # up-time; settle it at eviction (live containers settle in
            # _finalize)
            c = fleet.containers.get(cid)
            if c is not None:
                fleet.up_seconds += max(0.0, t - c.created_at)
        fleet.evict(cid)
        if self._drop_evicted:
            del fleet.containers[cid]
        self._active_n -= 1

    def _schedule_expire(self, q: EventQueue, fleet: Fleet, cid: int,
                         deadline: float) -> None:
        if deadline > fleet.expire_sched.get(cid, -np.inf):
            fleet.expire_sched[cid] = deadline
            q.push(deadline, ev.EXPIRE, (fleet.name, cid))

    def _ttl_for(self, fname: str) -> float:
        """Keep-alive TTL for a fleet — gang lanes look up the *parent*
        function's TTL (AdaptiveTTL observes gaps at the parent, where the
        arrivals are; lane names would never accumulate a histogram)."""
        ttl = self._ttl_const
        if ttl is None:
            if self._lane_parent:
                fname = self._lane_parent.get(fname, fname)
            ttl = self.keepalive.ttl(fname)
        return ttl

    def _reclaim_factor(self, cid: int) -> float:
        """Effective-TTL factor for one gang lane sandbox.  Co-placed gangs
        share one reclamation domain (factor 1.0 — the policy TTL holds
        exactly); independently placed shards sit in different domains and
        the provider may reclaim any of them *early* (one-sided lognormal,
        clamped at 1.0 — reclamation never extends a TTL), which is what
        multiplies the gang's cold tail."""
        f = self._reclaim_f.get(cid)
        if f is None:
            sh = self.sharding
            if sh.co_place or sh.reclaim_sigma <= 0.0:
                f = 1.0
            else:
                f = min(1.0, float(self._reclaim_rng.lognormal(
                    0.0, sh.reclaim_sigma)))
            self._reclaim_f[cid] = f
        return f

    # -------------------------------------------------- cold-start phases
    def _schedule_phases(self, q: EventQueue, fname: str, c: Container,
                         t: float, plan: list) -> tuple:
        """Charge ``plan`` (remaining ``(Phase, seconds)`` pairs) with ONE
        jitter draw and drive the container through it with PHASE_DONE
        events.  Returns ``(setup_s, walls)`` where ``walls`` maps each
        Phase to its jittered wall time; the last boundary is pinned to
        ``t + setup_s`` so the chain lands exactly on the dispatch-side
        ready time."""
        total = sum(d for _, d in plan)
        if total <= 0.0:
            return 0.0, {}
        setup = self._jit(total)
        factor = setup / total
        walls: dict = {}
        entries = []
        cum = 0.0
        for i, (ph, dur) in enumerate(plan):
            if i < len(plan) - 1:
                w = dur * factor
                cum += w
                boundary = t + cum
            else:
                w = setup - cum
                boundary = t + setup
            walls[ph] = w
            entries.append((ph, w, boundary))
        c.phase_plan = entries
        c.phase_idx = 0
        q.push(entries[0][2], ev.PHASE_DONE, (fname, c.cid))
        return setup, walls

    def _cold_setup(self, q: EventQueue, fleet: Fleet, c: Container,
                    t: float) -> tuple:
        """Charge the container's remaining cold phases with PHASE_DONE
        events.  Only reached under a phased (non-FullCold) coldstart
        policy: FullCold's collapsed single-step path — identical RNG call,
        no extra events, the bit-parity contract — lives inline in
        ``_dispatch``, which computes the analytic per-phase split there
        without building a walls dict."""
        plan = self.coldstart.plan(fleet.spec, c)
        return self._schedule_phases(q, fleet.name, c, t, plan)

    def _spawn_pool_sandbox(self, q: EventQueue, t: float) -> None:
        """Start provisioning one bare sandbox for the shared pool (initial
        fill and post-claim replenishment)."""
        if self._pool_spec is None:
            self._pool_spec = FunctionSpec(
                handler=Handler(name="_bare", base_cpu_seconds=0.0,
                                bootstrap_cpu_seconds=(
                                    self.coldstart.bootstrap_cpu_seconds),
                                package_mb=0.0, peak_memory_mb=0.0),
                memory_mb=self.coldstart.pool_memory_mb)
        c = Container(self._pool_spec, created_at=t, role="pool")
        self.pool.add(c)
        self._schedule_phases(q, "", c, t, self.coldstart.pool_plan())

    def _on_phase_done(self, q: EventQueue, t: float, payload) -> None:
        fname, cid = payload
        if fname:
            fleet = self._evfleets[fname]
            c = fleet.containers.get(cid)
        else:
            fleet = None
            c = self.pool.sandboxes.get(cid) if self.pool else None
        if c is None or c.state == State.EVICTED or \
                c.phase_idx >= len(c.phase_plan):
            return
        ph, wall, _ = c.phase_plan[c.phase_idx]
        c.mark_done(ph, wall)
        c.phase_idx += 1
        if c.phase_idx < len(c.phase_plan):
            # advance to the next phase; BUSY containers (dispatch-bound
            # colds already serving a request) keep their scheduling state,
            # idle chains park at the lifecycle milestone just reached
            if c.state != State.BUSY:
                c.state = c.parked_state(ph)
            q.push(c.phase_plan[c.phase_idx][2], ev.PHASE_DONE, payload)
            return
        # ---- chain complete
        if c.role == "pool":
            c.state = State.BOOTSTRAPPED
            self.pool.park(c, t)
            return
        # dispatch- or prewarm-bound chains end with the model available
        # (LOAD, RESTORE, or a package-cache hit that skipped LOAD)
        c.completed.add(Phase.LOAD)
        if c.role == "prewarm":
            fleet.pending_prewarms -= 1
            fleet.prewarm_etas.remove(t)
            c.state = State.WARM
            c.ready_at = t
            c.last_used_at = t
            fleet.idle.append((t, cid))
            ttl = self._ttl_for(fname)
            if fname in self._lane_parent:
                ttl *= self._reclaim_factor(cid)
            self._schedule_expire(q, fleet, cid, t + ttl)
        self.coldstart.on_loaded(fname, fleet.spec, t)

    @staticmethod
    def _cold_kind(walls: dict) -> str:
        if Phase.RESTORE in walls:
            return "restore"
        if Phase.LOAD not in walls:
            return "cache"
        if Phase.PROVISION not in walls and Phase.BOOTSTRAP not in walls:
            return "pool"
        return "full"

    # ------------------------------------------------------------------- run
    def run(self, requests) -> RecordArray:
        """Serve ``requests`` (a list, or any iterable in arrival order);
        returns the (columnar) record sink.

        Arrival fast path: every trace generator emits requests in arrival
        order, so instead of heaping a million arrivals the loop merges the
        sorted request stream against the (small) heap of dynamic events.
        The merge preserves the old tie-breaking exactly — arrivals used to
        be pushed before any dynamic event existed, so their sequence
        numbers were lower and an arrival won every same-timestamp tie;
        here the merge pops the arrival whenever ``arrival_s <= head``.
        An unsorted trace falls back to heaping arrivals as before.

        Under the default-stack policy region (``self._fast``) the run is
        served by ``_run_fast``, a fused loop producing bit-identical
        records; non-list iterables are then consumed lazily with O(1)
        lookahead, so a 10M-request generator never materializes — the
        streamed half of the day-scale discipline (the other half is a
        fold/spill ``record_sink``).
        """
        if self._fast:
            # The fused loops allocate millions of small acyclic objects
            # (record tuples, heap entries, containers) and create no
            # reference cycles, so everything they free is freed by
            # refcounting alone — generational GC passes only re-scan the
            # survivors over and over.  Pausing collection for the run's
            # duration (cycle detection deferred, not lost) is worth
            # ~25% wall time at the 1M-request scale.
            loop = (self._run_fast_single if len(self._fleets) == 1
                    else self._run_fast)
            if not _gc.isenabled():
                return loop(requests)
            _gc.disable()
            try:
                return loop(requests)
            finally:
                _gc.enable()
        arr = requests if isinstance(requests, list) else list(requests)
        return self._run_general(arr)

    def _run_general(self, arr: list) -> RecordArray:
        """The any-policy event loop (see ``run``)."""
        q = EventQueue()
        heap = q._heap
        n_arr = len(arr)
        if self.sharding is not None and arr:
            # gang prewarm replaces reclaimed shard sandboxes, but only
            # while demand can still arrive — without this horizon the
            # evict -> prewarm -> evict cycle would outlive the trace and
            # the drain loop would never terminate
            self._gang_prewarm_until = max(r.arrival_s for r in arr)
        last = _NEG_INF
        merged = True
        for r in arr:
            a = r.arrival_s
            if a < last:
                merged = False
                break
            last = a
        ai = 0
        if not merged:                    # rare: unsorted trace, old path
            for r in arr:
                q.push(r.arrival_s, ev.ARRIVAL, r)
            ai = n_arr
        if self.pool is not None and not self.pool.sandboxes:
            for _ in range(self.coldstart.pool_size):   # initial pool fill
                self._spawn_pool_sandbox(q, 0.0)

        on_arrival = self._on_arrival
        on_complete = self._on_complete
        on_expire = self._on_expire
        COMPLETE, EXPIRE, ARRIVAL = ev.COMPLETE, ev.EXPIRE, ev.ARRIVAL
        PREWARM_READY, FLUSH, PHASE_DONE = (ev.PREWARM_READY, ev.FLUSH,
                                            ev.PHASE_DONE)
        FAULT, RETRY, HEDGE_FIRE, ATTEMPT_DONE = (ev.FAULT, ev.RETRY,
                                                  ev.HEDGE_FIRE,
                                                  ev.ATTEMPT_DONE)
        events = self.events
        t = 0.0
        while True:
            if ai < n_arr:
                r = arr[ai]
                ta = r.arrival_s
                if not heap or ta <= heap[0][0]:
                    ai += 1
                    t = ta
                    events += 1
                    on_arrival(q, ta, r, True)
                    continue
            elif not heap:
                break
            item = heappop(heap)
            t = item[0]
            kind = item[2]
            events += 1
            if kind == COMPLETE:
                on_complete(t, item[3])
            elif kind == EXPIRE:
                on_expire(q, t, item[3])
            elif kind == PREWARM_READY:
                self._on_prewarm_ready(q, t, item[3])
            elif kind == FLUSH:
                self._on_flush(q, t, item[3])
            elif kind == PHASE_DONE:
                self._on_phase_done(q, t, item[3])
            elif kind == BATCH_RETRY:
                fname, reqs = item[3]
                self._dispatch(q, self._fleets[fname], t, reqs)
            elif kind == FAULT:
                self._on_fault(q, t, item[3])
            elif kind == RETRY:
                self._on_retry(q, t, item[3])
            elif kind == HEDGE_FIRE:
                self._on_hedge_fire(q, t, item[3])
            elif kind == ATTEMPT_DONE:
                self._on_attempt_done(q, t, item[3])
            else:  # ARRIVAL / REQUEUE
                on_arrival(q, t, item[3], kind == ARRIVAL)
        self.events = events
        self._finalize(t)
        return self.records

    def _run_fast(self, requests) -> RecordArray:
        """Fused event loop for the default-stack policy region.

        One inlined pass replaces the ``_on_arrival`` -> ``_dispatch`` /
        ``_on_complete`` / ``_on_expire`` call chain; every loop-invariant
        value is a local.  Three structural savings over the general loop,
        each provably behaviour-neutral in this region:

        * ``expire_sched`` is not maintained: with a fixed TTL and
          concurrency 1 a container's dispatch deadlines (``end + ttl``)
          are strictly increasing, so the general loop's dedup check always
          passed — every dispatch pushes its EXPIRE unconditionally, and a
          stale EXPIRE (container reused since) is recognized by the
          ``last_used_at`` test alone, exactly as before.
        * ``inflight_ends`` is not maintained: it feeds only the shared-cap
          throttling path (``_make_room``) and the concurrency > 1 WARM
          transition guard, neither of which exists here; a COMPLETE always
          finds its container BUSY with exactly one request in flight.
        * Event payloads carry (fleet, container) object references, so
          handlers never re-resolve names through dicts.

        Records are bit-identical to the general loop: RNG draw order (exec
        before cold setup, one shared lognormal block stream), heap
        tie-breaking (one seq counter, COMPLETE pushed before EXPIRE), and
        container id allocation are preserved.  Cosmetic post-run state the
        general loop leaves behind (``last_arrival_s``, ``expire_sched``)
        is skipped — nothing outside the loop reads it.

        A non-list ``requests`` is consumed lazily (O(1) lookahead) and
        must be in arrival order; an unsorted *list* falls back to the
        general heaped path, unchanged.

        Single-fleet runs (the simloop_bench configuration) take the
        further-specialized ``_run_fast_single`` variant; ``run`` picks
        the loop and pauses generational GC around either.
        """
        if isinstance(requests, list):
            last = _NEG_INF
            for r in requests:
                a = r.arrival_s
                if a < last:
                    return self._run_general(requests)  # rare: unsorted
                last = a
            check_sorted = False
        else:
            check_sorted = True
        it = iter(requests)

        q = EventQueue()
        heap = q._heap
        seq = q._seq
        fleets = self._fleets
        default_fleet = self._default_fleet
        route = self.router.route
        records = self.records
        if type(records) is RecordArray:
            row_sink = records._rows.append       # plain sink: no chunking
            tag_sink = records.tags_seen.add
        else:
            row_sink = records.append_row         # chunked/fold/spill sink
            tag_sink = None
        rng_lognormal = self.rng.lognormal
        jitter = self.jitter
        do_jit = jitter > 0.0
        # jitter block state: jlist is the current numpy block as exact
        # python floats (x * jlist[i] is bit-identical to the general
        # loop's float(x * buf[i]) — same IEEE doubles, same multiply)
        jarr = self._jit_buf
        jlist = jarr.tolist() if jarr is not None else None
        jpos = self._jit_pos if jarr is not None else _JIT_CHUNK
        ttl = self._ttl_const
        ttl_eps = ttl - 1e-9
        drop_evicted = self._drop_evicted
        active_n = self._active_n
        events = self.events
        net = _NET_S
        tick = _TICK_S
        ceil_ = _ceil
        nxt = next
        heappush_, heappop_ = heappush, heappop
        WARM, BUSY, EVICTED = State.WARM, State.BUSY, State.EVICTED
        PROV, BOOT, LOADP = Phase.PROVISION, Phase.BOOTSTRAP, Phase.LOAD

        t = 0.0
        prev_a = _NEG_INF
        r = nxt(it, None)
        while True:
            if r is not None:
                ta = r.arrival_s
                if not heap or ta <= heap[0][0]:
                    # ---------------- ARRIVAL + inline dispatch ----------
                    events += 1
                    t = ta
                    req = r
                    r = nxt(it, None)
                    if check_sorted:
                        if ta < prev_a:
                            raise ValueError(
                                f"streamed trace is not in arrival order "
                                f"(rid {req.rid} at {ta} after {prev_a}); "
                                f"materialize it to a list to heap-sort "
                                f"arrivals")
                        prev_a = ta
                    fn = req.fn
                    if fn:
                        fleet = fleets.get(fn)
                        if fleet is None:
                            fleet = route(req)  # raises the nice KeyError
                    else:
                        fleet = default_fleet
                    if fleet.idle_stale:
                        fleet.prune_idle()
                    idle = fleet.idle
                    if idle:
                        entry = max(idle)       # MRUPlacement, inlined
                        idle.remove(entry)
                        c = fleet.containers[entry[1]]
                        cold = False
                    else:
                        cold = True
                        c = Container(fleet.spec, created_at=ta)
                        fleet.cold_starts += 1
                        fleet.containers[c.cid] = c
                        fleet.live.add(c.cid)
                        active_n += 1
                    # exec draw first, then cold-setup draw (RNG parity)
                    if do_jit:
                        if jpos >= _JIT_CHUNK:
                            jarr = rng_lognormal(0.0, jitter, _JIT_CHUNK)
                            jlist = jarr.tolist()
                            jpos = 0
                        exec_s = fleet.warm_exec_s * jlist[jpos]
                        jpos += 1
                    else:
                        exec_s = fleet.warm_exec_s
                    if cold:
                        total = fleet.cold_total_s
                        if do_jit and total > 0.0:
                            if jpos >= _JIT_CHUNK:
                                jarr = rng_lognormal(0.0, jitter, _JIT_CHUNK)
                                jlist = jarr.tolist()
                                jpos = 0
                            setup = total * jlist[jpos]
                            jpos += 1
                            factor = setup / total
                        else:
                            setup = total
                            factor = 1.0 if total > 0.0 else 0.0
                        bd = fleet.cold_bd
                        prov = bd.provision_s * factor
                        boot = bd.bootstrap_s * factor
                        load = setup - prov - boot
                        comp = c.completed     # mark_done x3, inlined (a
                        comp.add(PROV)         # fresh container: no prior
                        comp.add(BOOT)         # phase_times to accumulate)
                        comp.add(LOADP)
                        pt = c.phase_times
                        pt[PROV] = prov
                        pt[BOOT] = boot
                        pt[LOADP] = load
                        kind_s = "full"
                        start = ta + setup
                        c.ready_at = start
                    else:
                        prov = boot = load = 0.0
                        kind_s = ""
                        start = ta   # an idle container is always ready
                    end = start + exec_s + net
                    c.state = BUSY
                    c.last_used_at = end   # conc 1: end > previous end
                    c.invocations += 1
                    heappush_(heap, (end, nxt(seq), 1, (fleet, c)))
                    heappush_(heap, (end + ttl, nxt(seq), 2, (fleet, c)))
                    ticks = ceil_(exec_s / tick)
                    if ticks < 1:
                        ticks = 1
                    row_sink((req.rid, ta, start, end, cold, exec_s,
                              exec_s, ticks * fleet.price_100ms, c.cid,
                              fleet.memory_mb, req.tag, fleet.name, 1,
                              kind_s, prov, boot, load, 0.0,
                              True, 1, 0.0, 0))
                    if tag_sink is not None:
                        tag_sink(req.tag)
                    continue
            elif not heap:
                break
            item = heappop_(heap)
            t = item[0]
            events += 1
            fc = item[3]
            c = fc[1]
            if item[2] == 1:
                # ---------------------- COMPLETE ------------------------
                # a BUSY container (never evicted in flight here) frees its
                # single slot and joins the idle list
                c.state = WARM
                fc[0].idle.append((t, c.cid))
            elif c.state is WARM and t - c.last_used_at >= ttl_eps:
                # ------------------------ EXPIRE ------------------------
                # stale checks (container reused since this was scheduled)
                # fall through as no-ops: the reuse pushed a later EXPIRE
                fleet = fc[0]
                cid = c.cid
                c.state = EVICTED
                fleet.live.discard(cid)
                fleet.evictions += 1
                fleet.idle_stale = True
                if drop_evicted:
                    del fleet.containers[cid]
                active_n -= 1
        self.events = events
        self._active_n = active_n
        self._jit_buf = jarr
        self._jit_pos = jpos
        self._finalize(t)
        return self.records

    def _run_fast_single(self, requests) -> RecordArray:
        """``_run_fast`` further specialized for one fleet.

        Everything per-fleet becomes a loop-local (no attribute loads per
        event), heap entries carry the ``Container`` and its cid directly
        (no payload tuple, no name re-resolution), the seq tie-breaker is a
        plain int, the next arrival's time is cached between iterations,
        and an eviction removes its own idle entry directly — a WARM
        container's idle entry is exactly ``(last_used_at, cid)``, so the
        flag-and-prune round trip disappears.  MRU placement reads
        ``idle[-1]``: COMPLETE events pop in time order, so the idle list
        is always sorted by completion time.  All still bit-identical to
        the general loop (same parity argument as ``_run_fast``).
        """
        if isinstance(requests, list):
            last = _NEG_INF
            for r in requests:
                a = r.arrival_s
                if a < last:
                    return self._run_general(requests)  # rare: unsorted
                last = a
            check_sorted = False
        else:
            check_sorted = True
        it = iter(requests)

        heap: list = []
        fleet = self._default_fleet
        fname = fleet.name
        route = self.router.route
        containers = fleet.containers
        live = fleet.live
        idle = fleet.idle
        idle_append = idle.append
        spec = fleet.spec
        warm_exec = fleet.warm_exec_s
        cold_total = fleet.cold_total_s
        bd = fleet.cold_bd
        prov_frac = bd.provision_s
        boot_frac = bd.bootstrap_s
        price = fleet.price_100ms
        mem = fleet.memory_mb
        cold_starts_n = fleet.cold_starts
        evictions_n = fleet.evictions
        records = self.records
        if type(records) is RecordArray:
            row_sink = records._rows.append       # plain sink: no chunking
            tag_sink = records.tags_seen.add
        else:
            row_sink = records.append_row         # chunked/fold/spill sink
            tag_sink = None
        rng_lognormal = self.rng.lognormal
        jitter = self.jitter
        do_jit = jitter > 0.0
        jarr = self._jit_buf
        jlist = jarr.tolist() if jarr is not None else None
        jpos = self._jit_pos if jarr is not None else _JIT_CHUNK
        ttl = self._ttl_const
        ttl_eps = ttl - 1e-9
        drop_evicted = self._drop_evicted
        active_n = self._active_n
        events = self.events
        net = _NET_S
        tick = _TICK_S
        ceil_ = _ceil
        nxt = next
        heappush_, heappop_ = heappush, heappop
        WARM, BUSY, EVICTED = State.WARM, State.BUSY, State.EVICTED
        PROV, BOOT, LOADP = Phase.PROVISION, Phase.BOOTSTRAP, Phase.LOAD
        Container_ = Container
        INF = float("inf")
        n_rows0 = len(records)

        # ``self.events`` is settled arithmetically at the end: in this
        # policy region every arrival dispatches exactly one request,
        # every dispatch pushes exactly one COMPLETE and one EXPIRE, and
        # the drain pops them all — so loop iterations are exactly
        # 3 x dispatches, the same count the general loop accumulates.
        t = 0.0
        head_t = INF               # heap[0][0] mirror (INF when empty)
        prev_a = _NEG_INF
        seqn = 0
        r = nxt(it, None)
        ta = r.arrival_s if r is not None else INF
        while True:
            if ta <= head_t:
                # ------------------ ARRIVAL + inline dispatch ------------
                if r is None:
                    break          # arrivals exhausted AND heap drained
                req = r
                t_arr = ta
                r = nxt(it, None)
                ta = r.arrival_s if r is not None else INF
                if check_sorted:
                    if t_arr < prev_a:
                        raise ValueError(
                            f"streamed trace is not in arrival order "
                            f"(rid {req.rid} at {t_arr} after {prev_a}); "
                            f"materialize it to a list to heap-sort "
                            f"arrivals")
                    prev_a = t_arr
                fn = req.fn
                if fn and fn != fname:
                    route(req)              # raises the nice KeyError
                if idle:
                    # COMPLETE events pop in time order, so idle is always
                    # sorted by completion time: MRU = the last entry.
                    # Exact ties (identical end times, possible only with
                    # jitter 0) fall back to max() for bit-parity with
                    # MRUPlacement's (ts, cid) tuple ordering.
                    entry = idle[-1]
                    if len(idle) > 1 and idle[-2][0] == entry[0]:
                        entry = max(idle)
                        idle.remove(entry)
                    else:
                        idle.pop()
                    cid = entry[1]
                    c = containers[cid]
                    cold = False
                else:
                    cold = True
                    c = Container_(spec, created_at=t_arr)
                    cid = c.cid
                    cold_starts_n += 1
                    containers[cid] = c
                    live.add(cid)
                    active_n += 1
                # exec draw first, then cold-setup draw (RNG parity)
                if do_jit:
                    if jpos >= _JIT_CHUNK:
                        jarr = rng_lognormal(0.0, jitter, _JIT_CHUNK)
                        jlist = jarr.tolist()
                        jpos = 0
                    exec_s = warm_exec * jlist[jpos]
                    jpos += 1
                else:
                    exec_s = warm_exec
                if cold:
                    if do_jit and cold_total > 0.0:
                        if jpos >= _JIT_CHUNK:
                            jarr = rng_lognormal(0.0, jitter, _JIT_CHUNK)
                            jlist = jarr.tolist()
                            jpos = 0
                        setup = cold_total * jlist[jpos]
                        jpos += 1
                        factor = setup / cold_total
                    else:
                        setup = cold_total
                        factor = 1.0 if cold_total > 0.0 else 0.0
                    prov = prov_frac * factor
                    boot = boot_frac * factor
                    load = setup - prov - boot
                    comp = c.completed     # mark_done x3, inlined
                    comp.add(PROV)
                    comp.add(BOOT)
                    comp.add(LOADP)
                    pt = c.phase_times
                    pt[PROV] = prov
                    pt[BOOT] = boot
                    pt[LOADP] = load
                    kind_s = "full"
                    start = t_arr + setup
                    c.ready_at = start
                else:
                    prov = boot = load = 0.0
                    kind_s = ""
                    start = t_arr   # an idle container is always ready
                end = start + exec_s + net
                c.state = BUSY
                c.last_used_at = end   # conc 1: end > previous end
                c.invocations += 1
                heappush_(heap, (end, seqn, 1, c, cid))
                heappush_(heap, (end + ttl, seqn + 1, 2, c, cid))
                seqn += 2
                if end < head_t:
                    head_t = end
                ticks = ceil_(exec_s / tick)
                if ticks < 1:
                    ticks = 1
                row_sink((req.rid, t_arr, start, end, cold, exec_s,
                          exec_s, ticks * price, cid, mem, req.tag,
                          fname, 1, kind_s, prov, boot, load, 0.0,
                          True, 1, 0.0, 0))
                if tag_sink is not None:
                    tag_sink(req.tag)
                continue
            t, _sq, kind, c, cid = heappop_(heap)
            head_t = heap[0][0] if heap else INF
            if kind == 1:
                # ---------------------- COMPLETE ------------------------
                c.state = WARM
                idle_append((t, cid))
            elif c.state is WARM and t - c.last_used_at >= ttl_eps:
                # ------------------------ EXPIRE ------------------------
                c.state = EVICTED
                live.discard(cid)
                evictions_n += 1
                idle.remove((c.last_used_at, cid))
                if drop_evicted:
                    del containers[cid]
                active_n -= 1
        fleet.cold_starts = cold_starts_n
        fleet.evictions = evictions_n
        self.events += 3 * (len(records) - n_rows0)
        self._active_n = active_n
        self._jit_buf = jarr
        self._jit_pos = jpos
        self._finalize(t)
        return self.records

    def _finalize(self, t_end: float) -> None:
        """Settle the platform-side spend beyond the per-request exec bills:
        mitigation costs (snapshot storage held to end of run, bare-pool
        idle — zero under FullCold) and, for bill-idle providers (GPU
        serverless), the capacity remainder — per-second billing of each
        container's whole up-time minus the exec ticks the records already
        carry.  Both fold into ``mitigation_cost``, which the suite reports
        as ``mitigation_per_1k``."""
        self.sim_end_s = t_end
        fin = getattr(self.records, "finalize", None)
        if fin is not None:
            fin()               # fold/spill the sink's final partial chunk
        cost = 0.0
        if self.pool is not None:
            self.pool.settle(t_end)
            cost += billing.sandbox_idle_cost(self.pool.idle_sandbox_s)
        for _fn, size_mb, written_at in self.coldstart.snapshots():
            cost += billing.snapshot_storage_cost(
                size_mb, max(0.0, t_end - written_at))
        # sharded fan-out: per-GB activation transfer through the comms
        # channel + the gang-prewarm sandboxes' setup ticks
        cost += self._comms_cost + self._gang_prewarm_cost
        cap = 0.0
        for f in self._evfleets.values():
            if not f.bill_idle:
                continue
            up = f.up_seconds
            for cid in f.live:
                up += max(0.0, t_end - f.containers[cid].created_at)
            cap += max(0.0, up * f.per_second_usd - f.billed_cost)
        self.idle_capacity_cost = cap
        self.mitigation_cost = cost + cap

    # ------------------------------------------------------------- complete
    def _on_complete(self, t: float, payload) -> None:
        fname, cid, end = payload
        fleet = self._evfleets[fname]
        inflight_ends = fleet.inflight_ends
        ends = inflight_ends.get(cid)
        if ends:
            ends.remove(end)
            if not ends:
                del inflight_ends[cid]
        c = fleet.containers.get(cid)
        if c is not None and cid not in inflight_ends and \
                c.state is not State.EVICTED:
            c.state = State.WARM
            fleet.idle.append((t, cid))

    # --------------------------------------------------------------- expire
    def _on_expire(self, q: EventQueue, t: float, payload) -> None:
        fname, cid = payload
        fleet = self._evfleets[fname]
        c = fleet.containers.get(cid)
        if c is None or c.state is not State.WARM:
            return
        is_lane = fname in self._lane_parent
        ttl = self._ttl_for(fname)
        if is_lane:
            # a lane sandbox's *effective* TTL carries its placement
            # domain's reclaim factor (1.0 when co-placed)
            ttl *= self._reclaim_factor(cid)
        if t - c.last_used_at >= ttl - 1e-9:
            self._evict(fleet, cid, t)
            if is_lane:
                self._reclaim_f.pop(cid, None)
                sh = self.sharding
                if sh.gang_prewarm and t < self._gang_prewarm_until:
                    self._gang_prewarm(q, fleet, t)
        else:
            # Not yet expired under the *current* TTL (it may have grown, or
            # the container was reused).  A reuse already scheduled a later
            # check; only adaptive TTL growth needs a fresh one.
            self._schedule_expire(q, fleet, cid, c.last_used_at + ttl)

    # -------------------------------------------------------------- prewarm
    def _on_prewarm_ready(self, q: EventQueue, t: float, payload) -> None:
        fname, cid = payload
        fleet = self._evfleets[fname]
        fleet.pending_prewarms -= 1
        fleet.prewarm_etas.remove(t)
        c = fleet.containers[cid]
        if c.state != State.PROVISIONING:
            return
        c.state = State.WARM
        c.ready_at = t
        c.last_used_at = t
        fleet.idle.append((t, cid))
        ttl = self._ttl_for(fname)
        if fname in self._lane_parent:
            ttl *= self._reclaim_factor(cid)
        self._schedule_expire(q, fleet, cid, t + ttl)

    def _maybe_prewarm(self, q: EventQueue, fleet: Fleet, t: float) -> None:
        if not self._track_arrivals:     # LambdaImplicit never prewarms
            return
        if self.sharding is not None:
            # parent fleets hold no sandboxes under sharding — replacement
            # warming happens per lane via the gang_prewarm knob instead
            return
        n = self.scaling.prewarm_count(
            now=t, arrivals=fleet.arrivals,
            warm_exec_s=fleet.warm_exec_s,
            active=fleet.active_count())
        for _ in range(n):
            if self.max_containers and \
                    self._active_total() >= self.max_containers:
                break
            c = Container(fleet.spec, created_at=t)
            self._add_container(fleet, c)
            fleet.pending_prewarms += 1
            self.prewarms += 1
            if not self._phased:
                setup = self._jit(fleet.cold_total_s)
                fleet.prewarm_etas.append(t + setup)
                q.push(t + setup, ev.PREWARM_READY, (fleet.name, c.cid))
            else:
                # phase-resolved prewarm: the PHASE_DONE chain warms the
                # container (and e.g. a snapshot hit provisions it faster)
                c.role = "prewarm"
                setup, _ = self._schedule_phases(
                    q, fleet.name, c, t, self.coldstart.plan(fleet.spec, c))
                fleet.prewarm_etas.append(t + setup)

    # -------------------------------------------------------------- arrival
    def _on_arrival(self, q: EventQueue, t: float, req: Request,
                    fresh: bool) -> None:
        fn = req.fn
        if not fn:
            fleet = self._default_fleet
        else:
            fleet = self._fleets.get(fn)
            if fleet is None:
                fleet = self.router.route(req)    # raises the nice KeyError
        if fresh:
            last = fleet.last_arrival_s
            if last is not None and self._observe_gaps:
                # FixedTTL's observer is a no-op; skip the call entirely
                self.keepalive.observe_gap(fleet.name, t - last)
            fleet.last_arrival_s = t
            if self._track_arrivals:
                fleet.arrivals.append(t)
                if fleet.arrivals[0] < t - _ARRIVAL_HISTORY_S:
                    fleet.arrivals = [a for a in fleet.arrivals
                                      if a >= t - _ARRIVAL_HISTORY_S]
                self._maybe_prewarm(q, fleet, t)

        if fleet.batcher is not None:
            fleet.batcher.submit(PendingRequest(
                rid=req.rid, tokens=[], arrival_s=t, n_new=0))
            fleet.pending_reqs[req.rid] = req
            if fleet.batcher.ready(t):
                self._on_flush(q, t, fleet.name)
            else:
                self._schedule_flush(q, fleet)
            return

        if self._rel_path:
            self._dispatch_reliable(q, fleet, t, req)
            return
        self._dispatch(q, fleet, t, (req,))

    # ---------------------------------------------------------------- flush
    def _schedule_flush(self, q: EventQueue, fleet: Fleet) -> None:
        """Push one FLUSH at the queue head's deadline, deduplicated —
        deadlines only move forward as the head advances."""
        nxt = fleet.batcher.next_flush_at()
        if nxt is not None and nxt > fleet.flush_sched_t:
            fleet.flush_sched_t = nxt
            q.push(nxt, ev.FLUSH, fleet.name)

    def _on_flush(self, q: EventQueue, t: float, fname: str) -> None:
        fleet = self.fleets[fname]
        while True:
            batch = fleet.batcher.form_batch(t)
            if batch is None:
                break
            reqs = [fleet.pending_reqs.pop(rid) for rid in batch.rids]
            self._dispatch(q, fleet, t, reqs)
        self._schedule_flush(q, fleet)

    # ------------------------------------------------------------- dispatch
    def _lazy_evict_stale(self, fleet: Fleet, now: float) -> None:
        """Adaptive TTLs can *shrink* after an expire event was scheduled;
        evict idle containers the current TTL says are dead before placing.
        Never runs under FixedTTL, whose scheduled expiries are exact (and
        whose tie-breaking the bit-parity contract pins)."""
        ttl = self.keepalive.ttl(fleet.name)
        containers = fleet.containers
        for _, cid in fleet.idle:
            c = containers.get(cid)
            if c is not None and c.state == State.WARM and \
                    now - c.last_used_at >= ttl - 1e-9:
                self._evict(fleet, cid, now)

    def _candidates(self, fleet: Fleet, now: float) -> list:
        if self._lazy_evict:
            self._lazy_evict_stale(fleet, now)
        if fleet.idle_stale:
            # only an eviction can leave a non-WARM cid in the idle list;
            # while the flag is clear the old unconditional rebuild was a
            # per-dispatch no-op (the hot loop's biggest allocation)
            fleet.prune_idle()
        if self.concurrency <= 1:
            return fleet.idle
        return [(c.last_used_at, cid) for cid in fleet.live
                for c in (fleet.containers[cid],)
                if c.state in (State.WARM, State.BUSY)
                and fleet.inflight(cid) < self.concurrency]

    def _gang_prewarm(self, q: EventQueue, lane: Fleet, t: float) -> None:
        """Replace a just-reclaimed shard sandbox ahead of demand: start a
        fresh lane cold start now so the *next* gang request finds the
        lane warm instead of eating a full gang cold.  The setup ticks
        bill as platform-side spend (``mitigation_cost``) — requests never
        see this container until PREWARM_READY parks it idle."""
        c = Container(lane.spec, created_at=t)
        self._add_container(lane, c)
        lane.pending_prewarms += 1
        self.prewarms += 1
        setup = self._jit(lane.cold_total_s)
        lane.prewarm_etas.append(t + setup)
        q.push(t + setup, ev.PREWARM_READY, (lane.name, c.cid))
        ticks = _ceil(setup / _TICK_S)
        if ticks < 1:
            ticks = 1
        self._gang_prewarm_cost += ticks * lane.price_100ms

    def _dispatch_gang(self, q: EventQueue, fleet: Fleet, t: float,
                       reqs: list, base_attempts: int = 1) -> None:
        """One logical request fans out to ``fleet``'s gang: every lane
        (shard sandbox fleet) serves a sub-invoke, and the request joins
        on the slowest lane plus the decode steps' channel time.  The
        request is cold if ANY lane cold-started — the FSD-Inference tail
        multiplication — and its bill is the sum of the lanes' exec ticks
        plus the per-GB activation transfer (billed into
        ``mitigation_cost`` by ``_finalize``).

        Under an active fault model each lane additionally draws per-lane
        crash fates (1-(1-p)^N multiplies the failure tail like the cold
        tail); a crashed lane bills its elapsed work and — within the
        reliability axis's ``max_attempts`` budget — retries after a
        decorrelated-jitter backoff with a fresh sandbox setup.  A lane
        that faults past the budget fails the whole gang request
        (``ok=False``).  ``base_attempts`` counts gang-level attempts
        already spent upstream (storm-throttle retries).
        """
        sh = self.sharding
        lanes = self._gang[fleet.name]
        plan = self._plans[fleet.name]
        b = len(reqs)
        bmul = 1.0
        if b > 1:
            curve = fleet.batch_curve
            if curve is not None:
                bmul = b * batch_rel_cost(curve, b)
            elif fleet.batching is not None:
                bmul = 1.0 + fleet.batching.amortization * (b - 1)
        heap, seq = q._heap, q._seq
        ttl = self._ttl_for(fleet.name)
        fm = self.faults
        rel = self.reliability
        rel_max = rel.max_attempts if rel is not None else 1
        rel_base = rel.backoff_base_s if rel is not None else 0.2
        rel_cap = rel.backoff_cap_s if rel is not None else 5.0
        rid0 = reqs[0].rid
        gang_ok = True
        max_lane_att = 1
        any_cold = False
        cold_kind = ""
        start_max = t           # all shards ready: the gang's exec begin
        crit_end = _NEG_INF     # slowest lane's own completion
        crit_cid = -1
        crit_walls = (0.0, 0.0, 0.0, 0.0)
        cost = 0.0              # per-request exec $ summed over lanes
        for lane_i, lane in enumerate(lanes):
            if lane.idle_stale:
                lane.prune_idle()
            idle = lane.idle
            if idle:
                entry = max(idle)            # MRU within the lane
                idle.remove(entry)
                c = lane.containers[entry[1]]
                cold = False
            else:
                cold = True
                c = Container(lane.spec, created_at=t)
                lane.cold_starts += 1
                self._add_container(lane, c)
            cid = c.cid
            # per lane: exec draw first, then cold-setup draw — the same
            # RNG discipline as the single-sandbox path, N times over
            exec_s = self._jit(lane.warm_exec_s) * bmul
            prov = boot = load = rest = 0.0
            kind = ""
            if cold:
                if not self._phased:
                    bd = lane.cold_bd
                    total = lane.cold_total_s
                    setup = self._jit(total)
                    factor = setup / total if total > 0 else 0.0
                    prov = bd.provision_s * factor
                    boot = bd.bootstrap_s * factor
                    load = setup - prov - boot
                    c.mark_done(Phase.PROVISION, prov)
                    c.mark_done(Phase.BOOTSTRAP, boot)
                    c.mark_done(Phase.LOAD, load)
                    kind = "full"
                else:
                    setup, walls = self._cold_setup(q, lane, c, t)
                    prov = walls.get(Phase.PROVISION, 0.0)
                    boot = walls.get(Phase.BOOTSTRAP, 0.0)
                    load = walls.get(Phase.LOAD, 0.0)
                    rest = walls.get(Phase.RESTORE, 0.0)
                    kind = self._cold_kind(walls)
                start = t + setup
                c.ready_at = start
                if not any_cold:
                    cold_kind = kind
                any_cold = True
            else:
                ra = c.ready_at
                start = t if t >= ra else ra
            # ---- lane faults: mid-exec crashes retried within the
            # reliability budget.  Retries reuse the already-drawn exec
            # value and a nominal fresh setup (no extra main-RNG draws, so
            # fault fates stay identical across policy stacks); the
            # crashed elapsed work bills like any errored invoke.
            lane_extra = 0.0
            if fm is not None:
                lane_att = 1
                prev_d = rel_base
                cf = fm.lane_crash_frac(rid0, lane_att, lane_i)
                while cf is not None:
                    crashed = exec_s * cf
                    cost += billing.errored_invocation_cost(
                        crashed / b, lane.memory_mb)
                    if lane_att >= rel_max:
                        gang_ok = False
                        lane_extra += crashed
                        break
                    u = fm.backoff_u(rid0, lane_att)
                    delay = min(rel_cap,
                                rel_base + (3.0 * prev_d - rel_base) * u)
                    prev_d = delay
                    # the dead sandbox is replaced: pay a full cold setup
                    lane_extra += crashed + delay + lane.cold_total_s
                    lane_att += 1
                    cf = fm.lane_crash_frac(rid0, lane_att, lane_i)
                if lane_att > max_lane_att:
                    max_lane_att = lane_att
            end = start + lane_extra + exec_s + _NET_S
            c.state = State.BUSY
            if end > c.last_used_at:
                c.last_used_at = end
            c.invocations += b
            ends = lane.inflight_ends.get(cid)
            if ends is None:
                ends = lane.inflight_ends[cid] = []
            ends.append(end)
            heappush(heap, (end, next(seq), ev.COMPLETE,
                            (lane.name, cid, end)))
            deadline = end + ttl * self._reclaim_factor(cid)
            if deadline > lane.expire_sched.get(cid, _NEG_INF):
                lane.expire_sched[cid] = deadline
                heappush(heap, (deadline, next(seq), ev.EXPIRE,
                                (lane.name, cid)))
            ticks = _ceil((exec_s / b) / _TICK_S)
            if ticks < 1:
                ticks = 1
            lane_cost = ticks * lane.price_100ms
            cost += lane_cost
            if lane.bill_idle:
                lane.billed_cost += lane_cost * b
            if start > start_max:
                start_max = start
            if end > crit_end:
                crit_end = end
                crit_cid = cid
                crit_walls = (prov, boot, load, rest)
        if any_cold:
            fleet.cold_starts += 1    # request-level gang colds
        # ---- join on the slowest lane + the decode steps' channel time
        comms_s = 0.0
        if plan.bytes_per_step > 0.0:
            step_b = plan.step_bytes(b)            # per shard, this batch
            comms_s = self._channels[fleet.name].request_s(
                step_b, sh.steps_per_request)
            moved = step_b * plan.fanout * sh.steps_per_request
            self._comms_bytes += moved
            self._comms_cost += billing.transfer_cost(
                moved, self._channels[fleet.name].usd_per_gb)
        end = crit_end + comms_s
        wall = end - start_max
        prov, boot, load, rest = crit_walls if any_cold else (0.0, 0.0,
                                                             0.0, 0.0)
        append_row = self.records.append_row
        share = wall / b
        n_att = base_attempts + max_lane_att - 1
        if b == 1:
            req = reqs[0]
            append_row((req.rid, req.arrival_s, start_max, end, any_cold,
                        wall, wall, cost, crit_cid, fleet.memory_mb,
                        req.tag, fleet.name, 1, cold_kind, prov, boot,
                        load, rest, gang_ok, n_att, 0.0, 0))
        else:
            for req in reqs:
                append_row((req.rid, req.arrival_s, start_max, end,
                            any_cold, wall, share, cost, crit_cid,
                            fleet.memory_mb, req.tag, fleet.name, b,
                            cold_kind, prov, boot, load, rest, gang_ok,
                            n_att, 0.0, 0))

    def _dispatch(self, q: EventQueue, fleet: Fleet, t: float,
                  reqs: list) -> None:
        """Place ``reqs`` (a single request, or one formed batch) on a warm
        container or cold-start one, honoring the shared container cap."""
        if self.sharding is not None:
            return self._dispatch_gang(q, fleet, t, reqs)
        concurrency = self.concurrency
        if concurrency > 1 or self.placement.needs_inflight:
            inflight = {cid: fleet.inflight(cid) for cid in fleet.live}
        else:
            inflight = _EMPTY
        cands = self._candidates(fleet, t)
        chosen: Optional[Container] = None
        cold = claimed = False
        if not cands:
            cid = None
        elif self._mru:
            cid = max(cands)[1]            # MRUPlacement.choose, inlined
        else:
            cid = self.placement.choose(cands, inflight)
        if cid is not None:
            chosen = fleet.containers[cid]
            idle = fleet.idle
            for j, entry in enumerate(idle):
                if entry[1] == cid:        # cids are unique in idle
                    del idle[j]
                    break
        else:
            if self.max_containers and \
                    self._active_n >= self.max_containers:
                if not self._make_room(q, fleet, t, reqs):
                    return                      # requeued behind a busy slot
            chosen = self.pool.claim(t) if self.pool is not None else None
            if chosen is not None:
                # bare-sandbox claim: a PREWARM start in the OpenWhisk
                # taxonomy, not a cold start — the sandbox was provisioned
                # and bootstrapped ahead of demand, the request only pays
                # the LOAD phase.  Re-spec to this fleet's tier (balloon
                # resize, modelled free).
                claimed = True
                chosen.spec = fleet.spec
                chosen.role = "dispatch"
            else:
                cold = True
                chosen = Container(fleet.spec, created_at=t)
                fleet.cold_starts += 1
            self._add_container(fleet, chosen)
        ccid = chosen.cid

        # ---- timing: exec draw first, then cold-setup draw (RNG parity)
        exec_s = self._jit(fleet.warm_exec_s)
        b = len(reqs)
        if b > 1:
            curve = fleet.batch_curve
            if curve is None:
                exec_s *= 1.0 + fleet.batching.amortization * (b - 1)
            else:
                # measured batch-efficiency: a fused batch of b costs
                # b * rel_per_request(b) of a single pass
                exec_s *= b * batch_rel_cost(curve, b)
        if concurrency > 1:
            # with concurrency 1 a dispatch target never has work in
            # flight (idle or freshly created), so k == 1 always
            k = fleet.inflight(ccid) + 1
            if k > 1:
                exec_s *= 1.0 + self.contention * (k - 1)
        prov = boot = load = rest = 0.0
        kind = ""
        if cold or claimed:
            if not self._phased:
                # collapsed FullCold fast path: one jitter draw over the
                # cached per-fleet anatomy, no walls dict, no PHASE_DONE
                bd = fleet.cold_bd
                total = fleet.cold_total_s
                setup = self._jit(total)
                factor = setup / total if total > 0 else 0.0
                prov = bd.provision_s * factor
                boot = bd.bootstrap_s * factor
                load = setup - prov - boot
                chosen.mark_done(Phase.PROVISION, prov)
                chosen.mark_done(Phase.BOOTSTRAP, boot)
                chosen.mark_done(Phase.LOAD, load)
                kind = "full"
            else:
                setup, walls = self._cold_setup(q, fleet, chosen, t)
                prov = walls.get(Phase.PROVISION, 0.0)
                boot = walls.get(Phase.BOOTSTRAP, 0.0)
                load = walls.get(Phase.LOAD, 0.0)
                rest = walls.get(Phase.RESTORE, 0.0)
                kind = self._cold_kind(walls)
            start = t + setup
            chosen.ready_at = start
            if claimed:            # keep the shared pool at standing size
                self._spawn_pool_sandbox(q, t)
        else:
            # a concurrency > 1 follow-up placed on a still-provisioning
            # container queues until the cold start finishes
            ra = chosen.ready_at
            start = t if t >= ra else ra
        end = start + exec_s + _NET_S

        chosen.state = State.BUSY
        # max(): with concurrency > 1 a later, shorter request must not move
        # the container's recency backwards past a still-running one
        if end > chosen.last_used_at:
            chosen.last_used_at = end
        chosen.invocations += b
        ends = fleet.inflight_ends.get(ccid)
        if ends is None:
            ends = fleet.inflight_ends[ccid] = []
        ends.append(end)
        fname = fleet.name
        heap, seq = q._heap, q._seq
        heappush(heap, (end, next(seq), ev.COMPLETE, (fname, ccid, end)))
        ttl = self._ttl_const
        if ttl is None:
            ttl = self.keepalive.ttl(fname)
        deadline = end + ttl
        if deadline > fleet.expire_sched.get(ccid, _NEG_INF):
            fleet.expire_sched[ccid] = deadline
            heappush(heap, (deadline, next(seq), ev.EXPIRE, (fname, ccid)))

        # ---- billing + records (batch wall time amortized per request)
        share = exec_s / b
        ticks = _ceil(share / _TICK_S)      # billing.billed_ticks, inlined
        if ticks < 1:
            ticks = 1
        cost = ticks * fleet.price_100ms
        if fleet.bill_idle:
            # remember the exec $ billed so _finalize can charge only the
            # capacity remainder (up-time beyond the billed exec ticks)
            fleet.billed_cost += cost * b
        mem = fleet.spec.memory_mb
        append_row = self.records.append_row
        rq = (self._requeue_rounds.pop(reqs[0].rid, 0)
              if self._requeue_rounds else 0)
        if b == 1:
            req = reqs[0]
            append_row((req.rid, req.arrival_s, start, end, cold, exec_s,
                        exec_s, cost, ccid, mem, req.tag, fname, 1, kind,
                        prov, boot, load, rest, True, 1, 0.0, rq))
        else:
            for req in reqs:
                append_row((req.rid, req.arrival_s, start, end, cold,
                            exec_s, share, cost, ccid, mem, req.tag, fname,
                            b, kind, prov, boot, load, rest, True, 1, 0.0,
                            rq))

    # ------------------------------------------------------------ throttling
    def _make_room(self, q: EventQueue, fleet: Fleet, t: float,
                   reqs: list) -> bool:
        """At the shared cap with no local warm capacity.  Prefer the old
        Simulator's behaviour — queue behind this fleet's earliest-free
        container; across fleets, evict another fleet's LRU idle container
        to make room, else wait for the cluster-wide earliest completion.
        Returns True when the caller may proceed with a cold start."""
        until = fleet.earliest_free_s()
        if until is not None:
            return not self._requeue_capped(q, fleet, until, reqs)
        victims = [(f.containers[cid].last_used_at, cid, f)
                   for f in self.fleets.values() if f is not fleet
                   for cid in f.live if f.containers[cid].state == State.WARM]
        if victims:
            _, vcid, vfleet = min(victims)
            self._evict(vfleet, vcid, t)
            return True
        ends = [f.earliest_free_s() for f in self.fleets.values()]
        ends = [e for e in ends if e is not None]
        if ends:
            return not self._requeue_capped(q, fleet, min(ends), reqs)
        return True   # nothing to wait for: exceed the cap rather than drop

    def _requeue_capped(self, q: EventQueue, fleet: Fleet, until: float,
                        reqs: list) -> bool:
        """Requeue ``reqs`` and return True — unless the work has already
        waited ``max_requeue_rounds`` rounds, in which case return False
        and let the caller cold-start past the shared cap.  The bound
        turns the REQUEUE/BATCH_RETRY loop from potentially unbounded
        (a saturated cluster can starve one request indefinitely) into a
        hard guarantee; the per-request round count survives onto the
        record's ``requeues`` field (batch members share the head's
        count)."""
        rid = reqs[0].rid
        n = self._requeue_rounds.get(rid, 0) + 1
        if n > self.max_requeue_rounds:
            return False
        self._requeue_rounds[rid] = n
        self._requeue(q, fleet, until, reqs)
        return True

    def _requeue(self, q: EventQueue, fleet: Fleet, until: float,
                 reqs: list) -> None:
        """Throttled work re-enters at ``until``.  A formed batch retries
        dispatch as a unit — re-submitting members to the batcher would
        disband it and charge another max_wait_s per throttle round."""
        if fleet.batcher is not None:
            q.push(until, BATCH_RETRY, (fleet.name, reqs))
        else:
            for req in reqs:
                q.push(until, REQUEUE, req)

    # ---------------------------------------------- reliability dispatch
    # The attempt machine (DESIGN.md §11).  One resolution event per
    # attempt, outcome decided at dispatch time from the fault model's
    # counter-based fates:
    #
    #   success        COMPLETE@end frees the container, ATTEMPT_DONE@end
    #                  (pushed after, same timestamp -> pops after) writes
    #                  the record; billed in full.
    #   crash          FAULT@crash_t evicts the sandbox and resolves;
    #                  the elapsed exec is billed (Lambda bills errored
    #                  invokes).
    #   timeout        the sandbox completes (and bills) normally, but
    #                  FAULT@t+timeout_s with cid=-1 (no evict) resolves
    #                  the attempt as failed — the client gave up.
    #   provision fail FAULT@t+detect evicts the half-built sandbox;
    #                  nothing is billed (the provider ate the host).
    #   throttle/cap   resolved inline — nothing started, nothing billed;
    #                  RETRY@t+backoff or final failure.
    #
    # Every attempt's bill lands on the request state at dispatch, so the
    # winner's record carries the complete cost; duplicates still in
    # flight at the winning completion are classified as hedge waste.

    def _storm_pressure(self, t: float) -> int:
        """Failures observed within the shed window ending at ``t``."""
        rel = self.reliability
        window = rel.shed_window_s if rel is not None else 30.0
        fails = self._recent_fails
        cutoff = t - window
        while fails and fails[0] < cutoff:
            fails.popleft()
        return len(fails)

    def _note_failure(self, t: float) -> None:
        self._recent_fails.append(t)

    def _backoff_delay(self, st: _RelState) -> float:
        """Exponential backoff with decorrelated jitter:
        ``min(cap, uniform(base, 3 * prev))`` — the uniform comes from the
        fault hash keyed by (rid, attempt), never the main jitter RNG."""
        rel = self.reliability
        base = rel.backoff_base_s
        fm = self.faults
        u = (fm.backoff_u(st.req.rid, st.attempts) if fm is not None
             else _u01(0, st.req.rid, st.attempts, _SALT_BACKOFF))
        prev = st.prev_delay if st.prev_delay > 0.0 else base
        delay = min(rel.backoff_cap_s, base + (3.0 * prev - base) * u)
        st.prev_delay = delay
        return delay

    def _observe_latency(self, fname: str, lat: float) -> None:
        obs = self._lat_obs.get(fname)
        if obs is None:
            obs = self._lat_obs[fname] = deque(maxlen=_HEDGE_OBS)
        obs.append(lat)

    def _hedge_delay(self, fleet: Fleet) -> float:
        """When to fire the speculative duplicate: the fleet's observed
        p-``hedge_quantile`` attempt latency once enough history exists,
        else a warm-exec multiple; ``hedge_min_s`` floors both."""
        rel = self.reliability
        obs = self._lat_obs.get(fleet.name)
        if obs is not None and len(obs) >= _HEDGE_MIN_OBS:
            arr = np.fromiter(obs, dtype=float, count=len(obs))
            d = float(np.percentile(arr, rel.hedge_quantile * 100.0))
        else:
            d = 3.0 * fleet.warm_exec_s
        return max(d, rel.hedge_min_s)

    def _dispatch_reliable(self, q: EventQueue, fleet: Fleet, t: float,
                           req: Request) -> None:
        """Entry point for every arrival while reliability and/or faults
        are active (the general loop only; the fused fast loops gate
        themselves off)."""
        rel = self.reliability
        st = self._rel.get(req.rid)
        if st is None:
            if rel is not None and rel.kind == "degrade" and \
                    self._storm_pressure(t) >= rel.shed_threshold:
                if rel.degrade_to:
                    df = self._fleets.get(rel.degrade_to)
                    if df is not None:
                        fleet = df    # failure storm: serve degraded
                else:
                    # pure load-shed: fail fast, bill nothing
                    st = _RelState(req, fleet.name)
                    self._fail_request(t, st)
                    return
            st = _RelState(req, fleet.name)
            self._rel[req.rid] = st
        if self.sharding is not None:
            # gang fan-out: storms throttle the whole gang dispatch here;
            # per-lane crash fates are drawn inside _dispatch_gang
            attempt = st.attempts
            st.attempts += 1
            fm = self.faults
            if fm is not None and fm.throttled(t, req.rid, attempt):
                self._attempt_failed(q, t, st)
                return
            n_att = st.attempts
            self._rel.pop(req.rid, None)
            self._dispatch_gang(q, fleet, t, (req,), base_attempts=n_att)
            return
        self._start_attempt(q, t, st)

    def _start_attempt(self, q: EventQueue, t: float,
                       st: _RelState) -> None:
        rel = self.reliability
        fm = self.faults
        fleet = self._fleets[st.fname]
        req = st.req
        rid = req.rid
        attempt = st.attempts
        st.attempts += 1
        st.retry_pending = False
        # ---- throttle storm / shared cap: nothing starts, nothing bills.
        # The designated degrade fleet is exempt: it models a fallback in
        # a different resource class (smaller tier / other region), which
        # is what routing around a capacity storm means.
        storm_exempt = (rel is not None and rel.degrade_to != "" and
                        st.fname == rel.degrade_to)
        if fm is not None and not storm_exempt and \
                fm.throttled(t, rid, attempt):
            self._attempt_failed(q, t, st)
            return
        # ---- arm the hedge on the primary attempt (fires only if the
        # request is still unresolved when the delay elapses)
        if rel is not None and attempt == 0 and not st.hedged and \
                rel.kind in ("hedge", "degrade") and rel.max_attempts > 1:
            st.hedged = True
            q.push(t + self._hedge_delay(fleet), ev.HEDGE_FIRE, rid)
        # ---- placement (the _dispatch logic for one request, with the
        # shared-cap wait replaced by throttle-style backoff — a full
        # cluster refuses like a 429 instead of parking the arrival)
        concurrency = self.concurrency
        if concurrency > 1 or self.placement.needs_inflight:
            inflight = {cid: fleet.inflight(cid) for cid in fleet.live}
        else:
            inflight = _EMPTY
        cands = self._candidates(fleet, t)
        chosen: Optional[Container] = None
        cold = claimed = False
        if not cands:
            cid = None
        elif self._mru:
            cid = max(cands)[1]
        else:
            cid = self.placement.choose(cands, inflight)
        if cid is not None:
            chosen = fleet.containers[cid]
            idle = fleet.idle
            for j, entry in enumerate(idle):
                if entry[1] == cid:
                    del idle[j]
                    break
        else:
            if self.max_containers and \
                    self._active_n >= self.max_containers:
                self._attempt_failed(q, t, st)     # capacity 429
                return
            chosen = self.pool.claim(t) if self.pool is not None else None
            if chosen is not None:
                claimed = True
                chosen.spec = fleet.spec
                chosen.role = "dispatch"
            else:
                cold = True
                chosen = Container(fleet.spec, created_at=t)
                fleet.cold_starts += 1
            self._add_container(fleet, chosen)
        ccid = chosen.cid
        fname = st.fname
        # ---- provision failure: the sandbox never becomes ready; the
        # client notices a fraction into the nominal setup.  Unbilled.
        if cold and fm is not None and fm.provision_fails(rid, attempt):
            detect = fleet.cold_total_s * \
                fm.provision_detect_frac(rid, attempt)
            chosen.state = State.BUSY     # not placeable while half-built
            q.push(t + detect, ev.FAULT, (fname, ccid, rid, attempt))
            return
        # ---- timing: exec draw first, then cold-setup draw (the general
        # loop's RNG discipline; fault fates never touch this stream)
        exec_s = self._jit(fleet.warm_exec_s)
        if concurrency > 1:
            k = fleet.inflight(ccid) + 1
            if k > 1:
                exec_s *= 1.0 + self.contention * (k - 1)
        prov = boot = load = rest = 0.0
        kind = ""
        if cold or claimed:
            if not self._phased:
                bd = fleet.cold_bd
                total = fleet.cold_total_s
                setup = self._jit(total)
                factor = setup / total if total > 0 else 0.0
                prov = bd.provision_s * factor
                boot = bd.bootstrap_s * factor
                load = setup - prov - boot
                chosen.mark_done(Phase.PROVISION, prov)
                chosen.mark_done(Phase.BOOTSTRAP, boot)
                chosen.mark_done(Phase.LOAD, load)
                kind = "full"
            else:
                setup, walls = self._cold_setup(q, fleet, chosen, t)
                prov = walls.get(Phase.PROVISION, 0.0)
                boot = walls.get(Phase.BOOTSTRAP, 0.0)
                load = walls.get(Phase.LOAD, 0.0)
                rest = walls.get(Phase.RESTORE, 0.0)
                kind = self._cold_kind(walls)
            start = t + setup
            chosen.ready_at = start
            if claimed:
                self._spawn_pool_sandbox(q, t)
        else:
            ra = chosen.ready_at
            start = t if t >= ra else ra
        mem = fleet.spec.memory_mb
        # ---- mid-execution crash: the sandbox dies partway; the elapsed
        # work is billed (Lambda bills errored invokes) and FAULT evicts
        crash_f = fm.crash_frac(rid, attempt) if fm is not None else None
        if crash_f is not None:
            elapsed = exec_s * crash_f
            crash_t = start + elapsed
            cost = billing.errored_invocation_cost(elapsed, mem)
            st.cost += cost
            st.pending[attempt] = cost
            if fleet.bill_idle:
                fleet.billed_cost += cost
            chosen.state = State.BUSY
            if crash_t > chosen.last_used_at:
                chosen.last_used_at = crash_t
            chosen.invocations += 1
            q.push(crash_t, ev.FAULT, (fname, ccid, rid, attempt))
            return
        # ---- the attempt runs to completion: bill + schedule, exactly
        # as _dispatch does for b == 1
        end = start + exec_s + _NET_S
        ticks = _ceil(exec_s / _TICK_S)
        if ticks < 1:
            ticks = 1
        cost = ticks * fleet.price_100ms
        st.cost += cost
        st.pending[attempt] = cost
        if fleet.bill_idle:
            fleet.billed_cost += cost
        chosen.state = State.BUSY
        if end > chosen.last_used_at:
            chosen.last_used_at = end
        chosen.invocations += 1
        ends = fleet.inflight_ends.get(ccid)
        if ends is None:
            ends = fleet.inflight_ends[ccid] = []
        ends.append(end)
        heap, seq = q._heap, q._seq
        heappush(heap, (end, next(seq), ev.COMPLETE, (fname, ccid, end)))
        ttl = self._ttl_const
        if ttl is None:
            ttl = self.keepalive.ttl(fname)
        deadline = end + ttl
        if deadline > fleet.expire_sched.get(ccid, _NEG_INF):
            fleet.expire_sched[ccid] = deadline
            heappush(heap, (deadline, next(seq), ev.EXPIRE, (fname, ccid)))
        # ---- client-side timeout beats the completion?  The sandbox
        # still finishes (and bills) — only the client walks away.
        if rel is not None and rel.timeout_s > 0.0 and \
                end - t > rel.timeout_s:
            q.push(t + rel.timeout_s, ev.FAULT, (fname, -1, rid, attempt))
            return
        q.push(end, ev.ATTEMPT_DONE,
               (rid, attempt, start, end, cold or claimed, exec_s, ccid,
                kind, prov, boot, load, rest, t))

    def _attempt_failed(self, q: EventQueue, t: float,
                        st: _RelState) -> None:
        """One attempt is dead and already unbooked; retry within budget,
        else fail the request once no sibling attempt can still win."""
        self._note_failure(t)
        rel = self.reliability
        if st.done:
            return
        if rel is not None and st.attempts < rel.max_attempts and \
                not st.retry_pending:
            st.retry_pending = True
            q.push(t + self._backoff_delay(st), ev.RETRY, st.req.rid)
        elif not st.pending and not st.retry_pending:
            self._fail_request(t, st)

    def _fail_request(self, t: float, st: _RelState) -> None:
        """Out of budget: write the failure record — ``ok=False``, zero
        useful work, ``end_s`` = the give-up time, ``cost`` = every dollar
        burned trying."""
        st.done = True
        fleet = self._fleets[st.fname]
        req = st.req
        self.records.append_row((req.rid, req.arrival_s, t, t, False, 0.0,
                                 0.0, st.cost, -1, fleet.memory_mb,
                                 req.tag, st.fname, 1, "", 0.0, 0.0, 0.0,
                                 0.0, False, st.attempts, 0.0, 0))
        self._rel.pop(req.rid, None)

    def _rel_release(self, st: _RelState) -> None:
        """Drop the request state once resolved and no attempt is still in
        flight (late losers need it to classify their resolution)."""
        if st.done and not st.pending and not st.retry_pending:
            self._rel.pop(st.req.rid, None)

    def _on_fault(self, q: EventQueue, t: float, payload) -> None:
        fname, cid, rid, attempt = payload
        if cid >= 0:
            fleet = self._evfleets[fname]
            c = fleet.containers.get(cid)
            if c is not None and c.state is not State.EVICTED:
                self._evict(fleet, cid, t)
        st = self._rel.get(rid)
        if st is None:
            return
        st.pending.pop(attempt, None)
        if st.done:
            self._rel_release(st)
            return
        self._attempt_failed(q, t, st)

    def _on_retry(self, q: EventQueue, t: float, rid: int) -> None:
        st = self._rel.get(rid)
        if st is None or st.done:
            return
        if self.sharding is not None:
            # gang storm retry: redispatch the whole fan-out
            fleet = self._fleets[st.fname]
            st.retry_pending = False
            self._dispatch_reliable(q, fleet, t, st.req)
            return
        rel = self.reliability
        if rel is not None and rel.kind == "degrade" and rel.degrade_to and \
                st.fname != rel.degrade_to and \
                rel.degrade_to in self._fleets and \
                self._storm_pressure(t) >= rel.shed_threshold:
            # mid-storm retry: the shed signal tripped after this request's
            # first attempt — reroute the retry to the fallback fleet
            # instead of burning the rest of the budget against the storm
            st.fname = rel.degrade_to
        self._start_attempt(q, t, st)

    def _on_hedge_fire(self, q: EventQueue, t: float, rid: int) -> None:
        st = self._rel.get(rid)
        rel = self.reliability
        if st is None or st.done or rel is None or \
                st.attempts >= rel.max_attempts:
            return
        self._start_attempt(q, t, st)

    def _on_attempt_done(self, q: EventQueue, t: float, payload) -> None:
        (rid, attempt, start, end, cold, exec_s, ccid, kind, prov, boot,
         load, rest, t0) = payload
        st = self._rel.get(rid)
        if st is None:
            return
        st.pending.pop(attempt, None)
        if st.done:
            # a losing duplicate finishing after the winner: its cost is
            # already on the record (billed at dispatch) — just release
            self._rel_release(st)
            return
        st.done = True
        # duplicates still in flight at the win are pure hedge waste
        hedge_cost = sum(st.pending.values())
        self._observe_latency(st.fname, end - t0)
        fleet = self._fleets[st.fname]
        req = st.req
        self.records.append_row((rid, req.arrival_s, start, end, cold,
                                 exec_s, exec_s, st.cost, ccid,
                                 fleet.memory_mb, req.tag, st.fname, 1,
                                 kind, prov, boot, load, rest, True,
                                 st.attempts, hedge_cost, 0))
        self._rel_release(st)
