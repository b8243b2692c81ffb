"""Pluggable scheduling policies for the ClusterSimulator.

Four orthogonal axes, each with the Lambda-2017 default first (the default
stack reproduces the old monolithic ``Simulator`` bit-for-bit):

  * PlacementPolicy — which warm container gets the request.
      MRUPlacement (default), LRUPlacement, LeastLoadedPlacement.
  * KeepalivePolicy — when an idle container is evicted.
      FixedTTL (default), AdaptiveTTL (inter-arrival histogram, the
      "keep warm at least as long as the observed gaps" policy the paper's
      §5 asks for declaratively).
  * ScalingPolicy — when containers are provisioned ahead of demand.
      LambdaImplicit (default: one per concurrent request, nothing ahead),
      PredictiveWarmPool (Knative-style: size the warm pool from the recent
      arrival rate via ``repro_torch.core.autoscaler.Autoscaler``).
  * ColdStartPolicy — how much of the PROVISION -> BOOTSTRAP -> LOAD
      anatomy a cold start actually pays (the mitigation taxonomy of the
      serverless-inference survey, arXiv:2311.13587).
      FullCold (default: every phase, bit-parity pinned), SnapshotRestore
      (first LOAD writes a snapshot; later colds pay PROVISION + a cheap
      RESTORE, with storage surfaced in ``repro_torch.core.billing``),
      LayeredPool (cluster-shared pool of bootstrapped bare sandboxes —
      claims pay LOAD only), PackageCache (handler-keyed package cache —
      LOAD skipped on a hit).

Policies are deliberately tiny value objects: the cluster owns all mutable
fleet state and calls into them with explicit arguments, so the same policy
instance can drive several fleets and runs stay deterministic.

Each policy's docstring names the trace regime it is expected to win in,
cross-referencing the reference's named scenarios (``repro.core.scenarios``),
whose suite sweeps the full cross-product and grades those expectations per
scenario.

The port's counterpart of ``repro.core.cluster.policies``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import resources
from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.container import Phase, cold_start_breakdown


# ------------------------------------------------------------------ placement
class PlacementPolicy:
    """Choose a container id among ``candidates`` = [(last_used_s, cid)]."""

    name = "base"
    needs_inflight = False   # set when choose() reads the inflight dict

    def choose(self, candidates: list, inflight: dict) -> Optional[int]:
        raise NotImplementedError


class MRUPlacement(PlacementPolicy):
    """Most-recently-used reuse (Lambda observed behaviour; best locality).

    No knobs.  The default everywhere; strongest when one hot container can
    carry the load (the ``sparse`` scenario's trickle), because it lets the
    rest of the pool age out and keeps the billing surface minimal.
    """

    name = "mru"

    def choose(self, candidates, inflight):
        return max(candidates)[1] if candidates else None


class LRUPlacement(PlacementPolicy):
    """Least-recently-used — spreads load, keeps the whole pool warm.

    No knobs.  Useful when a later burst will need the whole pool warm
    (``bursty`` between nearby bursts); on sparse traces it merely pays
    more idle keep-alive than MRU for the same latency.
    """

    name = "lru"

    def choose(self, candidates, inflight):
        return min(candidates)[1] if candidates else None


class LeastLoadedPlacement(PlacementPolicy):
    """Fewest in-flight requests first (ties broken MRU) — the natural
    partner of per-container ``concurrency > 1``: it equalizes the
    contention slowdown instead of piling requests on the MRU container.
    No knobs; only distinguishable from MRU when concurrency > 1."""

    name = "least_loaded"
    needs_inflight = True

    def choose(self, candidates, inflight):
        if not candidates:
            return None
        return min(candidates,
                   key=lambda c: (inflight.get(c[1], 0), -c[0], -c[1]))[1]


def _percentile_linear(values: list, pct: float) -> float:
    """``float(np.percentile(values, pct))`` (default 'linear' method),
    bit-exactly, without the numpy call overhead.

    Replicates numpy's arithmetic step for step so cached adaptive TTLs
    match the pre-cache ones to the last ulp (the suite reports are pinned
    byte-identical across this change): the 'linear' method's virtual
    index is ``(n - 1) * (pct / 100)`` and interpolation follows numpy's
    ``_lerp`` two-branch form (``t >= 0.5`` interpolates from the right).
    """
    sv = sorted(values)
    n = len(sv)
    virtual = (n - 1) * (pct / 100.0)
    if virtual <= 0.0:
        return float(sv[0])
    if virtual >= n - 1:
        return float(sv[-1])
    j = int(virtual)
    g = virtual - j
    a, b = sv[j], sv[j + 1]
    diff = b - a
    if g < 0.5:
        return float(a + diff * g)
    return float(b - diff * (1.0 - g))


# ------------------------------------------------------------------ keepalive
class KeepalivePolicy:
    """TTL source; the cluster schedules/evaluates expiry deadlines with it."""

    name = "base"

    def observe_gap(self, fn: str, gap_s: float) -> None:
        """Called once per arrival with the inter-arrival gap on that fleet."""

    def ttl(self, fn: str) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedTTL(KeepalivePolicy):
    """Lambda baseline: evict after a fixed idle TTL.

    Knobs: ``ttl_s`` (default 480 s — the paper's observed Lambda
    keep-alive).  This is the ``baseline`` stack's keep-alive in every
    scenario; it leaks cold starts whenever the trace's inter-arrival gaps
    straddle the TTL (15% of gaps in ``sparse``, every inter-burst dwell
    in ``bursty``).
    """

    ttl_s: float = 480.0
    name = "fixed"

    def ttl(self, fn: str = "") -> float:
        return self.ttl_s


class AdaptiveTTL(KeepalivePolicy):
    """Histogram-adaptive keep-alive (serverless-in-the-wild style).

    Tracks per-function inter-arrival gaps and keeps containers warm for a
    high percentile of the observed gap distribution times a safety margin.
    On the paper's 10-minute-gap trace this learns TTL > 600 s and converts
    the all-cold baseline into warm hits; on dense traffic it shrinks the
    idle tail the provider pays for.

    Knobs and defaults: ``base_ttl_s=480`` (used until a function has gap
    observations), ``percentile=99`` / ``margin=1.2`` (how much of the gap
    distribution to cover), ``min_ttl_s=30`` / ``max_ttl_s=3600`` (clamp),
    ``window=256`` (sliding histogram size per function).

    Expected to win on ``sparse`` (the scenario-suite verdict it is graded
    on: gaps cluster around the fixed TTL, and one observation suffices to
    stretch it).  Expected to LOSE on ``flash_crowd``: the dense trickle
    dominates the histogram, the TTL shrinks toward ``min_ttl_s``, and the
    trickle itself starts missing — a deliberate negative control in the
    suite's report.
    """

    name = "adaptive"

    def __init__(self, *, base_ttl_s: float = 480.0, percentile: float = 99.0,
                 margin: float = 1.2, min_ttl_s: float = 30.0,
                 max_ttl_s: float = 3600.0, window: int = 256):
        self.base_ttl_s = base_ttl_s
        self.percentile = percentile
        self.margin = margin
        self.min_ttl_s = min_ttl_s
        self.max_ttl_s = max_ttl_s
        self.window = window
        self._gaps: dict[str, list] = {}
        self._ttl_cache: dict[str, float] = {}

    def observe_gap(self, fn: str, gap_s: float) -> None:
        gaps = self._gaps.setdefault(fn, [])
        gaps.append(gap_s)
        if len(gaps) > self.window:
            del gaps[0]
        self._ttl_cache.pop(fn, None)

    def ttl(self, fn: str = "") -> float:
        """Current TTL for ``fn``.  The event loop asks per dispatch and
        per expiry check, so the percentile is computed once per new gap
        observation (cached) with a scalar replication of
        ``np.percentile(gaps, p)`` — calling numpy on a <=256-element list
        a few times per event dominated adaptive-stack sweeps."""
        gaps = self._gaps.get(fn)
        if not gaps:
            return self.base_ttl_s
        t = self._ttl_cache.get(fn)
        if t is None:
            t = _percentile_linear(gaps, self.percentile) * self.margin
            # np.clip semantics for finite scalars
            if t < self.min_ttl_s:
                t = self.min_ttl_s
            elif t > self.max_ttl_s:
                t = self.max_ttl_s
            self._ttl_cache[fn] = t = float(t)
        return t


# -------------------------------------------------------------------- scaling
class ScalingPolicy:
    """Ahead-of-demand provisioning decisions, called on every arrival."""

    name = "base"

    def prewarm_count(self, *, now: float, arrivals: list, warm_exec_s: float,
                      active: int) -> int:
        """How many extra containers to start provisioning right now."""
        raise NotImplementedError


class LambdaImplicit(ScalingPolicy):
    """Lambda semantics: scale-out only happens on demand (a cold start per
    request with no warm capacity); never provisions ahead.  No knobs; the
    ``baseline`` stack's scaling in every scenario."""

    name = "lambda"

    def prewarm_count(self, *, now, arrivals, warm_exec_s, active):
        return 0


@dataclasses.dataclass
class PredictiveWarmPool(ScalingPolicy):
    """Knative-style: keep ``ceil(rate * service_time * margin)`` warm.

    Knobs live on the wrapped ``repro_torch.core.autoscaler.Autoscaler``:
    ``window_s=5`` (rate window), ``margin=1.5`` (head-room), and
    ``min_pool=0`` — the provisioned-concurrency floor that makes this
    policy win regimes where rate-proportional sizing alone sees an empty
    window and lets the pool die.

    Expected to win on ``diurnal`` (window smooths the dawn ramp, floor
    covers the overnight trough) and ``flash_crowd`` (a floor sized for
    the anticipated spike absorbs the onset herd); it is also the
    predictive half of ``multi_function``'s winning combined stack.  The
    scenario registry carries per-scenario tuned instances via
    ``Scenario.predictive``.
    """

    autoscaler: Autoscaler = dataclasses.field(default_factory=Autoscaler)
    name = "predictive"

    def prewarm_count(self, *, now, arrivals, warm_exec_s, active):
        desired = self.autoscaler.desired_pool(arrivals, now, warm_exec_s)
        return max(0, desired - active)


# ------------------------------------------------------------------ coldstart
class ColdStartPolicy:
    """How a cold start traverses the PROVISION -> BOOTSTRAP -> LOAD
    anatomy.  ``plan`` returns the *remaining* ``(Phase, seconds)`` pairs a
    container in its current lifecycle state must pay to become LOADED for
    ``spec`` — the base implementation simply charges every standard phase
    the container has not completed yet (which is also what makes an
    intermediate-state claim pay only the remaining phases).  Subclasses
    substitute or skip phases; ``on_loaded`` is the cluster's callback when
    a container finishes loading (snapshot/cache bookkeeping).

    Like ``AdaptiveTTL``, mitigation policies may carry learned state
    (snapshots written, cached packages); the platform deep-copies policy
    instances per invocation so runs stay independent.
    """

    name = "base"
    pool_size = 0          # LayeredPool overrides: bare sandboxes to keep

    def plan(self, spec, container) -> list:
        bd = cold_start_breakdown(spec)
        return [(ph, bd.phase_s(ph))
                for ph in (Phase.PROVISION, Phase.BOOTSTRAP, Phase.LOAD)
                if not container.done(ph)]

    def on_loaded(self, fn: str, spec, t: float) -> None:
        """A container finished LOAD/RESTORE for fleet ``fn`` at ``t``."""

    def snapshots(self) -> list:
        """``(fn, size_mb, written_at)`` rows for snapshot storage billing."""
        return []


class FullCold(ColdStartPolicy):
    """Status quo: every cold start pays all three phases.  No knobs; the
    default everywhere, and the only coldstart policy allowed to use the
    collapsed single-step fast path of the default stack's bit-parity
    (per-phase times are still recorded — they sum to the collapsed
    total)."""

    name = "full"


class SnapshotRestore(ColdStartPolicy):
    """Checkpoint/restore mitigation (Catalyzer / Firecracker-snapshot
    style).  The first LOAD completion per function writes a snapshot of
    the bootstrapped+loaded process; every later cold start pays PROVISION
    plus a cheap RESTORE instead of BOOTSTRAP + LOAD.

    Knobs: ``restore_factor=0.2`` (restore cost as a fraction of the
    bootstrap+load it replaces — lazy page-in of a memory image),
    ``min_restore_s=0.1`` (floor).  Snapshot storage is billed from write
    time to end of run at ``billing.SNAPSHOT_GB_MONTH_PRICE`` over the
    handler's peak working set.

    The cheap mitigation: on ``flash_crowd`` the trickle's first cold
    writes the snapshot long before the spike, so the onset herd's cold
    window shrinks from the full anatomy to PROVISION + RESTORE — roughly
    halving the herd's cold count and collapsing the cold latency tail
    (p95 ~9.4 s -> ~2.0 s) for a storage surcharge of well under a cent
    per million requests.  It cannot beat the bare-pool policies on cold
    *rate* (every restore is still a cold start; a pool claim is not),
    which is why ``layered_pool`` is the graded flash-crowd winner and
    this is the cost-conscious runner-up.
    """

    name = "snapshot"

    def __init__(self, *, restore_factor: float = 0.2,
                 min_restore_s: float = 0.1):
        self.restore_factor = restore_factor
        self.min_restore_s = min_restore_s
        self._snapshots: dict[str, tuple] = {}   # fn -> (written_at, size_mb)

    def plan(self, spec, container) -> list:
        if spec.name not in self._snapshots:
            return super().plan(spec, container)
        bd = cold_start_breakdown(spec)
        phases = []
        if not container.done(Phase.PROVISION):
            phases.append((Phase.PROVISION, bd.provision_s))
        if not container.done(Phase.LOAD):
            restore = max(self.min_restore_s,
                          self.restore_factor * (bd.bootstrap_s + bd.load_s))
            phases.append((Phase.RESTORE, restore))
        return phases

    def on_loaded(self, fn: str, spec, t: float) -> None:
        if fn not in self._snapshots:
            self._snapshots[fn] = (t, spec.handler.peak_memory_mb)

    def snapshots(self) -> list:
        return [(fn, size, at) for fn, (at, size) in self._snapshots.items()]


class LayeredPool(ColdStartPolicy):
    """Cluster-shared pool of bootstrapped-but-unloaded bare sandboxes
    (SOCK / layered-sandbox style).  Any fleet's cold start may claim a
    ready sandbox and pay only LOAD; a claim immediately starts
    provisioning a replacement, so the pool's standing size is constant.
    Bare sandboxes are function-agnostic (no model in memory), park in
    lifecycle state BOOTSTRAPPED, sit *outside* the ``max_containers`` cap
    until claimed, and bill idle time at the smallest tier
    (``billing.sandbox_idle_cost``).

    Knobs: ``pool_size=4`` (standing sandboxes), ``pool_memory_mb=1024``
    (tier the pool provisions/bootstraps at; a claim is re-specced to the
    claiming fleet's tier — balloon-style resize, modelled free),
    ``bootstrap_cpu_seconds=1.2`` (generic runtime+framework import).

    A claim is a PREWARM start (OpenWhisk stem-cell semantics), not a cold
    start: records carry ``cold=False, cold_kind="pool"`` with the LOAD
    wall time in ``load_s``, so cold-rate metrics credit the pool while
    the latency distribution still shows the load penalty.

    Composed with the predictive floor (``pool_predictive``) it wins
    ``flash_crowd``: whatever the floor misses claims a sandbox instead of
    cold-starting, beating plain predictive on cold rate at every trace
    scale.  Composed with batching + predictive scaling
    (``pool_batching_predictive``) it wins ``multi_function``, where burst-head
    and eviction-churn colds become pool claims for whichever fleet loses
    the capacity fight; the pool composes with the shared cap (claims
    still honor it; bare sandboxes sit outside it).  The price is a
    standing pool charge (``mitigation_per_1k`` in the suite reports)
    that dominates sparse traces — the cost/latency trade the suite
    surfaces."""

    name = "layered"

    def __init__(self, *, pool_size: int = 4, pool_memory_mb: int = 1024,
                 bootstrap_cpu_seconds: float = 1.2):
        self.pool_size = int(pool_size)
        self.pool_memory_mb = int(pool_memory_mb)
        self.bootstrap_cpu_seconds = bootstrap_cpu_seconds

    def pool_plan(self) -> list:
        """Phases a bare sandbox pays to reach BOOTSTRAPPED (at the pool's
        own tier — there is no function, hence no LOAD)."""
        from repro_torch.core.container import (PROVISION_BASE_S, PROVISION_TIER_S)
        share = resources.cpu_share(self.pool_memory_mb)
        return [(Phase.PROVISION,
                 PROVISION_BASE_S + PROVISION_TIER_S / max(share, 0.25)),
                (Phase.BOOTSTRAP,
                 resources.exec_time(self.bootstrap_cpu_seconds,
                                     self.pool_memory_mb))]


class PackageCache(ColdStartPolicy):
    """Node-local deployment-package cache keyed by handler: the first LOAD
    of a handler populates the cache, later cold starts of the same handler
    skip LOAD entirely (the package and deserialized weights are already on
    the node; the cluster models a single node).  No storage surcharge —
    the cache reuses the node's ephemeral disk.  Strongest for fleets that
    cold-start the same few handlers repeatedly (capped ``multi_function``
    churn); useless for the very first cold of each handler.  No knobs
    beyond the shared anatomy."""

    name = "package_cache"

    def __init__(self):
        self._cached: set[str] = set()

    def plan(self, spec, container) -> list:
        phases = super().plan(spec, container)
        if spec.handler.name in self._cached:
            phases = [(ph, d) for ph, d in phases if ph is not Phase.LOAD]
        return phases

    def on_loaded(self, fn: str, spec, t: float) -> None:
        self._cached.add(spec.handler.name)


# ------------------------------------------------------------------ registry
PLACEMENTS = {"mru": MRUPlacement, "lru": LRUPlacement,
              "least_loaded": LeastLoadedPlacement}

COLDSTARTS = {"full": FullCold, "snapshot": SnapshotRestore,
              "layered": LayeredPool, "package_cache": PackageCache}


def make_coldstart(c) -> ColdStartPolicy:
    if isinstance(c, ColdStartPolicy):
        return c
    if c is None:
        return FullCold()
    try:
        return COLDSTARTS[c]()
    except KeyError:
        raise KeyError(f"unknown coldstart policy {c!r}; "
                       f"known: {sorted(COLDSTARTS)}") from None


def make_placement(p) -> PlacementPolicy:
    if isinstance(p, PlacementPolicy):
        return p
    return PLACEMENTS[p]()


def make_keepalive(k, default_ttl_s: float = 480.0) -> KeepalivePolicy:
    if isinstance(k, KeepalivePolicy):
        return k
    if k in (None, "fixed"):
        return FixedTTL(default_ttl_s)
    if k == "adaptive":
        return AdaptiveTTL(base_ttl_s=default_ttl_s)
    raise KeyError(f"unknown keepalive policy {k!r}")


def make_scaling(s) -> ScalingPolicy:
    if isinstance(s, ScalingPolicy):
        return s
    if s in (None, "lambda"):
        return LambdaImplicit()
    if s == "predictive":
        return PredictiveWarmPool()
    raise KeyError(f"unknown scaling policy {s!r}")


_MEASURED_MODELS: Optional[dict] = None


def _measured_models() -> dict:
    """The host's measured calibration entries (``{model: entry}``): those
    of the port's default cache (``calibration.default_cal_path()``) when
    this host has a card and the cache is valid for it at full configs,
    else ``{}``.  Memoized per process: scaling policies call
    ``warm_exec_estimate`` on every poll tick and must not re-read (or
    re-reject) the cache file each time."""
    global _MEASURED_MODELS
    if _MEASURED_MODELS is None:
        import torch

        from repro_torch.core import calibration
        cache = calibration.load_cache() if torch.cuda.is_available() else None
        _MEASURED_MODELS = dict(cache["models"]) if cache else {}
    return _MEASURED_MODELS


def warm_exec_estimate(spec) -> float:
    """Deterministic warm service-time estimate for scaling decisions,
    under the spec's provider profile (a GPU-serverless container gets the
    whole host, not a memory-proportional share).

    When the sim-to-real calibration loop has measured this model on this
    host (a ``load_cache``-valid entry whose ``warm_exec_s`` is the steady
    warm step wall time on a full core), that measurement is the CPU-cost
    base; otherwise the handler's analytic ``base_cpu_seconds`` stands in.
    Either way the provider profile maps CPU seconds to wall time for the
    spec's memory tier."""
    from repro_torch.core import providers
    name = spec.handler.name
    models = _measured_models()
    entry, scale = models.get(name), 1.0
    if entry is None and "#shard" in name:
        # gang lane handlers are "<model>#shard<N>"; the measurement is
        # per model, and a lane runs 1/N of it (same factor lane_spec
        # applies to the analytic constant)
        base_name, _, fan = name.partition("#shard")
        entry = models.get(base_name)
        if fan.isdigit():
            scale = 1.0 / max(int(fan), 1)
    base = spec.handler.base_cpu_seconds
    if entry and entry.get("warm_exec_s"):
        base = float(entry["warm_exec_s"]) * scale
    return providers.get(getattr(spec, "provider", "lambda")).exec_time(
        base, spec.memory_mb)
