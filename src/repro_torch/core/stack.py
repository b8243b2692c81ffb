"""First-class policy configuration: PolicyStack and ExperimentSpec.

The paper's follow-up question — which scheduling policies close the
cold-start gap, in which regimes — made policy selection the repo's
central API, but it used to live as seven loose kwargs threaded from
``ServerlessPlatform`` through ``ClusterSimulator``.  This module makes a
policy configuration a *value*:

  * Per-axis frozen configs (``KeepaliveConfig`` / ``ScalingConfig`` /
    ``ColdstartConfig`` plus the existing ``BatchingConfig``) carry every
    knob — TTL seconds, autoscaler window/margin/min_pool, snapshot and
    pool parameters — and validate on construction (a non-default knob
    the selected ``kind`` never reads raises rather than silently
    dropping intent), so equality and hashing mean "same behaviour",
    robust against axis reordering.
  * ``PolicyStack`` bundles all nine axes (among them the
    distributed-inference ``ShardingConfig`` and the ``ReliabilityConfig``
    retry/hedge/degrade axis).  ``materialize()`` builds
    *fresh* policy instances (the single place where state isolation
    between runs is guaranteed — no deep-copy rules at call sites),
    ``with_()`` derives variants, ``to_dict()/from_dict()`` give a JSON
    round-trip, and ``grid()`` expands sweep cross-products.
  * ``ExperimentSpec`` names one reproducible experiment — scenario +
    stack + seed + scale (+ an optional ``versus`` stack to grade
    against) — and ``run()`` returns a structured ``ExperimentResult``.
    ``ExperimentSpec.from_file`` loads a spec from a JSON file, so every
    published number is reproducible from one artifact; ``run_specs``
    fans specs out over a process pool (``pool_executor``).

Stacks express the *registry* policies (the ones a sweep can name); a
hand-written policy subclass can still be handed to ``ClusterSimulator``
directly through its legacy kwargs, which remain supported.

The port's counterpart of ``repro.core.stack``: the same arithmetic, in
the same order, on the same explicitly seeded numpy streams, so that the
two give equal results on equal inputs.  One difference: the port pins no
language-model numbers, so ``run_specs`` and the scenario context take an
already loaded calibration (``calibrated=``, a v2 cache dict) for the
scenarios whose fleets hold a registry model, and a worker never touches
the device (the parent resolves the measured scaling entries before the
pool starts).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Mapping, Optional, Sequence

from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.cluster.policies import (AdaptiveTTL, FixedTTL, FullCold,
                                               LambdaImplicit, LayeredPool,
                                               PackageCache, PLACEMENTS,
                                               PlacementPolicy, PredictiveWarmPool,
                                               SnapshotRestore, make_placement)
from repro_torch.core.cluster.router import BatchingConfig


def _require_defaults(cfg, fields: Sequence[str]) -> None:
    """Validate a frozen axis config: ``fields`` are knobs the selected
    ``kind`` never reads, so a non-default value there is lost intent (a
    typo'd kind, a knob on the wrong axis) and raises instead of being
    silently dropped.  Constructible configs are therefore canonical by
    construction: equality and hashing mean 'materializes the same
    policy'."""
    bad = [f for f in fields
           if getattr(cfg, f) != type(cfg).__dataclass_fields__[f].default]
    if bad:
        raise ValueError(
            f"{type(cfg).__name__}(kind={cfg.kind!r}) never reads "
            f"{sorted(bad)}; leave them at their defaults or select the "
            f"kind that uses them")


# ------------------------------------------------------------------ keepalive
@dataclasses.dataclass(frozen=True)
class KeepaliveConfig:
    """Keep-alive axis: ``fixed`` (Lambda TTL) or ``adaptive`` (per-function
    gap histogram).  ``ttl_s`` is the fixed TTL, or the adaptive policy's
    base TTL until it has observations; the remaining knobs are
    ``AdaptiveTTL``'s and must stay at their defaults under ``fixed``."""

    kind: str = "fixed"
    ttl_s: float = 480.0
    percentile: float = 99.0
    margin: float = 1.2
    min_ttl_s: float = 30.0
    max_ttl_s: float = 3600.0
    window: int = 256

    def __post_init__(self):
        if self.kind not in ("fixed", "adaptive"):
            raise KeyError(f"unknown keepalive kind {self.kind!r}; "
                           f"known: ['adaptive', 'fixed']")
        object.__setattr__(self, "window", int(self.window))
        if self.kind == "fixed":
            _require_defaults(self, ("percentile", "margin", "min_ttl_s",
                                     "max_ttl_s", "window"))

    def materialize(self):
        if self.kind == "fixed":
            return FixedTTL(self.ttl_s)
        return AdaptiveTTL(base_ttl_s=self.ttl_s, percentile=self.percentile,
                           margin=self.margin, min_ttl_s=self.min_ttl_s,
                           max_ttl_s=self.max_ttl_s, window=self.window)


# -------------------------------------------------------------------- scaling
@dataclasses.dataclass(frozen=True)
class ScalingConfig:
    """Scaling axis: ``lambda`` (scale-out on demand only) or ``predictive``
    (Knative-style warm pool).  The knobs are the ``Autoscaler``'s —
    ``window_s`` / ``margin`` / ``min_pool`` — validated at construction
    and required to stay at defaults under ``lambda``."""

    kind: str = "lambda"
    window_s: float = 5.0
    margin: float = 1.5
    min_pool: int = 0

    def __post_init__(self):
        if self.kind not in ("lambda", "predictive"):
            raise KeyError(f"unknown scaling kind {self.kind!r}; "
                           f"known: ['lambda', 'predictive']")
        object.__setattr__(self, "min_pool", int(self.min_pool))
        if self.kind == "lambda":
            _require_defaults(self, ("window_s", "margin", "min_pool"))
        else:
            Autoscaler(window_s=self.window_s, margin=self.margin,
                       min_pool=self.min_pool)   # validate knobs early

    def materialize(self):
        if self.kind == "lambda":
            return LambdaImplicit()
        return PredictiveWarmPool(Autoscaler(window_s=self.window_s,
                                             margin=self.margin,
                                             min_pool=self.min_pool))


# ------------------------------------------------------------------ coldstart
@dataclasses.dataclass(frozen=True)
class ColdstartConfig:
    """Cold-start mitigation axis: ``full`` | ``snapshot`` | ``layered`` |
    ``package_cache`` (DESIGN.md §6).  ``restore_*`` knobs belong to
    ``snapshot``, ``pool_*``/``bootstrap_cpu_seconds`` to ``layered``;
    a kind rejects the other kind's knobs when set off-default."""

    kind: str = "full"
    restore_factor: float = 0.2
    min_restore_s: float = 0.1
    pool_size: int = 4
    pool_memory_mb: int = 1024
    bootstrap_cpu_seconds: float = 1.2

    def __post_init__(self):
        if self.kind not in ("full", "snapshot", "layered", "package_cache"):
            raise KeyError(f"unknown coldstart kind {self.kind!r}; known: "
                           f"['full', 'layered', 'package_cache', "
                           f"'snapshot']")
        object.__setattr__(self, "pool_size", int(self.pool_size))
        object.__setattr__(self, "pool_memory_mb", int(self.pool_memory_mb))
        if self.kind != "snapshot":
            _require_defaults(self, ("restore_factor", "min_restore_s"))
        if self.kind != "layered":
            _require_defaults(self, ("pool_size", "pool_memory_mb",
                                     "bootstrap_cpu_seconds"))

    def materialize(self):
        if self.kind == "full":
            return FullCold()
        if self.kind == "snapshot":
            return SnapshotRestore(restore_factor=self.restore_factor,
                                   min_restore_s=self.min_restore_s)
        if self.kind == "layered":
            return LayeredPool(
                pool_size=self.pool_size,
                pool_memory_mb=self.pool_memory_mb,
                bootstrap_cpu_seconds=self.bootstrap_cpu_seconds)
        return PackageCache()


# ------------------------------------------------------------------- sharding
@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Distributed-inference axis: ``none`` (single-sandbox invokes, the
    baseline and every pre-existing stack) or ``gang`` (one request fans
    out to ``fanout`` shard sub-invokes that join on the slowest —
    DESIGN.md §10).

    ``co_place`` pins the gang's sandboxes to one reclamation domain, so
    shard idle lifetimes stop being independent (the FSD-Inference
    'bin-packed workers' placement); ``gang_prewarm`` re-warms a reclaimed
    shard sandbox immediately instead of waiting for the next request to
    eat the full gang cold.  ``channel`` picks the provider-mediated
    activation path ("storage" or "queue"); ``steps_per_request`` is the
    decode steps one request moves through it; ``reclaim_sigma`` spreads
    the shard sandboxes' effective TTLs (lognormal, one-sided — reclaim
    never comes *later* than the policy TTL) when NOT co-placed.  All
    knobs must stay at their defaults under ``none``."""

    kind: str = "none"
    fanout: int = 1
    co_place: bool = False
    gang_prewarm: bool = False
    channel: str = "storage"
    steps_per_request: int = 8
    reclaim_sigma: float = 0.6

    def __post_init__(self):
        if self.kind not in ("none", "gang"):
            raise KeyError(f"unknown sharding kind {self.kind!r}; "
                           f"known: ['gang', 'none']")
        if self.channel not in ("storage", "queue"):
            raise KeyError(f"unknown comms channel {self.channel!r}; "
                           f"known: ['queue', 'storage']")
        object.__setattr__(self, "fanout", int(self.fanout))
        object.__setattr__(self, "steps_per_request",
                           int(self.steps_per_request))
        if self.kind == "none":
            _require_defaults(self, ("fanout", "co_place", "gang_prewarm",
                                     "channel", "steps_per_request",
                                     "reclaim_sigma"))
        elif self.fanout < 1:
            raise ValueError(f"fanout must be >= 1, got {self.fanout}")

    def materialize(self):
        """The cluster's sharding kwarg: ``None`` for single-sandbox
        invokes (the fast-path gate key), else this frozen config."""
        return None if self.kind == "none" else self


# ---------------------------------------------------------------- reliability
@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Reliability axis (DESIGN.md §11): what the client/platform does when
    an attempt fails.  Kinds form a cumulative ladder —

    ``none``
        Today's fair-weather semantics: one attempt, no timeout; under an
        active fault model a failed attempt fails the request.  Must stay
        bit-identical to the pre-axis path.
    ``retry``
        Per-request timeout (``timeout_s``; 0 disables) plus retries with
        exponential backoff and decorrelated jitter
        (``delay = min(cap, uniform(base, 3 * prev))``), capped at
        ``max_attempts`` total attempts.
    ``hedge``
        ``retry`` plus tail-cutting request hedging: one speculative
        duplicate fires after the fleet's observed p-``hedge_quantile``
        success latency (``hedge_min_s`` floors the delay until enough
        observations exist); first completion wins, the loser's work is
        still billed — the wasted-dollars/latency trade.
    ``degrade``
        ``hedge`` plus load-shed/degrade: when ``shed_threshold`` failures
        land within ``shed_window_s``, new arrivals route to the cheaper
        registered fleet named ``degrade_to`` (or are shed outright when
        it is empty) until the storm clears.

    Knobs above a kind's rung must stay at their defaults (the
    ``_require_defaults`` discipline every axis follows).
    """

    kind: str = "none"
    timeout_s: float = 0.0
    max_attempts: int = 3
    backoff_base_s: float = 0.2
    backoff_cap_s: float = 5.0
    hedge_quantile: float = 0.95
    hedge_min_s: float = 0.05
    shed_window_s: float = 30.0
    shed_threshold: int = 10
    degrade_to: str = ""

    def __post_init__(self):
        if self.kind not in ("none", "retry", "hedge", "degrade"):
            raise KeyError(f"unknown reliability kind {self.kind!r}; "
                           f"known: ['degrade', 'hedge', 'none', 'retry']")
        object.__setattr__(self, "max_attempts", int(self.max_attempts))
        object.__setattr__(self, "shed_threshold", int(self.shed_threshold))
        if self.kind == "none":
            _require_defaults(self, ("timeout_s", "max_attempts",
                                     "backoff_base_s", "backoff_cap_s",
                                     "hedge_quantile", "hedge_min_s",
                                     "shed_window_s", "shed_threshold",
                                     "degrade_to"))
            return
        if self.kind == "retry":
            _require_defaults(self, ("hedge_quantile", "hedge_min_s",
                                     "shed_window_s", "shed_threshold",
                                     "degrade_to"))
        elif self.kind == "hedge":
            _require_defaults(self, ("shed_window_s", "shed_threshold",
                                     "degrade_to"))
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if self.timeout_s < 0.0:
            raise ValueError(f"timeout_s must be >= 0, got {self.timeout_s}")
        if self.backoff_base_s <= 0.0 or \
                self.backoff_cap_s < self.backoff_base_s:
            raise ValueError(
                f"need 0 < backoff_base_s <= backoff_cap_s, got "
                f"{self.backoff_base_s} / {self.backoff_cap_s}")
        if not 0.0 < self.hedge_quantile < 1.0:
            raise ValueError(f"hedge_quantile must be in (0, 1), got "
                             f"{self.hedge_quantile}")

    def materialize(self):
        """The cluster's reliability kwarg: ``None`` for today's semantics
        (the fast-path gate key, like ``ShardingConfig``), else this
        frozen config."""
        return None if self.kind == "none" else self


# ------------------------------------------------------------------ coercions
# Instance coercion matches EXACT registry types only (``type(x) is ...``):
# a hand-written subclass carries behaviour a serializable config cannot
# express, so flattening it to the base config would silently run the
# wrong policy — those instances must go to ClusterSimulator's legacy
# kwargs instead, and every coercer says so.

def _coerce_placement(p) -> str:
    if isinstance(p, PlacementPolicy):
        if PLACEMENTS.get(getattr(p, "name", None)) is type(p):
            return p.name
        raise TypeError(f"cannot express {p!r} as a placement name; custom "
                        f"policy subclasses go to "
                        f"ClusterSimulator(placement=...) directly")
    if isinstance(p, str):
        make_placement(p)                         # raises on unknown names
        return p
    raise TypeError(f"placement must be a registry name {sorted(PLACEMENTS)} "
                    f"or a registry PlacementPolicy instance, got {p!r}")


def _coerce_keepalive(k) -> KeepaliveConfig:
    if isinstance(k, KeepaliveConfig):
        return k
    if k is None:
        return KeepaliveConfig()
    if isinstance(k, str):
        return KeepaliveConfig(kind=k)
    if isinstance(k, Mapping):
        return KeepaliveConfig(**k)
    if type(k) is FixedTTL:
        return KeepaliveConfig(kind="fixed", ttl_s=k.ttl_s)
    if type(k) is AdaptiveTTL:
        return KeepaliveConfig(kind="adaptive", ttl_s=k.base_ttl_s,
                               percentile=k.percentile, margin=k.margin,
                               min_ttl_s=k.min_ttl_s, max_ttl_s=k.max_ttl_s,
                               window=k.window)
    raise TypeError(f"cannot express {k!r} as a KeepaliveConfig; custom "
                    f"policy subclasses go to ClusterSimulator(keepalive=...)"
                    f" directly")


def _coerce_scaling(s) -> ScalingConfig:
    if isinstance(s, ScalingConfig):
        return s
    if s is None:
        return ScalingConfig()
    if isinstance(s, str):
        return ScalingConfig(kind=s)
    if isinstance(s, Mapping):
        return ScalingConfig(**s)
    if type(s) is LambdaImplicit:
        return ScalingConfig(kind="lambda")
    if type(s) is PredictiveWarmPool:
        a = s.autoscaler
        return ScalingConfig(kind="predictive", window_s=a.window_s,
                             margin=a.margin, min_pool=a.min_pool)
    raise TypeError(f"cannot express {s!r} as a ScalingConfig; custom "
                    f"policy subclasses go to ClusterSimulator(scaling=...) "
                    f"directly")


def _coerce_coldstart(c) -> ColdstartConfig:
    if isinstance(c, ColdstartConfig):
        return c
    if c is None:
        return ColdstartConfig()
    if isinstance(c, str):
        return ColdstartConfig(kind=c)
    if isinstance(c, Mapping):
        return ColdstartConfig(**c)
    if type(c) is FullCold:
        return ColdstartConfig(kind="full")
    if type(c) is SnapshotRestore:
        return ColdstartConfig(kind="snapshot", restore_factor=c.restore_factor,
                               min_restore_s=c.min_restore_s)
    if type(c) is LayeredPool:
        return ColdstartConfig(kind="layered", pool_size=c.pool_size,
                               pool_memory_mb=c.pool_memory_mb,
                               bootstrap_cpu_seconds=c.bootstrap_cpu_seconds)
    if type(c) is PackageCache:
        return ColdstartConfig(kind="package_cache")
    raise TypeError(f"cannot express {c!r} as a ColdstartConfig; custom "
                    f"policy subclasses go to ClusterSimulator(coldstart=...)"
                    f" directly")


def _coerce_batching(b) -> Optional[BatchingConfig]:
    if b is None or isinstance(b, BatchingConfig):
        return b
    knobs = {f.name for f in dataclasses.fields(BatchingConfig)}
    if isinstance(b, Mapping):
        if not b:
            return None       # the legacy empty per-fleet map: no batching
        if set(b) <= knobs:
            return BatchingConfig(**b)
    raise TypeError(f"batching must be None, a BatchingConfig, or its dict "
                    f"form {sorted(knobs)}, got {b!r} (per-fleet "
                    f"{{fn: config}} dicts stay a ClusterSimulator-level "
                    f"feature)")


def _coerce_sharding(s) -> ShardingConfig:
    if isinstance(s, ShardingConfig):
        return s
    if s is None:
        return ShardingConfig()
    if isinstance(s, str):
        return ShardingConfig(kind=s)
    if isinstance(s, Mapping):
        return ShardingConfig(**s)
    raise TypeError(f"sharding must be None, a ShardingConfig, a kind name "
                    f"('none'/'gang'), or its dict form, got {s!r}")


def _coerce_reliability(r) -> ReliabilityConfig:
    if isinstance(r, ReliabilityConfig):
        return r
    if r is None:
        return ReliabilityConfig()
    if isinstance(r, str):
        return ReliabilityConfig(kind=r)
    if isinstance(r, Mapping):
        return ReliabilityConfig(**r)
    raise TypeError(f"reliability must be None, a ReliabilityConfig, a kind "
                    f"name ('none'/'retry'/'hedge'/'degrade'), or its dict "
                    f"form, got {r!r}")


# ---------------------------------------------------------------- PolicyStack
@dataclasses.dataclass(frozen=True)
class PolicyStack:
    """One point in the policy space: all nine axes, as a frozen value.

    The default instance IS the Lambda-2017 baseline (MRU placement, fixed
    480 s TTL, implicit scaling, full colds, concurrency 1, no batching,
    no container cap, no sharding, no reliability policy).

    Axis values coerce on construction: registry names (``"adaptive"``),
    axis configs, their dict forms, and registry policy *instances* (their
    constructor knobs are captured; learned state — histograms, written
    snapshots — is not, because a stack describes a fresh experiment).
    """

    placement: str = "mru"
    keepalive: KeepaliveConfig = KeepaliveConfig()
    scaling: ScalingConfig = ScalingConfig()
    coldstart: ColdstartConfig = ColdstartConfig()
    concurrency: int = 1
    batching: Optional[BatchingConfig] = None
    max_containers: int = 0
    sharding: ShardingConfig = ShardingConfig()
    reliability: ReliabilityConfig = ReliabilityConfig()

    def __post_init__(self):
        object.__setattr__(self, "placement",
                           _coerce_placement(self.placement))
        object.__setattr__(self, "keepalive",
                           _coerce_keepalive(self.keepalive))
        object.__setattr__(self, "scaling", _coerce_scaling(self.scaling))
        object.__setattr__(self, "coldstart",
                           _coerce_coldstart(self.coldstart))
        object.__setattr__(self, "concurrency", int(self.concurrency))
        object.__setattr__(self, "batching", _coerce_batching(self.batching))
        object.__setattr__(self, "max_containers", int(self.max_containers))
        object.__setattr__(self, "sharding", _coerce_sharding(self.sharding))
        object.__setattr__(self, "reliability",
                           _coerce_reliability(self.reliability))

    # ------------------------------------------------------------- behaviour
    def materialize(self) -> dict:
        """Fresh ``ClusterSimulator`` policy kwargs.  Every call constructs
        new policy instances, so no histogram / autoscaler / snapshot /
        package-cache state can leak between runs — this replaces the
        deep-copy rules that used to be scattered across callers."""
        return dict(placement=make_placement(self.placement),
                    keepalive=self.keepalive.materialize(),
                    scaling=self.scaling.materialize(),
                    coldstart=self.coldstart.materialize(),
                    concurrency=self.concurrency,
                    batching=self.batching,
                    max_containers=self.max_containers,
                    sharding=self.sharding.materialize(),
                    reliability=self.reliability.materialize())

    def with_(self, **overrides) -> "PolicyStack":
        """Derive a variant; values coerce like constructor arguments."""
        unknown = set(overrides) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise TypeError(f"unknown PolicyStack axes {sorted(unknown)}; "
                            f"axes: {[f.name for f in dataclasses.fields(self)]}")
        return dataclasses.replace(self, **overrides)

    # ---------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        """JSON-ready nested dict; ``from_dict`` is the exact inverse."""
        return {"placement": self.placement,
                "keepalive": dataclasses.asdict(self.keepalive),
                "scaling": dataclasses.asdict(self.scaling),
                "coldstart": dataclasses.asdict(self.coldstart),
                "concurrency": self.concurrency,
                "batching": (dataclasses.asdict(self.batching)
                             if self.batching is not None else None),
                "max_containers": self.max_containers,
                "sharding": dataclasses.asdict(self.sharding),
                "reliability": dataclasses.asdict(self.reliability)}

    @classmethod
    def from_dict(cls, d: Mapping) -> "PolicyStack":
        return cls(**dict(d))

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "PolicyStack":
        return cls.from_dict(json.loads(s))

    # ----------------------------------------------------------------- sweeps
    @classmethod
    def grid(cls, axes: Mapping[str, Sequence],
             base: Optional["PolicyStack"] = None) -> list:
        """Cross-product sweep: one stack per combination of ``axes``
        values (each value coerces like a constructor argument), derived
        from ``base`` (default: the baseline stack).  Axis order follows
        the mapping's iteration order, last axis fastest — the classic
        nested-loop order the reports pin."""
        base = base if base is not None else cls()
        names = list(axes)
        return [base.with_(**dict(zip(names, values)))
                for values in itertools.product(*(axes[n] for n in names))]

    def axes_key(self) -> tuple:
        """Canonical report ordering: kind per axis, in axis order.  Two
        stacks may share a key (same kinds, different knobs); use the stack
        itself — equality and hash are canonical — as the identity key."""
        sh = self.sharding
        if sh.kind == "none":
            shard = "-"
        else:
            shard = f"gang{sh.fanout}" + ("+co" if sh.co_place else "") + \
                ("+pw" if sh.gang_prewarm else "")
        rel = self.reliability
        return (self.placement, self.keepalive.kind, self.scaling.kind,
                self.coldstart.kind, self.concurrency,
                self.batching is not None, shard,
                "-" if rel.kind == "none" else rel.kind)

    # ------------------------------------------------------------ legacy shim
    @classmethod
    def from_kwargs(cls, *, placement="mru", keepalive=None, scaling=None,
                    coldstart=None, concurrency: int = 1, batching=None,
                    max_containers: int = 0, sharding=None, reliability=None,
                    keepalive_s: float = 480.0) -> "PolicyStack":
        """Build a stack from the legacy seven-kwarg surface.  Mirrors the
        old ``make_*`` defaults: ``keepalive=None`` or a registry name uses
        ``keepalive_s`` as the (base) TTL."""
        if keepalive is None or isinstance(keepalive, str):
            ka = KeepaliveConfig(kind=keepalive or "fixed", ttl_s=keepalive_s)
        else:
            ka = _coerce_keepalive(keepalive)
        return cls(placement=placement, keepalive=ka, scaling=scaling,
                   coldstart=coldstart, concurrency=concurrency,
                   batching=batching, max_containers=max_containers,
                   sharding=sharding, reliability=reliability)


#: The Lambda-2017 baseline stack (also ``PolicyStack()``).
BASELINE = PolicyStack()


# ------------------------------------------------------------------- running
def run_stack(specs, trace, stack: PolicyStack, *, seed: int = 0, sla=None,
              scenario=None, faults=None) -> dict:
    """Run one stack on one trace and summarize it — the single runner
    behind ``ExperimentSpec.run`` and ``run_specs``.

    ``scenario`` (a ``repro_torch.core.scenarios.Scenario``) applies its tuned
    per-axis configs and shared container cap via ``Scenario.tune`` before
    materializing.  Policies are always materialized fresh, so repeated
    calls are bit-identical.

    ``faults`` (a ``repro_torch.core.faults.FaultConfig``) injects the failure
    processes; when omitted it defaults to the scenario's own
    ``Scenario.faults``, so chaos scenarios fault every stack they sweep
    identically.  Faultless runs add availability/attempts columns at
    their fair-weather values (1.0 / 1.0) and change nothing else.

    ``cost_per_1k`` folds in the platform-side mitigation spend (snapshot
    storage, bare-pool idle — zero under ``full`` — plus, on bill-idle
    provider profiles like ``modal_gpu``, the idle-capacity surcharge:
    container up-time billed per-second minus the exec ticks already
    billed to requests), also broken out as ``mitigation_per_1k``.
    """
    from repro_torch.core import metrics
    from repro_torch.core.cluster import ClusterSimulator
    if scenario is not None:
        stack = scenario.tune(stack)
        if faults is None:
            faults = scenario.faults
    sim = ClusterSimulator(specs, seed=seed, stack=stack, faults=faults)
    recs = sim.run(list(trace))
    s = metrics.summarize(recs)
    mit_per_1k = sim.mitigation_cost / max(s.n, 1) * 1000.0
    row = {"n": s.n,
           "cold_rate": s.n_cold / max(s.n, 1),
           "cold_starts": sim.cold_starts,
           "p50_s": s.p50_s, "p95_s": s.p95_s, "p99_s": s.p99_s,
           "cost_per_1k": (s.total_cost / max(s.n, 1) * 1000.0
                           + mit_per_1k),
           "mitigation_per_1k": mit_per_1k,
           "evictions": sim.evictions, "prewarms": sim.prewarms,
           "availability": s.availability, "failed": s.n_failed,
           "attempts": s.mean_attempts,
           "hedge_per_1k": s.hedge_cost / max(s.n, 1) * 1000.0}
    if sla is not None:
        if "prime" not in recs.tags_seen:
            kept = recs                 # columnar fast path (no filtering)
        else:
            kept = [r for r in recs if r.tag != "prime"]
        ev = sla.evaluate(kept)
        row["sla"] = ev["sla"]
        row["sla_ok"] = ev["ok"]
        row["sla_violations"] = sorted(k for k, v in ev["violations"].items()
                                       if v)
    return row


# ------------------------------------------------------------ ExperimentSpec
@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One reproducible experiment: a scenario name, the stack to run on
    it, the simulator seed, and the trace scale.  ``versus`` optionally
    names a ``POLICY_STACKS`` entry to grade against (the suite's verdict
    rule: win on both cold rate and p95), so a single JSON artifact can
    reproduce a suite verdict end to end.

    The scenario's own trace seed stays inside the scenario (that is what
    makes two specs on the same scenario comparable); ``seed`` here is the
    cluster's RNG seed (jitter draws).

    ``tuned`` (default True) lets axes left at their default-for-kind form
    pick up the scenario's tuned configs and shared cap (``Scenario.tune``
    — the suite's semantics, and what makes a by-name stack reproduce a
    suite verdict).  Set it False to run the stack verbatim — e.g. to
    measure a tuned scenario *without* its provisioned floor.
    """

    scenario: str
    stack: PolicyStack = BASELINE
    seed: int = 0
    scale: float = 1.0
    versus: str = ""
    tuned: bool = True

    def __post_init__(self):
        if isinstance(self.stack, str):
            object.__setattr__(self, "stack", _named_stack(self.stack))
        elif isinstance(self.stack, Mapping):
            object.__setattr__(self, "stack",
                               PolicyStack.from_dict(self.stack))
        elif not isinstance(self.stack, PolicyStack):
            raise TypeError(f"stack must be a PolicyStack, a POLICY_STACKS "
                            f"name, or a stack dict, got {self.stack!r}")

    # ---------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "stack": self.stack.to_dict(),
                "seed": self.seed, "scale": self.scale,
                "versus": self.versus, "tuned": self.tuned}

    @classmethod
    def from_dict(cls, d: Mapping) -> "ExperimentSpec":
        return cls(**dict(d))

    @classmethod
    def from_file(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------------- run
    def run(self, platform=None) -> "ExperimentResult":
        """Deploy the scenario's fleet, build its trace at ``scale``, run
        the stack (and the ``versus`` stack on the same trace, if named),
        and return a structured result.

        With ``tuned`` (the default), axes left at their default-for-kind
        form pick up the scenario's tuned configs (``Scenario.tune``) and
        non-default knobs always win; with ``tuned=False`` the stack runs
        verbatim.  ``ExperimentResult.effective_stack`` records what
        actually ran either way.

        Without ``platform`` the fleet deploys on a fallback-calibrated
        platform, where a registry language model raises ``KeyError``:
        give a platform built with ``calibrated=`` for those scenarios."""
        from repro_torch.core import scenarios
        from repro_torch.core.platform import ServerlessPlatform
        sc = scenarios.get(self.scenario)
        platform = platform or ServerlessPlatform(
            seed=0, use_fallback_calibration=True)
        specs = sc.deploy(platform)
        trace = sc.build_trace([s.name for s in specs], scale=self.scale)
        # tune exactly once, run what was tuned: the report's
        # effective_stack is by construction the stack that produced it
        effective = sc.tune(self.stack) if self.tuned else self.stack
        row = run_stack(specs, trace, effective, seed=self.seed, sla=sc.sla,
                        faults=sc.faults)
        verdict = None
        if self.versus:
            vs = _named_stack(self.versus)
            other = run_stack(specs, trace,
                              sc.tune(vs) if self.tuned else vs,
                              seed=self.seed, sla=sc.sla, faults=sc.faults)
            if sc.faults is not None:
                # fault scenarios grade on what reliability buys: meet the
                # SLA (availability floor included) and recover more
                # availability than the rival under identical faults
                win = bool(row["sla_ok"] and
                           row["availability"] > other["availability"])
            else:
                win = bool(row["cold_rate"] < other["cold_rate"]
                           and row["p95_s"] < other["p95_s"])
            verdict = {"versus": self.versus, "versus_row": other,
                       "win": win}
        return ExperimentResult(
            spec=self, n_requests=len(trace), fleet=[s.name for s in specs],
            effective_stack=effective.to_dict(), verdict=verdict, **row)


def _named_stack(name: str) -> PolicyStack:
    """Resolve a ``POLICY_STACKS`` name (late import: ``scenarios`` imports
    this module at load time)."""
    from repro_torch.core.scenarios import POLICY_STACKS
    try:
        return POLICY_STACKS[name]
    except KeyError:
        raise KeyError(f"unknown policy stack {name!r}; "
                       f"known: {sorted(POLICY_STACKS)}") from None


@dataclasses.dataclass
class ExperimentResult:
    """Structured outcome of ``ExperimentSpec.run`` — the suite's per-combo
    row plus provenance (the spec itself) and, when ``versus`` was set, a
    verdict.  ``to_dict()`` is the report artifact."""

    spec: ExperimentSpec
    n: int
    n_requests: int
    fleet: list
    cold_rate: float
    cold_starts: int
    p50_s: float
    p95_s: float
    p99_s: float
    cost_per_1k: float
    mitigation_per_1k: float
    evictions: int
    prewarms: int
    availability: float = 1.0
    failed: int = 0
    attempts: float = 1.0
    hedge_per_1k: float = 0.0
    sla: str = ""
    sla_ok: bool = True
    sla_violations: list = dataclasses.field(default_factory=list)
    # the stack that actually ran, after Scenario.tune substituted tuned
    # axis configs / the shared cap — the report's audit trail when the
    # spec's stack left a tuned axis at its default-for-kind form
    effective_stack: Optional[dict] = None
    verdict: Optional[dict] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["spec"] = self.spec.to_dict()
        return d

    def summary_line(self) -> str:
        line = (f"{self.spec.scenario}: n={self.n} "
                f"cold={self.cold_rate:.2%} p95={self.p95_s:.3f}s "
                f"$/1k={self.cost_per_1k:.4f} "
                f"sla={'ok' if self.sla_ok else 'FAIL'}")
        if self.failed or self.attempts > 1.0:
            line += (f" avail={self.availability:.3%} "
                     f"attempts={self.attempts:.2f}")
        if self.verdict is not None:
            o = self.verdict["versus_row"]
            line += (f" | vs {self.verdict['versus']}: cold "
                     f"{o['cold_rate']:.2%} -> {self.cold_rate:.2%}, p95 "
                     f"{o['p95_s']:.3f}s -> {self.p95_s:.3f}s "
                     f"[{'WIN' if self.verdict['win'] else 'NO-WIN'}]")
        return line


# ------------------------------------------------------ parallel sweep runner
# Every ``run_stack`` call is an independent work unit by construction
# (stacks are frozen canonical values, policies materialize fresh per run),
# so a grid sweep fans out over a process pool.  The worker-side scenario
# context — deployed fleet + generated trace — is built ONCE per (scenario,
# scale, calibration) per worker and cached, so a grid shares one trace per
# worker instead of regenerating it per point.  Traces are deterministic
# functions of (scenario, scale), which is what makes the worker-built
# context identical to the parent's and the merged rows identical to a
# serial run.

_WORKER_CTX: dict = {}


def _scenario_ctx(name: str, scale: float, calibrated=None) -> tuple:
    """(scenario, specs, trace) for one scenario at one trace scale on one
    calibration, cached per process.  Without ``calibrated`` it uses the
    default platform (seed 0, fallback calibration); with it, a seed-0
    platform over that cache (``ServerlessPlatform(calibrated=...)``, which
    reads no file and measures nothing) — the configurations a worker can
    rebuild exactly.  The cache is part of the key, so two calibrations
    never share a deployed fleet."""
    key = (name, scale,
           None if calibrated is None else json.dumps(calibrated, sort_keys=True))
    ctx = _WORKER_CTX.get(key)
    if ctx is None:
        from repro_torch.core import scenarios
        from repro_torch.core.platform import ServerlessPlatform
        sc = scenarios.get(name)
        if calibrated is None:
            platform = ServerlessPlatform(seed=0, use_fallback_calibration=True)
        else:
            platform = ServerlessPlatform(seed=0, calibrated=calibrated)
        fleet_specs = sc.deploy(platform)
        trace = sc.build_trace([s.name for s in fleet_specs], scale=scale)
        _WORKER_CTX[key] = ctx = (sc, fleet_specs, trace)
    return ctx


def _spec_row(spec: "ExperimentSpec", calibrated=None) -> dict:
    """Process-pool work unit: one ExperimentSpec -> one run_stack row."""
    sc, fleet_specs, trace = _scenario_ctx(spec.scenario, spec.scale, calibrated)
    return run_stack(fleet_specs, trace, spec.stack, seed=spec.seed,
                     sla=sc.sla, scenario=sc if spec.tuned else None,
                     faults=sc.faults)


def _worker_init(measured: dict) -> None:
    """Hand a worker the parent's measured scaling entries, so that
    ``warm_exec_estimate`` never reads a cache or asks for a card there."""
    from repro_torch.core.cluster import policies
    policies._MEASURED_MODELS = measured


def run_specs(specs: Sequence, *, jobs: int = 1, calibrated=None) -> list:
    """Run ``ExperimentSpec`` work units, optionally in parallel.

    Returns one ``run_stack`` row per spec, in input order.  ``jobs <= 1``
    runs in-process; ``jobs > 1`` fans the pickled specs out over a
    process pool (``fork`` start method where available, so workers
    inherit ``sys.path``).  A worker exception propagates to the caller
    immediately — a raising spec fails the sweep instead of hanging it.

    ``calibrated`` (a loaded v2 calibration cache) deploys each scenario's
    fleet from that cache (``ServerlessPlatform(calibrated=...)``), as the
    scenarios of registry language models need; the workers get it with
    each spec.

    Work units must name *registered* scenarios (workers resolve them via
    ``repro_torch.core.scenarios.get``); results merge back positionally,
    so callers key rows by the spec's canonical ``PolicyStack`` equality.
    """
    specs = [s if isinstance(s, ExperimentSpec) else ExperimentSpec.from_dict(s)
             for s in specs]
    if jobs <= 1:
        return [_spec_row(s, calibrated) for s in specs]
    with pool_executor(jobs) as pool:
        return list(pool.map(_spec_row, specs, [calibrated] * len(specs)))


def pool_executor(jobs: int):
    """The repo's standard sweep pool — one definition so every ``--jobs``
    surface builds it identically.

    A worker never touches the device: a worker forked from a parent that
    has initialised CUDA cannot, and a spawned one need not.  So the
    measured entries that the scaling estimates read
    (``policies._measured_models()``, which asks for a card) are resolved
    here, in the parent, and handed to every worker as a plain dict.

    Start method: ``fork`` while the parent is single-threaded (workers
    inherit ``sys.path`` and loaded modules — the cheap, common case),
    else ``spawn`` — forking a multithreaded parent can deadlock a child
    on a lock the fork snapshotted mid-held.  Spawned workers re-import
    this package, so the package root is propagated via ``PYTHONPATH``
    for children launched outside the documented ``PYTHONPATH=src``
    workflows."""
    import concurrent.futures as cf
    import multiprocessing as mp
    import threading

    from repro_torch.core.cluster import policies
    measured = policies._measured_models()
    method = "fork" if threading.active_count() == 1 else "spawn"
    try:
        mp_ctx = mp.get_context(method)
    except ValueError:                      # platforms without fork at all
        method = "spawn"                    # ... default to spawn semantics
        mp_ctx = None
    if method == "spawn":
        # spawn workers are created lazily (after this returns), so the
        # path must go through the parent's environ — a deliberately
        # persistent, idempotent addition of the package root only
        import os
        import repro_torch
        src = os.path.dirname(next(iter(repro_torch.__path__)))
        pp = os.environ.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            os.environ["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
    return cf.ProcessPoolExecutor(max_workers=jobs, mp_context=mp_ctx,
                                  initializer=_worker_init, initargs=(measured,))
