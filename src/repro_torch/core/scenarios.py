"""Named evaluation scenarios: trace + fleet + SLA + expected winner.

The scenario harness turns the repo from "one experiment" into a library of
workload regimes, each paired with the policy stack that is expected to win
there (cf. the bursty production loads of Wu et al., arXiv:2103.02958,
and the pre-warming lever surveyed by Kojs, arXiv:2311.13587).

A ``Scenario`` bundles everything a sweep or an ``ExperimentSpec`` needs:

  * ``functions`` — the fleet: (model, memory tier, provider) triples
    deployed on a ``ServerlessPlatform`` (paper CNNs or calibrated
    registry models; Lambda-style or GPU-serverless provider profiles);
    the first entry is the default-route fleet.
  * ``trace`` — a factory ``(fn_names, seed, scale) -> list[Request]``
    built from ``repro_torch.core.workload`` generators.  ``scale`` lets CI
    run tiny smoke variants of the same scenario (``tiny_scale`` is the
    smoke choice); most scenarios multiply trace duration by
    it, while ``multi_tenant`` multiplies the aggregate rate so the
    day-long diurnal shape survives scaling.
  * ``sla`` — the ``repro_torch.core.sla.SLA`` bound the report grades
    against.
  * ``expected_winner`` — a ``POLICY_STACKS`` name; the suite's verdict
    compares this stack against ``baseline`` on cold rate and p95.
  * ``rival`` — optional second ``POLICY_STACKS`` name the winner must
    also beat on cold-start rate (the pre-mitigation winner, so the
    cold-start axis is graded against the best classic stack, not just
    the Lambda baseline).
  * ``max_containers`` — shared cluster cap (0 = unlimited), the
    multi-function contention knob (``Scenario.tune`` applies it to any
    stack that does not set its own cap).
  * ``tuning`` — per-axis ``repro_torch.core.stack`` configs
    (``KeepaliveConfig`` / ``ScalingConfig`` / ``ColdstartConfig``) tuned
    for this scenario's regime.  ``Scenario.tune(stack)`` substitutes each
    one into a swept stack whose axis selects the same ``kind`` —
    replacing the old per-scenario policy *factories* with declarative
    stack overrides that serialize like everything else.

Use ``get(name)`` / ``names()`` to consume the registry, ``register`` to
extend it (e.g. a replayed production trace via ``workload.trace_replay``).

The port's counterpart of ``repro.core.scenarios``: the same stacks, fleets,
trace factories, tunings and constants, over the port's workload
generators, so that each scenario gives the reference's trace request by
request and the reference's rows on equal handlers.  The registry language
models of ``gpu_serverless`` (deepseek-7b) and ``sharded_110b``
(qwen1.5-110b) deploy only from a measured calibration (the port pins no
numbers it did not measure): on a platform built with ``calibrated=``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

from repro_torch.core import workload as wl
from repro_torch.core.cluster import BatchingConfig
from repro_torch.core.faults import FaultConfig
from repro_torch.core.sla import GPU_INTERACTIVE, INTERACTIVE, SLA
from repro_torch.core.stack import (BASELINE, ColdstartConfig, KeepaliveConfig,
                              PolicyStack, ReliabilityConfig, ScalingConfig,
                              ShardingConfig)

# Named policy stacks: the single-axis stacks differ from ``baseline`` on
# exactly one axis, so a scenario verdict attributes the win to that axis;
# ``batching_predictive`` combines the two levers that attack different
# bottlenecks (queueing vs cold pools) for the shared-cap scenario, and the
# mitigation-bearing stacks compose a ColdStartPolicy with the stack it
# upgrades (e.g. ``snapshot_predictive`` = predictive scaling whose
# prewarms restore from snapshots).  Values are ``PolicyStack`` instances —
# serializable, hashable, and derivable via ``with_``; the suite applies
# per-scenario tuned axis configs via ``Scenario.tune``.  Every stack is a
# point in the suite's sweep cross-product, so verdicts read straight out
# of the sweep table.
_BATCH = BatchingConfig(max_batch=4, max_wait_s=0.5)

POLICY_STACKS: dict = {
    "baseline": BASELINE,
    "adaptive": BASELINE.with_(keepalive="adaptive"),
    "predictive": BASELINE.with_(scaling="predictive"),
    "batching": BASELINE.with_(batching=_BATCH),
    "batching_predictive": BASELINE.with_(scaling="predictive",
                                          batching=_BATCH),
    # --- cold-start mitigation axis (single-axis attributions) ----------
    "snapshot": BASELINE.with_(coldstart="snapshot"),
    "layered_pool": BASELINE.with_(coldstart="layered"),
    "package_cache": BASELINE.with_(coldstart="package_cache"),
    # --- composed mitigation stacks (the new scenario winners) ----------
    "pool_predictive": BASELINE.with_(scaling="predictive",
                                      coldstart="layered"),
    "snapshot_predictive": BASELINE.with_(scaling="predictive",
                                          coldstart="snapshot"),
    "snapshot_batching_predictive": BASELINE.with_(
        scaling="predictive", coldstart="snapshot", batching=_BATCH),
    "pool_batching_predictive": BASELINE.with_(
        scaling="predictive", coldstart="layered", batching=_BATCH),
    # --- distributed inference (gang-scheduled shard fan-out) -----------
    # independent placement multiplies the cold tail with fan-out (the
    # FSD-Inference failure mode the sharded_110b scenario demonstrates);
    # ``sharded_gang`` co-places the gang in one reclamation domain and
    # re-warms reclaimed shards, recovering the WIN
    "sharded_4": BASELINE.with_(sharding=ShardingConfig(kind="gang",
                                                        fanout=4)),
    "sharded_8": BASELINE.with_(sharding=ShardingConfig(kind="gang",
                                                        fanout=8)),
    "sharded_gang": BASELINE.with_(sharding=ShardingConfig(
        kind="gang", fanout=8, co_place=True, gang_prewarm=True)),
    # --- reliability ladder (DESIGN.md §11): cumulative rungs graded by
    # the chaos scenario — retries recover availability, hedging cuts the
    # fault tail, degrade keeps serving through throttle storms
    "retry": BASELINE.with_(reliability="retry"),
    "retry_hedge": BASELINE.with_(reliability="hedge"),
    "retry_hedge_degrade": BASELINE.with_(reliability="degrade"),
}

# which Scenario.tuning config type tunes which PolicyStack axis
_TUNED_AXES = {KeepaliveConfig: "keepalive", ScalingConfig: "scaling",
               ColdstartConfig: "coldstart",
               ReliabilityConfig: "reliability"}


@dataclasses.dataclass(frozen=True)
class FleetFunction:
    """One deployed function in a scenario's fleet.

    ``name`` (optional) renames the deployed handler so one paper model
    can back many tenant functions — the multi-tenant fleet deploys
    hundreds of functions over three models, and each needs a distinct
    ``FunctionSpec.name`` to route by.
    """
    model: str            # calibration.PAPER_MODELS key or registry arch id
    memory_mb: int = 1024
    name: str = ""        # handler rename; "" keeps the model name
    provider: str = "lambda"   # repro_torch.core.providers profile name


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    functions: Tuple[FleetFunction, ...]
    trace: Callable       # (fn_names, seed, scale) -> list[Request]
    sla: SLA
    expected_winner: str
    max_containers: int = 0
    seed: int = 0
    tiny_scale: float = 0.02
    tuning: Tuple = ()    # per-axis stack configs (Keepalive/Scaling/
                          # ColdstartConfig) tuned for this regime
    rival: str = ""                         # stack the winner must beat on
                                            # cold rate (pre-mitigation best)
    stream_trace: Optional[Callable] = None  # (fn_names, seed, scale) ->
                                             # Iterator[Request]: a lazy
                                             # variant of ``trace`` for
                                             # day-scale streaming runs
    sweep_axes: Optional[dict] = None   # suite sweep override: {axis:
                                        # values}; None keeps the suite's
                                        # default cross-product (AXES).
                                        # Scenarios probing one axis (e.g.
                                        # the sharding fan-out ladder) pin
                                        # the others to the baseline kind
                                        # so the report stays readable.
    faults: Optional[FaultConfig] = None    # chaos injection: every stack
                                            # the suite sweeps on this
                                            # scenario runs under the SAME
                                            # seeded failure processes, so
                                            # availability deltas are pure
                                            # policy effects.  None keeps
                                            # fair-weather semantics.

    def __post_init__(self):
        for cfg in self.tuning:
            if type(cfg) not in _TUNED_AXES:
                raise TypeError(
                    f"{self.name}: tuning entries must be KeepaliveConfig / "
                    f"ScalingConfig / ColdstartConfig / ReliabilityConfig, "
                    f"got {cfg!r} (the other axes have no per-scenario "
                    f"tuning — put them on the stack itself)")

    def deploy(self, platform) -> list:
        """Deploy the fleet on ``platform``; returns specs in fleet order."""
        return [platform.deploy_model(f.model, f.memory_mb,
                                      name=f.name or None,
                                      provider=f.provider)
                for f in self.functions]

    def tune(self, stack: PolicyStack) -> PolicyStack:
        """Specialize a swept stack for this scenario: substitute each
        ``tuning`` config into an axis that selected the same ``kind``
        *with default knobs* (exactly what ``PolicyStack.grid`` over kind
        names produces — so e.g. a tuned predictive autoscaler applies to
        stacks that chose ``scaling="predictive"`` but never clobbers
        non-default knobs in a hand-built spec; a spec opts out entirely
        with ``ExperimentSpec(tuned=False)``), and apply the
        scenario's shared container cap to stacks that do not set their
        own.  Sweep keys stay the canonical un-tuned stacks; tuning
        happens at run time, and ``ExperimentResult.effective_stack``
        records the outcome."""
        overrides: dict = {}
        for cfg in self.tuning:
            axis = _TUNED_AXES[type(cfg)]
            if getattr(stack, axis) == type(cfg)(kind=cfg.kind):
                overrides[axis] = cfg
        if self.max_containers and not stack.max_containers:
            overrides["max_containers"] = self.max_containers
        return stack.with_(**overrides) if overrides else stack

    def build_trace(self, fn_names: list, scale: float = 1.0) -> list:
        if len(fn_names) != len(self.functions):
            raise ValueError(f"{self.name}: expected "
                             f"{len(self.functions)} fleet names, got "
                             f"{len(fn_names)}")
        if self.expected_winner not in POLICY_STACKS:
            raise KeyError(f"{self.name}: unknown expected winner "
                           f"{self.expected_winner!r}")
        if self.rival and self.rival not in POLICY_STACKS:
            raise KeyError(f"{self.name}: unknown rival {self.rival!r}")
        return self.trace(list(fn_names), self.seed, scale)

    def build_stream(self, fn_names: list, scale: float = 1.0):
        """Lazy counterpart of ``build_trace`` for scenarios that provide a
        streaming generator (``stream_trace``) — same requests, never
        materialized.  Fed straight into the simulator, a 10M-request day
        runs in bounded memory."""
        if self.stream_trace is None:
            raise ValueError(f"{self.name} has no streaming trace variant; "
                             f"use build_trace")
        if len(fn_names) != len(self.functions):
            raise ValueError(f"{self.name}: expected "
                             f"{len(self.functions)} fleet names, got "
                             f"{len(fn_names)}")
        return self.stream_trace(list(fn_names), self.seed, scale)


SCENARIOS: dict = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {scenario.name!r}")
    SCENARIOS[scenario.name] = scenario
    return scenario


def get(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {names()}") from None


def names() -> list:
    return sorted(SCENARIOS)


# --------------------------------------------------------------- the library
# sparse: the original policy_sweep regime.  P(gap > 480 s TTL) ~ 15% at
# 0.004 rps, so the fixed TTL leaks cold starts; the adaptive histogram
# learns the true gap distribution.
SPARSE_RATE_RPS = 0.004
SPARSE_DURATION_S = 250_000.0

register(Scenario(
    name="sparse",
    description="Sparse Poisson trickle (the paper's cold-start regime): "
                "mean gap 250 s vs the 480 s Lambda TTL.",
    functions=(FleetFunction("resnet18", 1024),),
    trace=lambda fns, seed, scale: wl.poisson(
        SPARSE_RATE_RPS, SPARSE_DURATION_S * scale, seed=seed),
    sla=INTERACTIVE,
    expected_winner="adaptive",
    seed=5,
    tiny_scale=0.02,
))

# bursty: short 2 rps bursts separated by ~20-minute idle dwells, so the
# fixed TTL evicts the pool between bursts and every burst head pays a
# thundering herd of colds.  Batching absorbs the herd into shared passes
# (fewer containers, amortized cost); the predictive axis also wins here
# via its provisioned-concurrency floor (min_pool) — both visible in the
# sweep table.
register(Scenario(
    name="bursty",
    description="On/off MMPP: 2 rps bursts (~30 s) separated by ~20 min "
                "idle dwells that defeat the fixed TTL.",
    functions=(FleetFunction("resnet18", 1024),),
    trace=lambda fns, seed, scale: wl.mmpp_bursty(
        rate_on_rps=2.0, rate_off_rps=0.01, mean_on_s=30.0,
        mean_off_s=1200.0, duration_s=40_000.0 * scale, seed=seed),
    sla=INTERACTIVE,
    expected_winner="batching",
    seed=7,
    tiny_scale=0.05,
    tuning=(ScalingConfig(kind="predictive", min_pool=3),),
))

# diurnal: a deep day/night cycle on the heaviest model at its smallest
# legal tier (resnext50@448: ~7.5 s cold starts).  The near-zero trough
# outlasts the fixed TTL, so the baseline regrows its pool every "morning";
# the predictive pool's rate window plus a small floor keeps the ramp warm.
register(Scenario(
    name="diurnal",
    description="Sinusoid day/night Poisson (2 h period, 8 cycles, deep "
                "trough): the pool dies overnight and regrows at dawn; "
                "prediction beats reaction.",
    functions=(FleetFunction("resnext50", 448),),
    trace=lambda fns, seed, scale: wl.diurnal(
        base_rps=0.008, amplitude=0.98, period_s=7200.0,
        duration_s=57_600.0 * scale, seed=seed),
    sla=INTERACTIVE,
    expected_winner="predictive",
    seed=11,
    tiny_scale=0.05,
    tuning=(ScalingConfig(kind="predictive", window_s=600.0, margin=2.0,
                          min_pool=3),),
))

# flash_crowd: one sudden 4 rps spike on the heavy model.  The first cold
# start takes ~9.7 s and every spike arrival inside that window cold-starts
# its own container (thundering herd); a provisioned floor sized for the
# anticipated event (min_pool=6 ~ spike_rps * service_time) absorbs most of
# the onset, but composing it with the bare-sandbox pool beats it on cold
# rate: whatever leaks past the floor claims a bootstrapped sandbox (a
# prewarm start paying only LOAD) instead of cold-starting, and every
# claim immediately re-provisions its replacement — so ``pool_predictive``
# is the graded winner with the plain predictive floor as the
# pre-mitigation rival it must beat.  SnapshotRestore is the
# cost-conscious runner-up (the cold tail collapses for ~zero spend, but
# restores still count cold).  The adaptive histogram still LOSES here —
# it learns the dense trickle gaps, shrinks the TTL, and makes the
# trickle itself cold.
register(Scenario(
    name="flash_crowd",
    description="Steady trickle with one 4 rps flash crowd (60 s) on the "
                "heavy model: the onset herd cold-starts a container per "
                "request until the first cold start completes.",
    functions=(FleetFunction("resnext50", 448),),
    trace=lambda fns, seed, scale: wl.flash_crowd(
        base_rps=0.05, spike_rps=4.0, spike_at_s=1200.0 * scale,
        spike_len_s=60.0, duration_s=3600.0 * scale + 60.0, seed=seed),
    sla=INTERACTIVE,
    expected_winner="pool_predictive",
    rival="predictive",
    seed=13,
    tiny_scale=0.2,
    tuning=(ScalingConfig(kind="predictive", window_s=60.0, margin=2.0,
                          min_pool=6),),
))

# multi_function: three models with heterogeneous streams contending for a
# 3-container cap.  The bursty fleet's scale-outs evict the other fleets'
# warm containers and throttle its own bursts (requeue delays dominate
# p95); batching packs each burst into one container while the predictive
# floor keeps one warm container per fleet.  The shared bare-sandbox pool
# is the mitigation that composes with the cap: the eviction-churn and
# burst-head colds that remain become pool claims (any fleet may take one,
# paying only its own LOAD), driving the cold rate to ~zero — so the
# combined ``pool_batching_predictive`` stack is the graded winner, with
# ``batching_predictive`` as the rival it must beat on cold rate.
register(Scenario(
    name="multi_function",
    description="Three-model fleet (diurnal + bursty + sparse streams) "
                "sharing a 3-container cap: policies compete for capacity.",
    functions=(FleetFunction("squeezenet", 1024),
               FleetFunction("resnet18", 1024),
               FleetFunction("resnext50", 1536)),
    trace=lambda fns, seed, scale: wl.multi_function_trace(
        {fns[0]: lambda s: wl.diurnal(base_rps=0.05, amplitude=0.9,
                                      period_s=3600.0,
                                      duration_s=28_800.0 * scale, seed=s),
         fns[1]: lambda s: wl.mmpp_bursty(rate_on_rps=2.0,
                                          rate_off_rps=0.01,
                                          mean_on_s=30.0, mean_off_s=1200.0,
                                          duration_s=28_800.0 * scale,
                                          seed=s),
         fns[2]: 0.003},
        28_800.0 * scale, seed=seed),
    sla=INTERACTIVE,
    expected_winner="pool_batching_predictive",
    rival="batching_predictive",
    max_containers=3,
    seed=17,
    tiny_scale=0.05,
    tuning=(ScalingConfig(kind="predictive", min_pool=1),),
))

# multi_tenant: an Azure-Functions-style production day (Shahrad et al.,
# ATC'20 shape): hundreds of functions whose request rates follow a Zipf
# heavy tail — a few hot functions carry most of the traffic while the
# long tail arrives so sparsely that the fixed 480 s TTL expires between
# almost every pair of tail invocations.  Each function gets its own
# diurnal phase (tenants peak at different hours) and an 85/15
# interactive/batch class mix.  The per-function adaptive gap histogram
# is the lever that fits this shape: hot functions learn short gaps and
# keep their pool tight, tail functions learn their true multi-hour gaps
# and stretch the TTL to cover them — one policy, per-tenant behavior.
# Unlike the other scenarios, ``scale`` here multiplies the *aggregate
# rate* (total_rps), not the duration: a tiny smoke run is still a full
# day, just a quieter one, so the diurnal shape the generator encodes is
# preserved at every scale.
MULTI_TENANT_FNS = 200
MULTI_TENANT_RPS = 0.6
_MT_MODELS = ("squeezenet", "resnet18", "resnext50")
_MT_TIERS = (1024, 1024, 1536)


def _multi_tenant_fleet() -> Tuple[FleetFunction, ...]:
    return tuple(FleetFunction(_MT_MODELS[i % 3], _MT_TIERS[i % 3],
                               name=f"mt{i:03d}")
                 for i in range(MULTI_TENANT_FNS))


def _multi_tenant_stream(fns, seed, scale):
    return wl.azure_multitenant_stream(
        fn_names=fns, total_rps=MULTI_TENANT_RPS * scale, alpha=1.2,
        duration_s=86_400.0, seed=seed)


# gpu_serverless: the 2017 cold-start economics replayed on a 2024-style
# GPU serverless provider (Modal-shaped profile: ~6.5 s flat provision,
# per-second GPU pricing that bills idle capacity, 300 s scaledown).  An
# LLM endpoint (deepseek-7b via the calibrated modern-engine handler, so
# LOAD carries the measured param init + warm-up) sees a sparse Poisson
# trickle whose mean gap (400 s) sits beyond the provider's 300 s
# scaledown: the fixed-TTL baseline goes cold on ~47% of requests
# (P(gap > 300) = e^(-300/400)), each cold paying the full ~10 s GPU spin-
# up against a seconds-scale SLA.  The adaptive gap histogram learns the
# true distribution and stretches the TTL past the provider default —
# trading idle GPU-seconds (visible as ``mitigation_per_1k``, the
# idle-capacity surcharge this provider's billing model exposes) for a
# near-zero cold rate.  Same paper claim, new hardware decade.
GPU_SPARSE_RATE_RPS = 0.0025
GPU_SPARSE_DURATION_S = 160_000.0

register(Scenario(
    name="gpu_serverless",
    description="Modal-style GPU endpoint: sparse LLM trickle (mean gap "
                "400 s) vs a 300 s scaledown; per-second GPU billing "
                "charges idle capacity, cold starts cost ~10 s.",
    functions=(FleetFunction("deepseek-7b", 16384, provider="modal_gpu"),),
    trace=lambda fns, seed, scale: wl.poisson(
        GPU_SPARSE_RATE_RPS, GPU_SPARSE_DURATION_S * scale, seed=seed),
    sla=GPU_INTERACTIVE,
    expected_winner="adaptive",
    seed=23,
    tiny_scale=0.2,
    tuning=(KeepaliveConfig(kind="fixed", ttl_s=300.0),
            KeepaliveConfig(kind="adaptive", ttl_s=300.0)),
))

# sharded_110b: distributed inference on a model that cannot fit one
# sandbox at real scale (qwen1.5-110b), fanned out across N gang-scheduled
# shard sandboxes (DESIGN.md §10; FSD-Inference, arXiv:2403.15195).  The
# same sparse trickle the paper's cold-start regime uses becomes an
# amplifier under fan-out: the request is cold if ANY shard is cold, and
# independently placed shards also get reclaimed early (one-sided
# per-domain TTL factors), so the Lambda-baseline cold rate GROWS with N —
# the report's N ∈ {1, 4, 8} ladder shows the 1-(1-p)^N law in the cold
# column.  The tuned ``sharded_gang`` stack recovers the WIN at N=8:
# co-placement pins the gang in one reclamation domain (shards live and
# die together, like a single sandbox) and gang prewarm replaces a
# reclaimed shard ahead of demand, so only the very first request pays a
# gang cold.  The sweep pins the non-sharding axes to the baseline kinds —
# the scenario grades the sharding axis, and the fan-out ladder is the
# story, not a 640-point cross-product.
SHARDED_RATE_RPS = 0.004
SHARDED_DURATION_S = 250_000.0

register(Scenario(
    name="sharded_110b",
    description="Gang-scheduled 110B shard fan-out on a sparse trickle: "
                "cold-if-any-shard-cold multiplies the tail with N; "
                "co-placement + gang prewarm recover the WIN.",
    functions=(FleetFunction("qwen1.5-110b", 1536),),
    trace=lambda fns, seed, scale: wl.poisson(
        SHARDED_RATE_RPS, SHARDED_DURATION_S * scale, seed=seed),
    sla=INTERACTIVE,
    expected_winner="sharded_gang",
    rival="sharded_8",
    seed=29,
    tiny_scale=0.02,
    sweep_axes={
        "placement": ("mru",), "keepalive": ("fixed",),
        "scaling": ("lambda",), "coldstart": ("full",),
        "concurrency": (1,), "batching": (None,),
        "sharding": (None,
                     ShardingConfig(kind="gang", fanout=4),
                     ShardingConfig(kind="gang", fanout=8),
                     ShardingConfig(kind="gang", fanout=8, co_place=True),
                     ShardingConfig(kind="gang", fanout=8, co_place=True,
                                    gang_prewarm=True)),
    },
))

# unreliable_burst: the chaos scenario (DESIGN.md §11).  A steady 1.5 rps
# stream on the primary fleet runs through a faulted provider: per-attempt
# provision failures (2%) and mid-exec crashes (1%) plus correlated
# throttle storms (~2 per hour, ~2 min long, 90% 429s while ON).  The
# reliability ladder is the story, and each rung buys a different thing:
#
#   * ``none``   — every fault is a failed request: availability ~90%.
#   * ``retry``  — backoff + retries absorb the *transient* faults
#     (provision, crash) but cannot outlast a 2-minute storm, so
#     availability recovers only to ~95%.
#   * ``hedge``  — same availability as retry; the speculative duplicate
#     cuts the latency tail the retries created.
#   * ``degrade``— the shed signal (attempt failures within the window)
#     trips a few seconds into each storm and routes arrivals + mid-storm
#     retries to the cheap ``fallback`` fleet (a different resource class,
#     outside the storm), recovering availability past the SLA's 99.9%
#     floor at bounded extra cost.
#
# All stacks run under the SAME seeded fault processes (``Scenario.faults``)
# — availability deltas in the report are pure policy effects.  The sweep
# pins the non-reliability axes to the baseline kinds: the ladder is the
# report, not a cross-product.
UNRELIABLE_RATE_RPS = 1.5
UNRELIABLE_DURATION_S = 3600.0

register(Scenario(
    name="unreliable_burst",
    description="Chaos regime: provision failures, mid-exec crashes, and "
                "2-minute throttle storms; the reliability ladder "
                "(retry -> hedge -> degrade) recovers availability to "
                ">= 99.9% at bounded cost.",
    functions=(FleetFunction("resnet18", 1024),
               FleetFunction("squeezenet", 512, name="fallback")),
    trace=lambda fns, seed, scale: wl.multi_function_trace(
        {fns[0]: UNRELIABLE_RATE_RPS, fns[1]: 0.01},
        UNRELIABLE_DURATION_S * scale, seed=seed),
    sla=SLA("interactive_ha", p95_s=2.0, p99_s=10.0,
            min_availability=0.999),
    expected_winner="retry_hedge_degrade",
    rival="retry",
    seed=31,
    tiny_scale=0.1,
    tuning=(ReliabilityConfig(kind="degrade", max_attempts=6,
                              degrade_to="fallback@512"),),
    sweep_axes={
        "placement": ("mru",), "keepalive": ("fixed",),
        "scaling": ("lambda",), "coldstart": ("full",),
        "concurrency": (1,), "batching": (None,),
        "reliability": (None,
                        ReliabilityConfig(kind="retry"),
                        ReliabilityConfig(kind="hedge"),
                        ReliabilityConfig(kind="degrade")),
    },
    faults=FaultConfig(provision_fail=0.02, exec_crash=0.01,
                       storms_per_day=48, storm_mean_s=120.0,
                       storm_throttle_p=0.9, seed=97),
))

register(Scenario(
    name="multi_tenant",
    description="Azure-style multi-tenant day: 200 functions, Zipf(1.2) "
                "popularity, per-function diurnal phases, 85/15 "
                "interactive/batch mix; the tail lives beyond the fixed "
                "TTL.",
    functions=_multi_tenant_fleet(),
    trace=lambda fns, seed, scale: list(_multi_tenant_stream(
        fns, seed, scale)),
    stream_trace=_multi_tenant_stream,
    sla=INTERACTIVE,
    expected_winner="adaptive",
    seed=19,
    tiny_scale=0.04,
))
