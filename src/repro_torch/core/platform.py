"""ServerlessPlatform facade: deploy functions, run workloads, report.

This is the top of the paper's stack: an OpenWhisk/Lambda-style event system
over the container/scheduler/billing substrate, with the paper's three CNN
payloads pre-registered and modern ``repro_torch.serving`` handlers attachable.

The platform now fronts the policy-driven ``repro_torch.core.cluster`` subsystem:
construct it with a ``repro_torch.core.stack.PolicyStack`` (``stack=``) — or the
legacy per-axis kwargs, which are a thin shim that builds one — to move off
the Lambda-2017 defaults, and use ``invoke_fleet`` to serve every deployed
function from one shared cluster.

For ready-made workload regimes (sparse / bursty / diurnal / flash-crowd /
multi-function / multi-tenant / GPU-serverless / sharded / chaos) use
``repro_torch.core.scenarios``: each named scenario deploys its fleet
through this facade, and ``repro_torch.core.stack.ExperimentSpec`` and
``run_specs`` run policy stacks over it.

The port's counterpart of ``repro.core.platform``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.  It differs in four
ways, each because the port measures on its own engine:

  * no environment variable: the constructor takes ``device`` (the card
    unless the caller asks for the CPU), ``smoke`` and
    ``calibration_path`` (default: ``calibration.default_cal_path()``) and
    passes them to the port's ``calibrate`` and ``ensure_measured``, where
    the reference reads ``REPRO_CALIBRATION``;
  * no pinned language-model numbers: with ``use_fallback_calibration``
    the paper's CNNs take the paper's figures, and a registry language
    model raises ``KeyError``, since the port pins no numbers it did not
    measure;
  * deploying an unmeasured registry language model measures it through
    the port's engine (on the card, through its kernels) and persists the
    entry to the cache;
  * ``calibrated=`` takes an already loaded v2 cache dict in place of the
    reference's pinned language-model numbers: the handlers are built from
    its entries, the platform reads no file, measures nothing and touches
    no device, a registry model the dict lacks raises ``KeyError``, and a
    paper CNN it lacks takes the paper's figure.  This is how the named
    scenarios of registry models (``gpu_serverless``, ``sharded_110b``)
    run: on the card from the card's own cache, in the CPU tests from the
    reference's pinned entries handed across as a dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import calibration, metrics, sla
from repro_torch.core.cluster import ClusterSimulator
from repro_torch.core.function import FunctionSpec, Handler
from repro_torch.core.stack import KeepaliveConfig, PolicyStack
from repro_torch.core.workload import cold_probe, step_ramp, warm_burst


# sentinel distinguishing "kwarg omitted" from an explicitly passed
# default, so the stack=-conflict guard sees every explicit argument
_UNSET = object()


def _drop_prime(records):
    """Priming requests removed — without materializing the columnar sink's
    lazy record views when no priming request exists (the sink's distinct
    tag set proves that without a scan), so downstream metrics keep their
    columnar fast path."""
    tags_seen = getattr(records, "tags_seen", None)
    if tags_seen is not None and "prime" not in tags_seen:
        return records
    return [r for r in records if r.tag != "prime"]


@dataclasses.dataclass
class InvocationReport:
    spec_name: str
    summary: metrics.Summary
    warm: metrics.Summary
    cold: metrics.Summary
    bimodality: dict
    cold_starts: int


class ServerlessPlatform:
    """Deploy functions and run workloads under one policy stack.

    The policy surface is a single ``repro_torch.core.stack.PolicyStack`` value
    (``stack=``): serializable, derivable via ``with_``, and materialized
    into *fresh* policy instances per invocation — which is what keeps
    repeated experiments independent (no histogram / autoscaler / snapshot
    state leaks across ``invoke()`` calls, uniformly for every axis).

    The per-axis kwargs below remain as a compatibility shim that builds
    that stack (``PolicyStack.from_kwargs``); registry policy instances are
    converted to their config form (constructor knobs captured, learned
    state not).  Hand-written policy subclasses a stack cannot express go
    to ``ClusterSimulator`` directly.

    Policy parameters (all axes of the ``PolicyStack``):

    * ``placement`` — ``"mru"`` (default; best locality, wins sparse
      trickles) | ``"lru"`` (keeps the whole pool warm for bursts) |
      ``"least_loaded"`` (for ``concurrency > 1``), or a policy instance.
    * ``keepalive`` — ``None``/``"fixed"`` (Lambda's fixed idle TTL,
      ``keepalive_s`` seconds, default 480) | ``"adaptive"`` (per-function
      gap histogram; the ``sparse`` scenario's expected winner), or an
      instance.  Policies are materialized fresh per invocation so
      repeated experiments stay independent.
    * ``scaling`` — ``None``/``"lambda"`` (scale-out on demand only) |
      ``"predictive"`` (Knative-style warm-pool sizing; tune via
      ``PredictiveWarmPool(Autoscaler(window_s, margin, min_pool))`` — the
      ``diurnal`` scenario's expected winner), or an instance.
    * ``coldstart`` — ``None``/``"full"`` (every cold pays the whole
      PROVISION -> BOOTSTRAP -> LOAD anatomy) | ``"snapshot"``
      (checkpoint/restore: later colds pay PROVISION + a cheap RESTORE;
      half of ``flash_crowd``'s expected winner) | ``"layered"``
      (shared bootstrapped-sandbox pool: claims pay LOAD only; composes
      with ``max_containers`` in ``multi_function``) | ``"package_cache"``
      (handler-keyed package cache: LOAD skipped on a hit), or an
      instance.  Stateful mitigation policies (snapshots written, cached
      packages) are materialized fresh per invocation like ``keepalive``.
    * ``concurrency`` — in-flight requests per container (default 1);
      above 1, requests slow each other by the cluster's contention
      factor.
    * ``batching`` — a ``BatchingConfig`` queueing arrivals into shared
      passes; the ``bursty`` scenario's expected winner and half of
      ``multi_function``'s.  (Per-fleet ``{fn: config}`` dicts are a
      ``ClusterSimulator``-level feature.)
    * ``max_containers`` — shared cluster-wide container cap (0 =
      unlimited); the contention knob in ``multi_function``.

    See ``repro_torch.core.scenarios`` for the named regimes these
    expectations are graded in.
    """

    def __init__(self, *, seed: int = 0, keepalive_s=_UNSET,
                 use_fallback_calibration: bool = False,
                 device="cuda", smoke: bool = False,
                 calibration_path: Optional[str] = None,
                 calibrated: Optional[dict] = None,
                 stack: Optional[PolicyStack] = None,
                 placement=_UNSET, keepalive=_UNSET, scaling=_UNSET,
                 coldstart=_UNSET, concurrency=_UNSET,
                 batching=_UNSET, max_containers=_UNSET):
        self.seed = seed
        self.keepalive_s = 480.0 if keepalive_s is _UNSET else keepalive_s
        legacy = {"keepalive_s": keepalive_s, "placement": placement,
                  "keepalive": keepalive, "scaling": scaling,
                  "coldstart": coldstart, "concurrency": concurrency,
                  "batching": batching, "max_containers": max_containers}
        if stack is not None:
            conflicts = [n for n, v in legacy.items() if v is not _UNSET]
            if conflicts:
                raise ValueError(
                    f"{conflicts} conflict with stack= (the stack owns "
                    f"every policy axis); derive a variant with "
                    f"stack.with_(...) instead")
            self.stack = stack
        else:
            from repro_torch.core.cluster.cluster import AXIS_DEFAULTS
            defaults = {"keepalive_s": 480.0, **AXIS_DEFAULTS}
            self.stack = PolicyStack.from_kwargs(
                **{n: (defaults[n] if v is _UNSET else v)
                   for n, v in legacy.items()})
        self.functions: dict[str, FunctionSpec] = {}
        self.device, self.smoke = device, smoke
        self.calibration_path = calibration_path or calibration.default_cal_path()
        if calibrated is not None and use_fallback_calibration:
            raise ValueError("calibrated= and use_fallback_calibration=True "
                             "conflict: give one source of handler numbers")
        # a given cache is final: nothing is read, measured or persisted
        self._frozen = calibrated is not None
        if self._frozen:
            self._cal = calibrated
        else:
            self._cal = None if use_fallback_calibration else calibration.calibrate(
                self.calibration_path, smoke=smoke, device=device)
        self._fallback = use_fallback_calibration

    # ------------------------------------------------------------------
    def deploy_paper_model(self, variant: str, memory_mb: int,
                           name: Optional[str] = None) -> FunctionSpec:
        """Deploy one of the paper's CNN payloads.  ``name`` overrides the
        handler name so one model can back many tenant functions (the
        multi-tenant fleet deploys hundreds of functions over three
        models) without their specs colliding in ``self.functions``."""
        return self.deploy_model(variant, memory_mb, name=name)

    def deploy_model(self, model: str, memory_mb: int,
                     name: Optional[str] = None,
                     provider: str = "lambda") -> FunctionSpec:
        """Deploy any calibrated model: a paper CNN by variant name, or a
        ``repro_torch.configs.registry`` arch id served through the modern
        engine handler (per-model phase costs + batch-efficiency curve
        from the calibration cache, measured first through the port's
        engine when absent; ``KeyError`` when the platform runs
        fallback-calibrated, or when a ``calibrated=`` cache lacks the
        model).  ``provider`` picks the
        ``repro_torch.core.providers`` profile the function runs on."""
        if model in calibration.PAPER_MODELS:
            h = calibration.paper_handler(model, calibrated=self._cal,
                                          use_fallback=self._fallback)
        else:
            missing = model not in (self._cal or {}).get("models", {})
            if self._frozen and missing:
                raise KeyError(
                    f"{model!r} is not in the calibration given as calibrated= "
                    f"(it holds {sorted(self._cal.get('models', {}))}); this "
                    f"platform measures nothing")
            if not self._fallback and missing:
                self._cal = calibration.ensure_measured(
                    self._cal, model, self.calibration_path, smoke=self.smoke,
                    device=self.device)
            h = calibration.modern_handler(model, calibrated=self._cal)
        if name is not None:
            h = dataclasses.replace(h, name=name)
        return self.deploy(h, memory_mb, provider=provider)

    def deploy(self, handler: Handler, memory_mb: int,
               provider: str = "lambda") -> FunctionSpec:
        spec = FunctionSpec(handler=handler, memory_mb=memory_mb,
                            provider=provider)
        self.functions[spec.name] = spec
        return spec

    # ------------------------------------------------------------------
    # the policy axes, derived from the stack itself so a new axis is one
    # PolicyStack field away from per-call overrides and conflict checks
    _STACK_AXES = tuple(f.name for f in dataclasses.fields(PolicyStack))

    def _cluster(self, specs, keepalive_s: Optional[float] = None,
                 **overrides) -> ClusterSimulator:
        # Per-call axis overrides derive a one-off stack; an explicit
        # per-call TTL wins over everything (the pre-refactor invoke()
        # contract).  PolicyStack.materialize() then builds fresh policy
        # instances — the single state-isolation rule for every axis
        # (keepalive histograms, autoscalers, snapshots, package caches,
        # batchers, placement alike).
        stack = self.stack
        axis_over = {k: overrides.pop(k) for k in list(overrides)
                     if k in self._STACK_AXES}
        if "keepalive" in axis_over and \
                isinstance(axis_over["keepalive"], (str, type(None))):
            # a by-name per-call keepalive keeps the platform's TTL as its
            # (base) TTL, matching the legacy make_keepalive contract
            axis_over["keepalive"] = KeepaliveConfig(
                kind=axis_over["keepalive"] or "fixed",
                ttl_s=self.keepalive_s)
        if axis_over:
            stack = stack.with_(**axis_over)
        if keepalive_s is not None and "keepalive" not in axis_over:
            # matches the legacy kw.update(overrides) precedence: an
            # explicit per-call keepalive policy beats the per-call TTL
            stack = stack.with_(keepalive=KeepaliveConfig(ttl_s=keepalive_s))
        kw = dict(stack=stack, seed=self.seed)
        kw.update(overrides)
        return ClusterSimulator(specs, **kw)

    def invoke(self, spec: FunctionSpec, workload: list,
               keepalive_s: Optional[float] = None, **overrides):
        """Run one function's workload under the platform's policy stack.

        ``keepalive_s`` forces a fixed TTL for this call; policies are
        materialized fresh per call, so repeated invocations are
        reproducible."""
        sim = self._cluster(spec, keepalive_s, **overrides)
        records = sim.run(list(workload))
        return _drop_prime(records), sim

    def invoke_fleet(self, workload: list,
                     keepalive_s: Optional[float] = None, **overrides):
        """Serve every deployed function from one shared cluster; requests
        route by ``Request.fn`` (a FunctionSpec ``name``)."""
        sim = self._cluster(dict(self.functions), keepalive_s, **overrides)
        records = sim.run(list(workload))
        return _drop_prime(records), sim

    def report(self, spec: FunctionSpec, records, sim) -> InvocationReport:
        return InvocationReport(
            spec_name=spec.name,
            summary=metrics.summarize(records),
            warm=metrics.summarize(records, warm_only=True),
            cold=metrics.summarize(records, cold_only=True),
            bimodality=sla.bimodality_report(records),
            cold_starts=sim.cold_starts)

    # convenience runs matching the paper's three experiments -----------
    def run_cold_experiment(self, spec: FunctionSpec):
        recs, sim = self.invoke(spec, cold_probe())
        return self.report(spec, recs, sim)

    def run_warm_experiment(self, spec: FunctionSpec):
        recs, sim = self.invoke(spec, warm_burst())
        return self.report(spec, recs, sim)

    def run_scalability_experiment(self, spec: FunctionSpec):
        recs, sim = self.invoke(spec, step_ramp())
        return self.report(spec, recs, sim)
