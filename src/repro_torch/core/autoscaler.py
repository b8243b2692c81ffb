"""Demand tracking / scale-out accounting (paper §3.4).

Lambda scales out implicitly (one container per concurrent request); the
platform-side view of that scaling is what the paper's Fig 8-10 exercise.
``concurrency_profile`` reconstructs the in-flight/container timeline from
simulator records; ``Autoscaler`` adds the beyond-paper predictive policy
(target warm-pool sizing from recent arrival rate — Knative-style).

The port's counterpart of ``repro.core.autoscaler``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# How much arrival history cluster fleets retain for scaling decisions.
# An Autoscaler window larger than this would silently underestimate the
# rate (the divisor would exceed the retained history span), so Autoscaler
# validates against it.
ARRIVAL_HISTORY_S = 600.0


def concurrency_profile(records, dt: float = 0.1) -> dict:
    """Timeline of in-flight requests and distinct containers."""
    if not records:
        return {"t": [], "inflight": [], "containers": 0}
    t0 = min(r.arrival_s for r in records)
    t1 = max(r.end_s for r in records)
    ts = np.arange(t0, t1 + dt, dt)
    inflight = np.zeros_like(ts)
    for r in records:
        inflight[(ts >= r.arrival_s) & (ts < r.end_s)] += 1
    return {"t": ts.tolist(), "inflight": inflight.tolist(),
            "containers": len({r.container_id for r in records}),
            "peak_inflight": int(inflight.max())}


@dataclasses.dataclass
class Autoscaler:
    """Predictive warm-pool sizing: pool = ceil(rate * service_time * margin).

    Knobs (defaults preserve the original reactive-only behaviour):

    * ``window_s`` — arrival-rate estimation window.  Must stay at or below
      the cluster's ``ARRIVAL_HISTORY_S`` horizon (validated at
      construction); short windows react to bursts, long ones smooth
      diurnal ramps.
    * ``margin`` — head-room multiplier over the Little's-law pool size
      (``rate * service_time``), absorbing Poisson overdispersion.
    * ``min_pool`` — provisioned-concurrency floor (AWS provisioned
      concurrency / Knative ``minScale``): never size the warm pool below
      this, regardless of the observed rate.  This is what lets
      ``PredictiveWarmPool`` win bursty/diurnal regimes (scenarios
      ``bursty`` / ``diurnal``): rate-proportional sizing alone sees an
      empty window between bursts or overnight, lets the pool die, and
      pays a thundering herd of cold starts at the next ramp; the floor
      keeps the ramp's first requests warm.  The cost is idle capacity
      between bursts — visible as prewarm/eviction churn in the reports.
    """
    window_s: float = 5.0
    margin: float = 1.5
    min_pool: int = 0

    def __post_init__(self):
        if not 0.0 < self.window_s <= ARRIVAL_HISTORY_S:
            raise ValueError(
                f"window_s={self.window_s} outside (0, {ARRIVAL_HISTORY_S}]:"
                f" fleets only retain {ARRIVAL_HISTORY_S:.0f} s of arrival "
                f"history, so a larger window underestimates the rate")
        if self.min_pool < 0:
            raise ValueError(f"min_pool must be >= 0, got {self.min_pool}")

    def desired_pool(self, arrivals: list, now: float,
                     service_time_s: float) -> int:
        recent = [a for a in arrivals if now - self.window_s <= a <= now]
        rate = len(recent) / self.window_s
        demand = int(np.ceil(rate * service_time_s * self.margin))
        return max(demand, self.min_pool)
