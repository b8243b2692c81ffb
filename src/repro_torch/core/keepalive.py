"""Keep-alive policy studies (paper §5: "a declarative way to describe ...
the minimum time to keep warm containers").

The simulator's baseline is Lambda's fixed idle TTL.  This module adds the
policies the paper asks for, plus the analysis connecting TTL to the
cost/latency frontier:

  * FixedTTL        — Lambda baseline (drives ClusterSimulator evictions).
  * AdaptiveTTL     — histogram-adaptive TTL from observed inter-arrival
                      gaps (drives ClusterSimulator evictions when selected).
  * BudgetTTL       — largest TTL whose provider-side container-seconds stay
                      under a budget for an expected request rate.
  * PrewarmSchedule — keep N containers warm ahead of a known ramp
                      (predictive pre-warm; eliminates ramp colds entirely).

FixedTTL/AdaptiveTTL are the ``repro_torch.core.cluster.policies`` classes,
re-exported here so keep-alive studies import from one place.

The port's counterpart of ``repro.core.keepalive``: the same arithmetic over
the port's ``Simulator``, so that its records equal the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# re-exports: the cluster's keep-alive policies ARE the study objects now
from repro_torch.core.cluster.policies import AdaptiveTTL, FixedTTL  # noqa: F401
from repro_torch.core.function import FunctionSpec
from repro_torch.core.workload import Request


def cold_probability(ttl_s: float, rate_rps: float) -> float:
    """For Poisson arrivals on one container: P(gap > TTL) = exp(-rate*TTL)."""
    return float(np.exp(-rate_rps * ttl_s))


def budget_ttl(rate_rps: float, container_second_budget_per_req: float,
               lo: float = 0.0, hi: float = 3600.0) -> float:
    """Largest TTL with expected idle container-seconds per request
    E[min(gap, TTL)] <= budget.  E[min(gap,TTL)] = (1-exp(-r*TTL))/r."""
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        exp_idle = (1.0 - np.exp(-rate_rps * mid)) / rate_rps
        if exp_idle <= container_second_budget_per_req:
            lo = mid
        else:
            hi = mid
    return lo


@dataclasses.dataclass(frozen=True)
class PrewarmSchedule:
    """Provision `count` containers `lead_s` before `at_s` (known ramp)."""
    at_s: float
    count: int
    lead_s: float = 10.0

    def requests(self) -> list:
        """Synthetic priming requests that warm the pool ahead of time.
        Negative times are fine — the simulator clock is relative."""
        t = self.at_s - self.lead_s
        return [Request(-1000 - i, t + 1e-3 * i, "prewarm")
                for i in range(self.count)]


def run_with_prewarm(spec: FunctionSpec, requests: list,
                     schedule: PrewarmSchedule, **sim_kw):
    from repro_torch.core.simulator import Simulator
    sim = Simulator(spec, **sim_kw)
    merged = sorted(requests + schedule.requests(), key=lambda r: r.arrival_s)
    records = sim.run(merged)
    return [r for r in records if r.tag != "prewarm"], sim
