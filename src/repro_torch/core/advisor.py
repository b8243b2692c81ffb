"""Memory-size advisor (paper §3.5): "There is a need for tools that analyze
previous function executions and suggest changes in declared resources."

Given a handler, a representative workload, and an SLA, sweep the memory
tiers in simulation and recommend the cheapest tier that (a) fits the
function's working set and (b) meets the SLA.  This is the paper's proposed
tool, built on the reproduction's own platform model.

The port's counterpart of ``repro.core.advisor``: the same sweep over the
port's ``Simulator``, ``metrics`` and ``MEMORY_TIERS``, so that its reports
equal the reference's on an equal handler; on the card the handler is built
from the card's own calibration.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import metrics
from repro_torch.core.function import MEMORY_TIERS, FunctionSpec, Handler
from repro_torch.core.simulator import Simulator
from repro_torch.core.sla import SLA


@dataclasses.dataclass
class TierReport:
    memory_mb: int
    feasible: bool
    sla_ok: bool
    mean_response_s: float
    p99_s: float
    total_cost: float


def sweep(handler: Handler, workload: list, sla: SLA, *,
          tiers=None, seed: int = 0, keepalive_s: float = 480.0) -> list:
    reports = []
    for m in (tiers or MEMORY_TIERS):
        if m < handler.peak_memory_mb:
            reports.append(TierReport(m, False, False, 0.0, 0.0, 0.0))
            continue
        spec = FunctionSpec(handler=handler, memory_mb=m)
        sim = Simulator(spec, seed=seed, keepalive_s=keepalive_s)
        records = sim.run(list(workload))
        s = metrics.summarize(records)
        ok = sla.evaluate(records)["ok"]
        reports.append(TierReport(m, True, ok, s.mean_response_s, s.p99_s,
                                  s.total_cost))
    return reports


def recommend(handler: Handler, workload: list, sla: SLA, **kw):
    """Cheapest feasible tier meeting the SLA; falls back to the lowest-p99
    tier when no tier meets it (and says so)."""
    reports = sweep(handler, workload, sla, **kw)
    ok = [r for r in reports if r.feasible and r.sla_ok]
    if ok:
        best = min(ok, key=lambda r: r.total_cost)
        return best, reports, True
    feas = [r for r in reports if r.feasible]
    best = min(feas, key=lambda r: r.p99_s) if feas else None
    return best, reports, False
