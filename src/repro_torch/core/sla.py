"""SLA analysis — the paper's headline claim (C1):

"while the inferencing latency can be within an acceptable range, longer
delays due to cold starts can skew the latency distribution and hence risk
violating more stringent SLAs."

``bimodality_report`` quantifies exactly that skew: warm/cold mode means,
the cold fraction, and which percentile each SLA bound survives to.

The port's counterpart of ``repro.core.sla``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLA:
    """Latency-percentile bounds plus an availability floor.

    ``min_availability`` is the fraction of requests that must complete
    successfully (``ok=True`` on their record); the default 0.0 never
    fires, so fault-free SLAs grade exactly as before the reliability
    axis existed.
    """
    name: str
    p50_s: float = float("inf")
    p95_s: float = float("inf")
    p99_s: float = float("inf")
    min_availability: float = 0.0

    def evaluate(self, records) -> dict:
        fold = getattr(records, "fold", None)
        if fold is not None and fold.all_n:
            # folded streaming sink: percentiles from the O(1)-memory
            # sketch over the full (unfiltered) latency stream
            p50, p95, p99 = fold.all_sketch.percentile([50, 95, 99])
            avail = fold.all_ok_n / fold.all_n
            obs = {"p50": p50, "p95": p95, "p99": p99,
                   "availability": avail}
        else:
            if not records:
                lat = np.zeros(1)
                avail = 1.0
            elif hasattr(records, "response_s"):
                lat = records.response_s()  # columnar RecordArray fast path
                ok = records.column("ok").astype(bool)
                avail = float(ok.mean())
            else:
                lat = np.array([r.response_s for r in records])
                avail = sum(r.ok for r in records) / len(records)
            obs = {"p50": float(np.percentile(lat, 50)),
                   "p95": float(np.percentile(lat, 95)),
                   "p99": float(np.percentile(lat, 99)),
                   "availability": avail}
        violations = {
            "p50": obs["p50"] > self.p50_s,
            "p95": obs["p95"] > self.p95_s,
            "p99": obs["p99"] > self.p99_s,
            "availability": obs["availability"] < self.min_availability,
        }
        return {"sla": self.name, "observed": obs,
                "violations": violations,
                "ok": not any(violations.values())}


# a typical interactive-inference SLA used throughout the benchmarks
INTERACTIVE = SLA("interactive", p95_s=1.0, p99_s=2.0)
STRINGENT = SLA("stringent", p95_s=0.5, p99_s=1.0)
# GPU serverless (Modal-style): cold starts are 5-10 s by construction, so
# an interactive bound lives at seconds scale — the SLA grades whether the
# keepalive policy keeps colds off the tail, not sub-second latencies
GPU_INTERACTIVE = SLA("gpu-interactive", p95_s=15.0, p99_s=30.0)


def bimodality_report(records) -> dict:
    fold = getattr(records, "fold", None)
    if fold is not None:
        # folded streaming sink: modes from the running warm/cold
        # aggregates (tag-filtered at fold time), percentiles from the
        # kept-group sketch
        warm_g, cold_g, kept = fold.warm, fold.cold, fold.kept
        warm_mean = warm_g.lat_sum / warm_g.n if warm_g.n else 0.0
        cold_mean = cold_g.lat_sum / cold_g.n if cold_g.n else 0.0
        rep = {
            "n": kept.n,
            "cold_fraction": cold_g.n / max(kept.n, 1),
            "warm_mean_s": warm_mean,
            "cold_mean_s": cold_mean,
            "mode_separation": (cold_mean / max(warm_mean, 1e-9)
                                if warm_g.n and cold_g.n else 0.0),
        }
        if kept.n:
            rep["p50_s"] = kept.sketch.quantile(0.50)
            rep["p99_s"] = kept.sketch.quantile(0.99)
            rep["p99_over_p50"] = rep["p99_s"] / max(rep["p50_s"], 1e-9)
        return rep
    warm = [r.response_s for r in records if not r.cold]
    cold = [r.response_s for r in records if r.cold]
    lat = [r.response_s for r in records]
    rep = {
        "n": len(records),
        "cold_fraction": len(cold) / max(len(records), 1),
        "warm_mean_s": float(np.mean(warm)) if warm else 0.0,
        "cold_mean_s": float(np.mean(cold)) if cold else 0.0,
        "mode_separation": (float(np.mean(cold)) / max(float(np.mean(warm)),
                                                       1e-9)) if cold and warm else 0.0,
    }
    if lat:
        rep["p50_s"] = float(np.percentile(lat, 50))
        rep["p99_s"] = float(np.percentile(lat, 99))
        # the paper's point: p99 >> p50 exactly when colds are present
        rep["p99_over_p50"] = rep["p99_s"] / max(rep["p50_s"], 1e-9)
    return rep
