"""The serverless simulator's unit of deployment, as the calibration and
``launch/serve.py --serverless`` need it: the ``Handler`` profile, the
batch-efficiency curve helpers, and the ``FunctionSpec`` with its memory
tiers.

A copy of ``repro.core.function``'s ``MEMORY_TIERS``,
``normalize_batch_curve``, ``batch_rel_cost``, ``Handler`` and
``FunctionSpec`` (same fields, same arithmetic, same checks), so that the
port imports nothing of the reference.  Of the providers only the
``lambda`` profile is copied (``core/simulator.py``), the one the serve
CLI deploys on; a ``Handler`` built here carries the same numbers as one
the reference builds from the same calibration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

# AWS Lambda memory tiers (paper Table 1): 128..1536 MB in 64 MB steps
MEMORY_TIERS = tuple(range(128, 1537, 64))


# ----------------------------------------------------- batch-efficiency curve
# A curve is ((batch_size, rel_per_request_cost), ...): the measured relative
# cost of one request inside a fused batch of that size, normalized so a
# batch of 1 costs 1.0.  ``repro_torch.core.calibration`` measures these from
# the port's ``ContinuousServer``.

def normalize_batch_curve(points) -> tuple:
    """Sort/dedup measured ``(batch, rel_cost)`` points, anchor rel(1)=1.0,
    and clamp to monotone non-increasing rel cost (a bigger fused batch
    never makes the *per-request* share more expensive — measurement noise
    otherwise produces nonsense curves)."""
    by_b: dict = {}
    for b, rel in points:
        b = int(b)
        if b < 1 or not rel > 0.0:
            raise ValueError(f"batch curve point ({b}, {rel}) invalid: "
                             f"needs batch >= 1 and rel cost > 0")
        by_b[b] = float(rel)
    if not by_b:
        return ()
    anchor = by_b.get(1, 1.0)
    out = []
    lo = 1.0
    for b in sorted(by_b):
        rel = min(by_b[b] / anchor, lo)
        lo = rel
        out.append((b, rel))
    if out[0][0] != 1:
        out.insert(0, (1, 1.0))
    return tuple(out)


def batch_rel_cost(curve, b: int) -> float:
    """Interpolate the per-request relative cost at batch size ``b``.

    Linear between measured points; clamped to the endpoint values outside
    the measured range — so the result always lies within the curve's
    [min rel, max rel] band."""
    if not curve:
        return 1.0
    if b <= curve[0][0]:
        return curve[0][1]
    for (b0, r0), (b1, r1) in zip(curve, curve[1:]):
        if b <= b1:
            frac = (b - b0) / (b1 - b0)
            return r0 + (r1 - r0) * frac
    return curve[-1][1]


@dataclasses.dataclass(frozen=True)
class Handler:
    """Execution profile of a deployed function (the reference's fields).

    base_cpu_seconds: warm prediction (or generate) time, as calibrated.
    bootstrap_cpu_seconds: runtime+framework import cost (the simulator's
        assumed constant: MXNet in the paper, the framework for modern
        handlers).
    package_mb: deployment package size (model weights + deps).
    peak_memory_mb: declared function working set; deploying below this
        tier fails, like Lambda OOM-kills.
    load_cpu_seconds: the measured part of the LOAD phase beyond the package
        read — param init plus warm-up (kernel builds, first launches) for
        modern engines; 0.0 keeps the paper CNNs' I/O-only LOAD.
    batch_curve: measured ``((batch, rel_per_request_cost), ...)`` from the
        ``ContinuousServer``; () keeps the analytic amortization model.
    run: optional callable executing the real model.
    """
    name: str
    base_cpu_seconds: float
    bootstrap_cpu_seconds: float = 1.2
    package_mb: float = 50.0
    peak_memory_mb: float = 128.0
    load_cpu_seconds: float = 0.0
    batch_curve: tuple = ()
    run: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    """A deployed serverless function: handler + declared memory size, on
    the reference's default provider, ``lambda`` (the only one the port
    copies), whose memory tiers and package cap it checks."""
    handler: Handler
    memory_mb: int = 1024

    def __post_init__(self):
        if self.memory_mb not in MEMORY_TIERS:
            raise ValueError(f"memory {self.memory_mb} not a Lambda "
                             f"tier (128..1536 step 64)")
        if self.handler.package_mb > 512.0:
            raise ValueError("deployment package exceeds Lambda's 512 "
                             "MB ephemeral storage (paper §3.5 "
                             "limitation)")
        if self.memory_mb < self.handler.peak_memory_mb:
            raise ValueError(
                f"{self.handler.name}: peak working set "
                f"{self.handler.peak_memory_mb:.0f} MB exceeds declared "
                f"{self.memory_mb} MB (Lambda would OOM-kill)")

    @property
    def name(self) -> str:
        return f"{self.handler.name}@{self.memory_mb}"
