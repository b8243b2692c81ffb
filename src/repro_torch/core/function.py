"""The handler side of the serverless simulator's unit of deployment, as
the calibration needs it: the ``Handler`` profile and the batch-efficiency
curve helpers.

A copy of ``repro.core.function``'s ``normalize_batch_curve``,
``batch_rel_cost`` and ``Handler`` (same fields, same arithmetic), so that
the port imports nothing of the reference.  ``FunctionSpec``, the providers
and the simulator stay in ``repro.core``; a ``Handler`` built here carries
the same numbers as one the reference builds from the same calibration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional


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
