"""Deterministic discrete-event serverless platform simulator (facade).

The event loop lives in ``repro_torch.core.cluster`` as a policy-driven
``ClusterSimulator`` (placement / keep-alive / scaling policies, optional
per-container concurrency, batching-aware fleets, multi-function routing).
``Simulator`` remains the single-function Lambda-2017 view of it:

Scheduling policy (Lambda semantics, the cluster's default stack):
  * one in-flight request per container,
  * a request goes to the most-recently-used idle warm container, else a
    cold start is issued,
  * unlimited scale-out unless ``max_containers`` caps it,
  * idle containers are evicted after ``keepalive_s``.

The port's counterpart of ``repro.core.simulator``: the same defaults (the
jitter of 0.03 among them) and the same seeded numpy stream, so that its
records equal the reference's.
"""
from __future__ import annotations

from repro_torch.core.cluster.cluster import ClusterSimulator
from repro_torch.core.cluster.events import RequestRecord  # noqa: F401  (re-export)
from repro_torch.core.function import FunctionSpec
from repro_torch.core.workload import Request  # noqa: F401  (re-export)

DEFAULT_KEEPALIVE_S = 480.0   # idle TTL; the paper's 10-min gaps force colds


class Simulator(ClusterSimulator):
    """Single-function cluster with the default (Lambda) policy stack."""

    def __init__(self, spec: FunctionSpec, *,
                 keepalive_s: float = DEFAULT_KEEPALIVE_S, seed: int = 0,
                 jitter: float = 0.03, max_containers: int = 0):
        super().__init__(spec, keepalive_s=keepalive_s, seed=seed,
                         jitter=jitter, max_containers=max_containers)
        self.spec = spec
        self.keepalive_s = keepalive_s
