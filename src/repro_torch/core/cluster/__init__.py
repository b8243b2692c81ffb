"""Policy-driven serverless cluster simulator (see DESIGN.md).

Public surface:
  * ClusterSimulator — the event loop (cluster.py)
  * RequestRecord    — the per-request result row (events.py)
  * RecordArray      — the columnar record sink ``run()`` returns
                       (events.py; quacks like list[RequestRecord])
  * BatchingConfig   — batching-aware container mode (router.py)
  * policies         — placement / keep-alive / scaling / cold-start
                       policy classes

The port's counterpart of ``repro.core.cluster``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from repro_torch.core.cluster.cluster import ClusterSimulator
from repro_torch.core.cluster.events import RecordArray, RequestRecord
from repro_torch.core.cluster.policies import (AdaptiveTTL, ColdStartPolicy,
                                               FixedTTL, FullCold, LambdaImplicit,
                                               LayeredPool, LeastLoadedPlacement,
                                               LRUPlacement, MRUPlacement,
                                               PackageCache, PredictiveWarmPool,
                                               SnapshotRestore)
from repro_torch.core.cluster.router import BatchingConfig

__all__ = ["ClusterSimulator", "RequestRecord", "RecordArray",
           "BatchingConfig",
           "AdaptiveTTL", "FixedTTL", "LambdaImplicit",
           "LeastLoadedPlacement", "LRUPlacement", "MRUPlacement",
           "PredictiveWarmPool", "ColdStartPolicy", "FullCold",
           "SnapshotRestore", "LayeredPool", "PackageCache"]
