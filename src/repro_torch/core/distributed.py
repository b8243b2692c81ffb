"""Distributed serverless inference: shard plans, gang math, comms costs.

FSD-Inference-style serving (arXiv:2403.15195) fans one logical inference
out across N serverless shard-workers.  That buys memory headroom (each
worker holds 1/N of the weights) and warm-path speedup (tensor-parallel
compute), but multiplies the cold tail — the request is cold if *any*
shard is cold — and moves every decode step's activations through a
provider-mediated channel (object storage or a queue service; serverless
workers cannot open sockets to each other).

This module is the analytic core the cluster's gang-scheduling path
(``repro_torch.core.cluster``) consumes, the counterpart of
``repro.core.distributed`` (same arithmetic on the same floats):

  * ``ShardPlan`` — fan-out degree, per-shard memory/load fractions
    derived from the registry ``ModelConfig`` + the Megatron partition
    rules (``repro_torch.launch.sharding``), and the bytes each shard
    moves per decode step: two activation all-reduces per transformer
    layer (attention output + MLP down projection), one for the
    vocab-sharded embedding lookup, and a logits all-gather — counted in
    per-link ring bytes.
  * ``gang_cold_probability`` — the tail-multiplication law
    ``1 - (1 - p)^N`` under independent shard placement.
  * ``CommsChannel`` — per-hop latency + bandwidth + per-GB transfer
    pricing for the storage- and queue-mediated channels a
    ``ProviderProfile`` exposes; the cluster bills the transfer dollars
    through ``repro_torch.core.billing.transfer_cost`` into
    ``mitigation_cost``.

Registry imports are deferred into ``plan_shards``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


def gang_cold_probability(p: float, n: int) -> float:
    """Probability a gang-of-``n`` request is cold when each shard is
    independently cold with probability ``p`` — the request joins on the
    slowest shard, so one cold shard colds the gang: ``1 - (1 - p)^n``."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be a probability, got {p!r}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n!r}")
    return 1.0 - (1.0 - p) ** n


# ------------------------------------------------------------ comms channels
@dataclasses.dataclass(frozen=True)
class CommsChannel:
    """One provider-mediated shard-to-shard channel.

    Serverless workers exchange activations through the provider's
    storage (S3-style: high bandwidth, ~10 ms per hop, cheap per GB) or
    queue service (SQS-style: low latency per message, thin bandwidth,
    expensive per GB) — the two FSD-Inference channel families.  A
    decode step costs two hops (write by every producer, read by every
    consumer, overlapped across shards) plus the serialized transfer of
    the step's activation bytes.
    """

    name: str
    hop_s: float          # one-way publish/fetch latency per step
    gbps: float           # effective per-shard channel bandwidth
    usd_per_gb: float     # transfer (PUT/GET or message) pricing

    def step_s(self, step_bytes: float) -> float:
        """Wall time one decode step spends in the channel: two hops
        (produce + consume) plus the transfer of ``step_bytes``."""
        if step_bytes <= 0.0:
            return 0.0
        return 2.0 * self.hop_s + step_bytes / (self.gbps * 1e9)

    def request_s(self, step_bytes: float, steps: int) -> float:
        """Channel wall time of one request = ``steps`` decode steps."""
        return steps * self.step_s(step_bytes)


def comms_cost(total_bytes: float, channel: CommsChannel) -> float:
    """Transfer dollars for ``total_bytes`` through ``channel`` (the
    cluster folds this into ``mitigation_cost`` via ``billing``)."""
    from repro_torch.core import billing
    return billing.transfer_cost(total_bytes, channel.usd_per_gb)


# --------------------------------------------------------------- shard plans
@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """How one model fans out across ``fanout`` serverless shard-workers.

    ``memory_fraction`` / ``load_fraction`` are each shard's share of the
    full model's working set / package+init work: the Megatron partition
    rules shard every matmul weight 1/N while norms (and the per-layer
    biases' replicated slivers) stay whole, so the fraction sits just
    above 1/N.  ``bytes_per_step`` is the per-shard link bytes one decode
    step moves (batch 1; scale linearly in batch);
    ``collectives`` breaks it down as ``(kind, count, bytes)`` rows.
    """

    arch_id: str
    fanout: int
    memory_fraction: float
    load_fraction: float
    bytes_per_step: float                     # per shard, batch 1
    bytes_prefill: float                      # per shard, one prefill pass
    collectives: Tuple[Tuple[str, int, float], ...] = ()

    def step_bytes(self, batch: int = 1) -> float:
        """Per-shard link bytes of one decode step at ``batch`` — every
        collective here moves activations, so bytes scale linearly."""
        return self.bytes_per_step * max(int(batch), 1)

    def total_step_bytes(self, batch: int = 1) -> float:
        """Bytes the whole gang moves through the channel per decode
        step (each of the ``fanout`` shards drives its own link)."""
        return self.step_bytes(batch) * self.fanout


def plan_shards(arch_id: str, fanout: int, *, batch: int = 1,
                seq_len: int = 2048, dtype_bytes: int = 4) -> ShardPlan:
    """Analytic shard plan for a registry arch at ``fanout``-way tensor
    parallelism, mirroring the decode-step collectives of the Megatron
    rules (``repro_torch.launch.sharding``):

      * per transformer layer, two all-reduces of the ``(b, 1, d_model)``
        activation (row-sharded attention output and MLP down
        projections) — per-link ring bytes ``2 * act * (N-1)/N`` each;
      * one all-reduce for the vocab-sharded embedding lookup;
      * one all-gather of the vocab-sharded logits,
        ``b * vocab * (N-1)/N``.

    ``dtype_bytes`` defaults to 4: the reductions run on the float32
    matmul accumulators, not the bf16 activations, so the collectives
    move 4-byte elements.  ``bytes_prefill`` reuses the same
    shape with the activation scaled by ``seq_len``.  Raises ``KeyError``
    for an unknown arch id — callers with non-registry payloads use
    ``plan_for_spec``'s generic fallback.
    """
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout!r}")
    from repro_torch.configs import registry
    cfg = registry.get(arch_id).config
    n = int(fanout)
    if n == 1:
        return ShardPlan(arch_id=arch_id, fanout=1, memory_fraction=1.0,
                         load_fraction=1.0, bytes_per_step=0.0,
                         bytes_prefill=0.0)
    b = max(int(batch), 1)
    ring = (n - 1) / n
    layers = max(cfg.num_layers, 1)
    # replicated parameters: the per-layer norms + final norm (everything
    # matmul-shaped shards 1/N under the COL/ROW rules)
    params = max(cfg.param_count(), 1)
    replicated = (2 * layers + 1) * cfg.d_model
    rep_frac = min(replicated / params, 1.0)
    frac = (1.0 - rep_frac) / n + rep_frac

    act = b * cfg.d_model * dtype_bytes             # (b, 1, d_model)
    ar = 2.0 * act * ring                           # one all-reduce's bytes
    ar_count = 2 * layers + 1                       # 2/layer + embedding
    logits_ag = b * cfg.vocab_size * dtype_bytes * ring
    step = ar_count * ar + logits_ag
    prefill = ar_count * ar * seq_len + logits_ag
    return ShardPlan(
        arch_id=arch_id, fanout=n, memory_fraction=frac, load_fraction=frac,
        bytes_per_step=step / b, bytes_prefill=prefill / b,
        collectives=(("all-reduce", ar_count, ar_count * ar / b),
                     ("all-gather", 1, logits_ag / b)))


def plan_for_spec(spec, fanout: int) -> ShardPlan:
    """Shard plan for a deployed ``FunctionSpec``: registry-backed when
    the handler serves a registry arch, else a generic 1/N plan with no
    modelled comms traffic (paper CNNs: the gang semantics — join on the
    slowest, cold if any shard is cold — still apply)."""
    try:
        return plan_shards(spec.handler.name, fanout)
    except KeyError:
        n = max(int(fanout), 1)
        return ShardPlan(arch_id=spec.handler.name, fanout=n,
                         memory_fraction=1.0 / n, load_fraction=1.0 / n,
                         bytes_per_step=0.0, bytes_prefill=0.0)


def gang_join_estimate(spec, plan: ShardPlan, channel: CommsChannel, *,
                       steps: int = 8, batch: int = 1) -> float:
    """Deterministic warm join-latency estimate of one gang request:
    the slowest lane's warm exec (all lanes share one service-time
    estimate, so the max is the estimate itself) plus the channel wall
    time of ``steps`` decode steps.  The exec part routes through
    ``repro_torch.core.cluster.policies.warm_exec_estimate``, so a
    measured calibration entry for the model (when this host has one)
    beats the analytic constant."""
    from repro_torch.core.cluster.policies import warm_exec_estimate
    exec_s = warm_exec_estimate(lane_spec(spec, plan))
    return exec_s + channel.request_s(plan.step_bytes(batch), steps)


def lane_spec(spec, plan: ShardPlan):
    """The per-shard ``FunctionSpec`` one gang lane runs: the package /
    model-load work shrinks by the plan's load fraction, warm compute
    speeds up ~N-way (tensor parallelism), and the sandbox itself —
    memory tier, provider, PROVISION/BOOTSTRAP — stays full-size, which
    is exactly why the cold tail multiplies instead of shrinking."""
    import dataclasses as _dc
    from repro_torch.core.function import FunctionSpec
    h = spec.handler
    lane_handler = _dc.replace(
        h,
        name=f"{h.name}#shard{plan.fanout}",
        base_cpu_seconds=h.base_cpu_seconds / plan.fanout,
        package_mb=h.package_mb * plan.load_fraction,
        load_cpu_seconds=h.load_cpu_seconds * plan.load_fraction,
        peak_memory_mb=h.peak_memory_mb * plan.memory_fraction,
    )
    return FunctionSpec(handler=lane_handler, memory_mb=spec.memory_mb,
                        provider=spec.provider)
