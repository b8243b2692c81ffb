"""Provider profiles: the substrate a ``FunctionSpec`` deploys onto.

The paper's numbers are AWS-Lambda-2017 (memory-proportional CPU/IO shares,
100 ms tick billing, generous always-free idle).  Modern GPU serverless
platforms invert every one of those economics: Modal-style containers get a
full host regardless of a "memory tier", cold starts are seconds long
(image pull + GPU attach), billing is per-second *for the whole container
lifetime* — idle keep-alive costs real dollars — and the platform scales a
container down after a fixed idle window.

A ``ProviderProfile`` captures exactly the knobs the simulator's cost and
cold-start models read, so ``repro_torch.core.container.cold_start_breakdown``,
the per-fleet hot-path caches in ``repro_torch.core.cluster.router.Fleet``, and
the scaling policies' service-time estimates all route through one table.
The ``lambda`` profile reproduces the pre-provider constants bit-for-bit
(same arithmetic on the same floats).

These constants are the simulator's model of a provider, not measurements
of any card.

Anchor numbers for ``modal_gpu`` follow the Modal deployment in the
related-work set (H100 class: ~5-10 s cold start, ~$0.00376 per GPU-second,
``scaledown_window=300``); we model the CPU-visible shape of that regime,
not the exact SKU.

The port's counterpart of ``repro.core.providers``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import billing

# Lambda-2017 provision model (paper figures: cold - warm gap of ~1.5-4 s);
# re-exported by repro_torch.core.container.
LAMBDA_PROVISION_BASE_S = 0.9
LAMBDA_PROVISION_TIER_S = 0.55

# resources.FULL_CPU_MB, duplicated here to avoid an import cycle
# (resources stays the leaf module; tests pin the equality)
_FULL_CPU_MB = 1024.0
_DISK_MBPS_FULL = 80.0


@dataclasses.dataclass(frozen=True)
class ProviderProfile:
    """Cost + cold-start model of one serverless substrate.

    ``full_cpu``: the container gets a whole core (GPU-class hosts) instead
    of Lambda's memory-proportional share.
    ``per_second_usd``: flat $/container-second; 0.0 selects the Lambda
    per-tier tick price table.
    ``bill_idle``: the provider bills the container's whole up-time (cold
    start + exec + idle keep-alive), not just execution — the cluster then
    accounts the idle remainder as platform-side spend.
    ``scaledown_s``: the provider's own idle scale-down window — the
    natural keep-alive TTL a scenario tunes its stacks to.
    ``lambda_limits``: enforce Lambda's memory tiers + 512 MB package cap
    at deploy time.
    ``storage_*`` / ``queue_*``: the two shard-to-shard comms channels a
    gang-scheduled fan-out can route activations through (serverless
    workers have no direct sockets).  Storage is the S3-shaped channel —
    slow per hop, wide, cheap per GB; the queue is SQS-shaped — fast per
    message, thin, expensive per GB.  ``repro_torch.core.distributed`` turns
    these into ``CommsChannel`` objects via :meth:`comms_channel`.
    ``fault_*``: the provider's baseline failure-process rates
    (``repro_torch.core.faults``): per-attempt provision-failure and
    mid-execution crash probabilities, throttle-storm frequency/dwell/429
    rate, and the per-lane crash rate on the sharded gang path.  Nothing
    reads them unless a scenario builds a ``FaultConfig`` from the
    profile, so they change no fair-weather number.
    """
    name: str
    provision_base_s: float = LAMBDA_PROVISION_BASE_S
    provision_tier_s: float = LAMBDA_PROVISION_TIER_S
    full_cpu: bool = False
    disk_mbps: float = _DISK_MBPS_FULL
    per_second_usd: float = 0.0
    bill_idle: bool = False
    scaledown_s: float = 480.0
    lambda_limits: bool = True
    storage_hop_s: float = 0.010
    storage_gbps: float = 1.0
    storage_usd_gb: float = 0.01
    queue_hop_s: float = 0.004
    queue_gbps: float = 0.5
    queue_usd_gb: float = 0.04
    fault_provision_fail: float = 0.002
    fault_exec_crash: float = 0.001
    fault_storms_per_day: float = 2.0
    fault_storm_mean_s: float = 120.0
    fault_storm_throttle_p: float = 0.9
    fault_lane_fault: float = 0.001

    # ----------------------------------------------------- resource model
    def cpu_share(self, memory_mb: float) -> float:
        if self.full_cpu:
            return 1.0
        return max(min(memory_mb / _FULL_CPU_MB, 1.0), 1e-3)

    def exec_time(self, cpu_seconds: float, memory_mb: float) -> float:
        """Wall time of a CPU-bound section on this provider's tier."""
        return cpu_seconds / self.cpu_share(memory_mb)

    def load_time(self, package_mb: float, memory_mb: float) -> float:
        """Package/weight read under the provider's I/O share."""
        return package_mb / (self.disk_mbps * self.cpu_share(memory_mb))

    def provision_s(self, memory_mb: float) -> float:
        """Sandbox/host provisioning wall time (the fixed cold-start part;
        image pull + GPU attach dominates on GPU serverless)."""
        if self.provision_tier_s == 0.0:
            return self.provision_base_s
        share = self.cpu_share(memory_mb)
        return self.provision_base_s + self.provision_tier_s / max(share,
                                                                   0.25)

    # ------------------------------------------------------------ billing
    def price_per_100ms(self, memory_mb: int) -> float:
        if self.per_second_usd:
            return self.per_second_usd * billing.TICK_S
        return billing.price_per_100ms(memory_mb)

    # -------------------------------------------------------------- comms
    def comms_channel(self, kind: str = "storage"):
        """The provider's ``kind`` shard-to-shard channel ("storage" or
        "queue") as a ``repro_torch.core.distributed.CommsChannel``."""
        from repro_torch.core.distributed import CommsChannel
        if kind == "storage":
            return CommsChannel(name=f"{self.name}:storage",
                                hop_s=self.storage_hop_s,
                                gbps=self.storage_gbps,
                                usd_per_gb=self.storage_usd_gb)
        if kind == "queue":
            return CommsChannel(name=f"{self.name}:queue",
                                hop_s=self.queue_hop_s,
                                gbps=self.queue_gbps,
                                usd_per_gb=self.queue_usd_gb)
        raise KeyError(f"unknown comms channel {kind!r}; expected "
                       f"'storage' or 'queue'")


LAMBDA = ProviderProfile(name="lambda")

MODAL_GPU = ProviderProfile(
    name="modal_gpu",
    provision_base_s=6.5,        # mid-range of the observed 5-10 s colds
    provision_tier_s=0.0,        # no memory-proportional part: full host
    full_cpu=True,
    disk_mbps=1000.0,            # NVMe-class weight loads
    per_second_usd=0.00376,      # H100-class $/GPU-second
    bill_idle=True,              # the container bills while kept warm
    scaledown_s=300.0,           # Modal's scaledown_window default
    lambda_limits=False,
    # GPU serverless fails harder: host+accelerator attach multiplies the
    # provision failure surface, and spot-backed capacity preempts running
    # sandboxes far more often than Lambda reclaims firecracker VMs
    fault_provision_fail=0.010,
    fault_exec_crash=0.004,
    fault_storms_per_day=4.0,
    fault_storm_mean_s=180.0,
    fault_lane_fault=0.004,
)

PROVIDERS: dict[str, ProviderProfile] = {p.name: p for p in
                                         (LAMBDA, MODAL_GPU)}


def get(name: str) -> ProviderProfile:
    try:
        return PROVIDERS[name]
    except KeyError:
        raise KeyError(f"unknown provider {name!r}; registered: "
                       f"{sorted(PROVIDERS)}") from None
