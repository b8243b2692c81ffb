"""Memory-proportional resource model (paper §3, claim C2).

"AWS Lambda allocates other resources such as CPU power, network bandwidth
and disk I/O in proportion to the choice of memory" [paper §3 / AWS FAQ].

The paper's warm curves flatten past ~1024 MB (Figs 1-3): a single-threaded
MXNet forward pass stops speeding up once its CPU share saturates one core.
We therefore model the knee at FULL_CPU_MB = 1024 (calibrated to the paper's
observed knee rather than AWS's nominal 1792 MB/vCPU) and saturate there.

The port's counterpart of ``repro.core.resources``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

FULL_CPU_MB = 1024.0     # observed knee in the paper's warm curves
DISK_MBPS_FULL = 80.0    # package read bandwidth at full I/O share
NETWORK_OVERHEAD_S = 0.090  # API-gateway + routing overhead seen by JMeter


def cpu_share(memory_mb: float) -> float:
    """Fraction of one core available to the function (0, 1]."""
    return max(min(memory_mb / FULL_CPU_MB, 1.0), 1e-3)


def io_share(memory_mb: float) -> float:
    return cpu_share(memory_mb)


def exec_time(cpu_seconds: float, memory_mb: float) -> float:
    """Wall time of a CPU-bound section under the tier's CPU share."""
    return cpu_seconds / cpu_share(memory_mb)


def load_time(package_mb: float, memory_mb: float) -> float:
    """Package read + deserialize under the tier's I/O share."""
    return package_mb / (DISK_MBPS_FULL * io_share(memory_mb))
