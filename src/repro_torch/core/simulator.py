"""The single-function serverless simulation that ``launch/serve.py
--serverless`` runs: a copy of the part of the reference's ``repro.core``
that this run reads, with the same arithmetic on the same floats, so that
its records equal the reference ``Simulator``'s at jitter 0.

- the ``lambda`` provider's resource model: the memory-proportional CPU and
  I/O share, the package read and the provision time
  (``repro/core/providers.py``, ``resources.py``);
- ``cold_start_breakdown`` (``repro/core/container.py:122-140``);
- ``warm_burst`` (``repro/core/workload.py:54-66``);
- the default policy stack's event loop (``repro/core/cluster/cluster.py``,
  ``_run_fast_single``): one request in flight per container; an arrival
  takes the most recently used idle container (of equal completion times,
  the newer container), else starts a cold one; a container idle for the
  keep-alive (480 s) is evicted; every response carries the network
  overhead (0.090 s).  An arrival at the time of a completion or an
  eviction comes first, as in the reference.

The jitter (the reference's lognormal draws from numpy's stream) is not
copied: any jitter other than 0 raises.
"""
from __future__ import annotations

import dataclasses
from heapq import heappop, heappush

from repro_torch.core.function import FunctionSpec

LAMBDA_PROVISION_BASE_S = 0.9
LAMBDA_PROVISION_TIER_S = 0.55
FULL_CPU_MB = 1024.0         # the paper's observed knee of its warm curves
DISK_MBPS_FULL = 80.0        # package read bandwidth at full I/O share
NETWORK_OVERHEAD_S = 0.090   # API-gateway + routing overhead seen by JMeter
KEEPALIVE_S = 480.0          # idle TTL; the paper's 10-min gaps force colds


def cpu_share(memory_mb: float) -> float:
    """Fraction of one core available to the function (0, 1]."""
    return max(min(memory_mb / FULL_CPU_MB, 1.0), 1e-3)


def exec_time(cpu_seconds: float, memory_mb: float) -> float:
    """Wall time of a CPU-bound section under the tier's CPU share."""
    return cpu_seconds / cpu_share(memory_mb)


def load_time(package_mb: float, memory_mb: float) -> float:
    """Package read + deserialize under the tier's I/O share."""
    return package_mb / (DISK_MBPS_FULL * cpu_share(memory_mb))


def provision_s(memory_mb: float) -> float:
    """Sandbox provisioning wall time: a fixed part and a weakly
    tier-dependent one."""
    return LAMBDA_PROVISION_BASE_S + LAMBDA_PROVISION_TIER_S / max(cpu_share(memory_mb), 0.25)


@dataclasses.dataclass
class ColdStartBreakdown:
    provision_s: float
    bootstrap_s: float
    load_s: float

    @property
    def total_s(self) -> float:
        return self.provision_s + self.bootstrap_s + self.load_s


def cold_start_breakdown(spec: FunctionSpec) -> ColdStartBreakdown:
    """PROVISION, BOOTSTRAP (the framework import at the tier's CPU share)
    and LOAD (the package read plus the handler's measured load work)."""
    m, h = spec.memory_mb, spec.handler
    load_s = load_time(h.package_mb, m)
    if h.load_cpu_seconds:
        load_s += exec_time(h.load_cpu_seconds, m)
    return ColdStartBreakdown(provision_s=provision_s(m),
                              bootstrap_s=exec_time(h.bootstrap_cpu_seconds, m), load_s=load_s)


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival_s: float
    tag: str = ""


def warm_burst(n: int = 25) -> list:
    """One priming request, then ``n`` requests 1 s apart from 5 s on (the
    paper's warm measurement)."""
    # 5 s: wait for the priming request to finish
    return [Request(0, 0.0, "prime")] + [Request(1 + i, 5.0 + i * 1.0, "warm")
                                          for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Record:
    """One served request: the reference ``RequestRecord``'s fields that
    this run reads."""
    rid: int
    arrival_s: float
    start_exec_s: float
    end_s: float
    cold: bool
    exec_s: float
    tag: str

    @property
    def response_s(self) -> float:
        return self.end_s - self.arrival_s


_WARM, _BUSY, _EVICTED = "warm", "busy", "evicted"


class Simulator:
    """One function on the ``lambda`` provider under the default stack."""

    def __init__(self, spec: FunctionSpec, *, jitter: float = 0.0):
        if jitter != 0.0:
            raise ValueError(f"jitter {jitter}: the port's simulator runs at jitter 0 only "
                             "(the reference draws its jitter from numpy's stream)")
        self.warm_exec_s = exec_time(spec.handler.base_cpu_seconds, spec.memory_mb)
        self.cold_total_s = cold_start_breakdown(spec).total_s

    def run(self, requests: list) -> list:
        """Serve ``requests`` (in arrival order); -> their records in the
        order they arrived."""
        if any(b.arrival_s < a.arrival_s for a, b in zip(requests, requests[1:])):
            raise ValueError("requests must be in arrival order")
        ttl_eps = KEEPALIVE_S - 1e-9
        heap, idle, records = [], [], []
        state, last_used = {}, {}
        seq = 0
        it = iter(requests)
        req = next(it, None)
        while req is not None or heap:
            if req is not None and (not heap or req.arrival_s <= heap[0][0]):
                t = req.arrival_s
                if idle:
                    # idle is in completion order: the most recent is last;
                    # of equal completion times the higher container id
                    entry = idle[-1]
                    if len(idle) > 1 and idle[-2][0] == entry[0]:
                        entry = max(idle)
                        idle.remove(entry)
                    else:
                        idle.pop()
                    cid, cold, start = entry[1], False, t
                else:
                    cid, cold, start = len(state), True, t + self.cold_total_s
                end = start + self.warm_exec_s + NETWORK_OVERHEAD_S
                state[cid], last_used[cid] = _BUSY, end
                heappush(heap, (end, seq, 1, cid))
                heappush(heap, (end + KEEPALIVE_S, seq + 1, 2, cid))
                seq += 2
                records.append(Record(req.rid, t, start, end, cold, self.warm_exec_s, req.tag))
                req = next(it, None)
                continue
            t, _, kind, cid = heappop(heap)
            if kind == 1:                       # the request completed
                state[cid] = _WARM
                idle.append((t, cid))
            elif state[cid] == _WARM and t - last_used[cid] >= ttl_eps:   # idle past the TTL
                state[cid] = _EVICTED
                idle.remove((last_used[cid], cid))
        return records
