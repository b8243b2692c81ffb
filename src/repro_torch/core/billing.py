"""Metered billing — paper Table 1, verbatim.

Lambda bills execution in 100 ms ticks at a per-tick price proportional to
the memory tier.  The paper's observation C3: total cost is NOT monotonic in
memory — the per-tick price rises linearly but execution time falls, so the
cheapest tier sits mid-curve, and over-provisioning past the CPU knee only
adds cost.

The port's counterpart of ``repro.core.billing``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import math

# paper Table 1: memory (MB) -> $ per 100 ms
PRICE_PER_100MS = {
    128: 0.000000208,
    256: 0.000000417,
    384: 0.000000625,
    512: 0.000000834,
    640: 0.000001042,
    768: 0.00000125,
    896: 0.000001459,
    1024: 0.000001667,
    1152: 0.000001875,
    1280: 0.000002084,
    1408: 0.000002292,
    1536: 0.000002501,
}

REQUEST_PRICE = 0.0000002  # $ per invocation (Lambda request charge)
TICK_S = 0.1


def price_per_100ms(memory_mb: int) -> float:
    if memory_mb in PRICE_PER_100MS:
        return PRICE_PER_100MS[memory_mb]
    # tiers between the paper's sampled rows: linear in memory (AWS pricing)
    return PRICE_PER_100MS[128] * (memory_mb / 128.0)


def billed_ticks(exec_seconds: float) -> int:
    return max(int(math.ceil(exec_seconds / TICK_S)), 1)


def invocation_cost(exec_seconds: float, memory_mb: int,
                    include_request_charge: bool = False) -> float:
    c = billed_ticks(exec_seconds) * price_per_100ms(memory_mb)
    if include_request_charge:
        c += REQUEST_PRICE
    return c


# --- cold-start mitigation surcharges (beyond the paper's Table 1) ---------
# The mitigation policies trade a little always-on platform spend for the
# cold-start latency they remove; surfacing that spend keeps the scenario
# suite's cost columns honest.  Rates follow the shape of 2017-era AWS
# adjacent services rather than exact SKUs.

SNAPSHOT_GB_MONTH_PRICE = 0.045   # $/GB-month held (EBS-snapshot-like)
SECONDS_PER_MONTH = 30 * 24 * 3600.0
BARE_SANDBOX_MB = 128             # a bootstrapped, model-less sandbox bills
                                  # at the smallest memory tier


def snapshot_storage_cost(size_mb: float, held_s: float) -> float:
    """Storage cost of holding a function snapshot of ``size_mb`` for
    ``held_s`` seconds (SnapshotRestore's amortized price)."""
    return (size_mb / 1024.0) * SNAPSHOT_GB_MONTH_PRICE * \
        (held_s / SECONDS_PER_MONTH)


def sandbox_idle_cost(idle_seconds: float) -> float:
    """Keep-alive cost of one bare (bootstrapped-but-unloaded) sandbox —
    the LayeredPool's standing charge, billed in the usual 100 ms ticks at
    the smallest tier's price."""
    if idle_seconds <= 0:
        return 0.0
    return billed_ticks(idle_seconds) * price_per_100ms(BARE_SANDBOX_MB)


def errored_invocation_cost(elapsed_s: float, memory_mb: int) -> float:
    """Bill of a failed attempt that ran for ``elapsed_s`` before the
    sandbox died or the client timed out — Lambda bills errored invokes
    like successful ones, for the duration they actually ran (the same
    tick arithmetic as ``invocation_cost``; named separately so the
    reliability path's charges are auditable).  Throttled (429) attempts
    and provision failures never start executing and cost nothing."""
    if elapsed_s <= 0.0:
        return 0.0
    return billed_ticks(elapsed_s) * price_per_100ms(memory_mb)


def hedge_waste_cost(loser_elapsed_s: float, memory_mb: int) -> float:
    """Wasted dollars of one hedged request: the losing attempt's full
    bill (both copies run to completion; the provider refunds nothing).
    Identical arithmetic to ``errored_invocation_cost`` — the name keeps
    the suite's wasted-hedge column self-describing."""
    return errored_invocation_cost(loser_elapsed_s, memory_mb)


def transfer_cost(bytes_total: float, usd_per_gb: float) -> float:
    """Data-transfer dollars for moving ``bytes_total`` through a
    provider-mediated comms channel (storage PUT/GET or queue messages) —
    the sharded fan-out path's per-GB surcharge, folded into
    ``mitigation_cost`` alongside the other platform-side spend."""
    if bytes_total <= 0:
        return 0.0
    return bytes_total / 1e9 * usd_per_gb
