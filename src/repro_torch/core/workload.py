"""JMeter-style workload generators (paper §3.1 / §3.4, Fig 7) plus the
scenario-harness trace library (bursty / diurnal / flash-crowd / replay).

Each generator returns a list of ``Request`` — deterministic given the seed,
matching the paper's measurement scripts:

  * cold_probe:  5 sequential requests separated by 10 minutes (forces cold).
  * warm_burst:  1 discarded priming request, then 25 requests at 1 s spacing.
  * step_ramp:   10 parallel requests, +10 req/s each second for 10 s (Fig 7).
  * poisson:     open-loop Poisson arrivals (beyond-paper, for SLA studies).

Scenario-harness traces (the reference's ``repro.core.scenarios`` builds its
named scenarios from them):

  * mmpp_bursty:  two-state Markov-modulated Poisson process — exponential
    ON/OFF dwells with a high rate inside bursts and a trickle between them.
  * diurnal:      sinusoid-modulated inhomogeneous Poisson (day/night cycle),
    sampled exactly by Lewis-Shedler thinning.
  * flash_crowd:  steady trickle with one rectangular spike window.
  * trace_replay / save_trace: JSON round-trip of any trace, so measured
    production traces plug into the same harness.
  * multi_function_trace: merged per-function streams — the mixed-fleet
    workload for the multi-function ClusterSimulator.  Per-function entries
    may be plain Poisson rates (the original behaviour) or any generator
    above, so every scenario has a mixed-fleet variant.

``Request.fn`` names the target function for multi-function clusters; the
empty default routes to the cluster's default fleet, so single-function
workloads are unchanged.

The port's counterpart of ``repro.core.workload``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import math
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True, slots=True)
class Request:
    rid: int
    arrival_s: float
    tag: str = ""
    fn: str = ""          # target function ("" -> the cluster default)


def cold_probe(n: int = 5, gap_s: float = 600.0) -> list:
    return [Request(i, i * gap_s, "cold_probe") for i in range(n)]


def warm_burst(n: int = 25, interval_s: float = 1.0,
               prime: bool = True) -> list:
    reqs = []
    rid = 0
    t = 0.0
    if prime:
        reqs.append(Request(rid, 0.0, "prime"))
        rid += 1
        t = 5.0  # wait for the priming request to finish
    for i in range(n):
        reqs.append(Request(rid, t + i * interval_s, "warm"))
        rid += 1
    return reqs


def step_ramp(start_rps: int = 10, step_rps: int = 10,
              duration_s: int = 10) -> list:
    """Paper Fig 7: second t carries (start + t*step) concurrent requests."""
    reqs = []
    rid = 0
    for sec in range(duration_s):
        rate = start_rps + sec * step_rps
        for k in range(rate):
            # requests within the second spread uniformly (JMeter burst)
            reqs.append(Request(rid, sec + k / max(rate, 1), "ramp"))
            rid += 1
    return reqs


# ---------------------------------------------------------------------------
# Vectorized arrival sampling.
#
# The scalar generators below (``_poisson_scalar`` / ``_mmpp_bursty_scalar``)
# draw one exponential per ``rng.exponential(scale)`` call; every such call
# consumes the generator's bit stream exactly like one
# ``rng.standard_exponential()`` draw scaled afterwards, and a numpy array
# fill of size K consumes the stream exactly like K scalar draws.  So a
# buffered block of ``standard_exponential`` values replayed one-per-draw is
# *element-identical* to the scalar loop — including the final discarded
# draw that crosses the window end — which is what lets the vectorized
# generators below keep the seed discipline bit-for-bit.
#
# ``diurnal`` and ``flash_crowd`` stay scalar: Lewis-Shedler thinning
# interleaves one exponential (variable bit-stream consumption) with one
# uniform per candidate, so no block draw can replay that stream without
# changing the emitted values.  Their candidate counts are a few thousand
# per trace — negligible next to the million-arrival Poisson traces.

class _ExpStream:
    """Buffered standard-exponential draws, replayed one per scalar
    ``rng.exponential(scale)`` call the scalar reference would make."""

    __slots__ = ("rng", "buf", "pos")

    def __init__(self, rng):
        self.rng = rng
        self.buf = rng.standard_exponential(256)
        self.pos = 0

    def _refill(self, hint: int) -> None:
        self.buf = self.rng.standard_exponential(max(256, hint))
        self.pos = 0

    def draw(self, scale: float) -> float:
        """One draw — equals ``rng.exponential(scale)`` on the same stream."""
        if self.pos >= len(self.buf):
            self._refill(256)
        v = scale * self.buf[self.pos]
        self.pos += 1
        return float(v)

    def arrivals_until(self, start: float, end: float, scale: float) -> list:
        """All arrival times of ``t += exp(scale)`` starting at ``start``
        that fall strictly before ``end`` (the crossing draw is consumed
        and discarded, exactly like the scalar loop's ``break``)."""
        out: list = []
        t = start
        while True:
            avail = self.buf[self.pos:]
            if avail.size == 0:
                expect = int((end - t) / scale * 1.2) + 64 if scale > 0 \
                    else 256
                self._refill(expect)
                continue
            # cumulative sum seeded with t reproduces the scalar loop's
            # left-to-right float accumulation exactly
            seq = np.empty(avail.size + 1)
            seq[0] = t
            np.multiply(avail, scale, out=seq[1:])
            times = np.cumsum(seq)[1:]
            idx = int(np.searchsorted(times, end, side="left"))
            if idx == times.size:          # window end not reached yet
                out.extend(times.tolist())
                self.pos = len(self.buf)
                t = float(times[-1])
                continue
            out.extend(times[:idx].tolist())
            self.pos += idx + 1            # + the discarded crossing draw
            return out


def _poisson_scalar(rate_rps: float, duration_s: float,
                    seed: int = 0) -> list:
    """Pre-vectorization reference (the spec the fast path is pinned to)."""
    rng = np.random.default_rng(seed)
    t, rid, reqs = 0.0, 0, []
    while True:
        t += rng.exponential(1.0 / rate_rps)
        if t >= duration_s:
            break
        reqs.append(Request(rid, float(t), "poisson"))
        rid += 1
    return reqs


def poisson(rate_rps: float, duration_s: float, seed: int = 0) -> list:
    scale = 1.0 / rate_rps
    rng = np.random.default_rng(seed)
    times = _ExpStream(rng).arrivals_until(0.0, duration_s, scale)
    return [Request(rid, t, "poisson") for rid, t in enumerate(times)]


def mmpp_bursty(*, rate_on_rps: float = 2.0, rate_off_rps: float = 0.02,
                mean_on_s: float = 60.0, mean_off_s: float = 240.0,
                duration_s: float = 3600.0, seed: int = 0,
                start_on: bool = False) -> list:
    """Two-state MMPP: ON/OFF bursts with exponential dwell times.

    The process alternates between an OFF state (rate ``rate_off_rps``, mean
    dwell ``mean_off_s``) and an ON state (rate ``rate_on_rps``, mean dwell
    ``mean_on_s``); within each dwell, arrivals are Poisson at the state's
    rate.  Long-run mean rate is the dwell-weighted average of the two
    rates.  Requests are tagged ``"burst"`` inside ON dwells and ``"idle"``
    between them, so reports can split the regimes.
    """
    if min(rate_on_rps, rate_off_rps) < 0:
        raise ValueError("rates must be non-negative")
    rng = np.random.default_rng(seed)
    es = _ExpStream(rng)
    arrivals: list = []
    t, on = 0.0, start_on
    while t < duration_s:
        dwell = es.draw(mean_on_s if on else mean_off_s)
        end = min(t + dwell, duration_s)
        rate = rate_on_rps if on else rate_off_rps
        if rate > 0:
            tag = "burst" if on else "idle"
            for tt in es.arrivals_until(t, end, 1.0 / rate):
                arrivals.append((tt, tag))
        t, on = end, not on
    return [Request(rid, t, tag) for rid, (t, tag) in enumerate(arrivals)]


def _mmpp_bursty_scalar(*, rate_on_rps: float = 2.0,
                        rate_off_rps: float = 0.02, mean_on_s: float = 60.0,
                        mean_off_s: float = 240.0, duration_s: float = 3600.0,
                        seed: int = 0, start_on: bool = False) -> list:
    """Pre-vectorization reference for ``mmpp_bursty`` (kept as the spec
    the buffered-stream implementation is pinned against)."""
    if min(rate_on_rps, rate_off_rps) < 0:
        raise ValueError("rates must be non-negative")
    rng = np.random.default_rng(seed)
    arrivals: list = []
    t, on = 0.0, start_on
    while t < duration_s:
        dwell = rng.exponential(mean_on_s if on else mean_off_s)
        end = min(t + dwell, duration_s)
        rate = rate_on_rps if on else rate_off_rps
        if rate > 0:
            tt = t
            while True:
                tt += rng.exponential(1.0 / rate)
                if tt >= end:
                    break
                arrivals.append((float(tt), "burst" if on else "idle"))
        t, on = end, not on
    return [Request(rid, t, tag) for rid, (t, tag) in enumerate(arrivals)]


def diurnal(*, base_rps: float = 0.5, amplitude: float = 0.8,
            period_s: float = 3600.0, duration_s: float = 7200.0,
            phase: float = -math.pi / 2, seed: int = 0) -> list:
    """Sinusoid-modulated Poisson (day/night cycle), sampled by thinning.

    Instantaneous rate ``base_rps * (1 + amplitude*sin(2*pi*t/period_s +
    phase))``; the default phase starts the trace at the trough ("dawn"), so
    predictive scaling sees a full rising edge.  Time-averaged rate over
    whole periods is ``base_rps``.  Exact Lewis-Shedler thinning: candidates
    from a homogeneous process at the peak rate, accepted with probability
    rate(t)/peak.
    """
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    rate_max = base_rps * (1.0 + amplitude)
    if rate_max <= 0:
        return []
    # stays scalar: thinning interleaves one exponential with one uniform
    # per candidate, and the exponential's variable bit-stream consumption
    # makes a block draw change the emitted values (see _ExpStream notes);
    # candidate counts here are small, so only bind the hot methods
    rng = np.random.default_rng(seed)
    exp, uni, sin = rng.exponential, rng.uniform, math.sin
    scale, two_pi = 1.0 / rate_max, 2.0 * math.pi
    t, arrivals = 0.0, []
    while True:
        t += exp(scale)
        if t >= duration_s:
            break
        rate = base_rps * (1.0 + amplitude
                           * sin(two_pi * t / period_s + phase))
        if uni() * rate_max < rate:
            arrivals.append(float(t))
    return [Request(rid, t, "diurnal") for rid, t in enumerate(arrivals)]


def flash_crowd(*, base_rps: float = 0.05, spike_rps: float = 5.0,
                spike_at_s: float = 600.0, spike_len_s: float = 60.0,
                duration_s: float = 1800.0, seed: int = 0) -> list:
    """Steady trickle with one rectangular flash-crowd window.

    Rate is ``base_rps`` everywhere except ``[spike_at_s, spike_at_s +
    spike_len_s)`` where it jumps to ``spike_rps`` (piecewise-constant
    thinning).  Spike requests are tagged ``"spike"``, the rest ``"base"``.
    """
    rate_max = max(base_rps, spike_rps)
    if rate_max <= 0:
        return []
    # scalar for the same reason as ``diurnal`` (exact thinning stream)
    rng = np.random.default_rng(seed)
    exp, uni = rng.exponential, rng.uniform
    scale, spike_end = 1.0 / rate_max, spike_at_s + spike_len_s
    t, arrivals = 0.0, []
    while True:
        t += exp(scale)
        if t >= duration_s:
            break
        in_spike = spike_at_s <= t < spike_end
        rate = spike_rps if in_spike else base_rps
        if uni() * rate_max < rate:
            arrivals.append((float(t), "spike" if in_spike else "base"))
    return [Request(rid, t, tag) for rid, (t, tag) in enumerate(arrivals)]


# ---------------------------------------------------------------------------
# Production-scale multi-tenant workload (Azure-Functions-style).

def _thinned_fn_stream(rng, rate_mean: float, amp: float, phase: float,
                       period_s: float, duration_s: float,
                       block: int = 2048) -> Iterator[float]:
    """Arrival times of one function's inhomogeneous Poisson stream, yielded
    in ascending order, generated block-at-a-time (Lewis-Shedler thinning
    against the function's peak rate, vectorized per block).  Memory is one
    block regardless of the function's daily volume."""
    peak = rate_mean * (1.0 + amp)
    if peak <= 0.0:
        return
    scale = 1.0 / peak
    two_pi = 2.0 * math.pi
    t = 0.0
    while t < duration_s:
        gaps = rng.standard_exponential(block)
        times = t + np.cumsum(gaps * scale)
        t = float(times[-1])
        keep = times < duration_s
        if amp > 0.0:
            u = rng.random(block)
            rate = rate_mean * (1.0 + amp * np.sin(two_pi * times / period_s
                                                   + phase))
            keep &= u * peak < rate
        yield from times[keep].tolist()


def azure_multitenant_stream(*, n_functions: int = 200,
                             total_rps: float = 1.0, alpha: float = 1.2,
                             duration_s: float = 86400.0,
                             interactive_fraction: float = 0.85,
                             diurnal_amplitude: float = 0.6,
                             period_s: float = 86400.0, seed: int = 0,
                             fn_prefix: str = "fn",
                             fn_names=None) -> Iterator[Request]:
    """Azure-Functions-style multi-tenant day of traffic, streamed.

    Models the regimes production traces report (heavy-tailed function
    popularity, per-function daily cycles, a mix of invocation classes)
    without materializing the trace:

      * **Zipf popularity**: function ``i`` (0-based) carries mean rate
        ``total_rps * (i+1)^-alpha / Z`` — a few functions dominate, a
        long tail barely ever fires (each tail function is a standing
        cold-start generator, which is what makes the regime hard).
      * **Per-function diurnal phase**: interactive functions follow a
        sinusoidal day (amplitude ``diurnal_amplitude``) whose phase
        offset is drawn per function — tenants peak at different hours,
        so cluster load stays staggered rather than globally synchronous.
      * **Invocation classes**: each function is interactive (HTTP-style,
        diurnal) with probability ``interactive_fraction``, else batch
        (timer/queue-style, flat rate around the clock).  Requests are
        tagged with the class.

    Yields ``Request``s in global arrival order (lazy per-function block
    generators merged by ``heapq.merge``), with ``fn`` set to
    ``f"{fn_prefix}{i:04d}"`` — or taken from ``fn_names`` (which also
    fixes ``n_functions``) when a deployed fleet supplies its spec names.
    Peak memory is O(n_functions * block), no matter how many requests
    the day holds.  Deterministic in ``seed``: every function draws from
    its own ``SeedSequence([seed, i])`` child stream, so the trace is
    reproducible, insensitive to consumption order, and independent of
    the names chosen.
    """
    if fn_names is not None:
        fn_names = list(fn_names)
        n_functions = len(fn_names)
    if n_functions < 1:
        raise ValueError("n_functions must be >= 1")
    if not 0.0 <= diurnal_amplitude <= 1.0:
        raise ValueError("diurnal_amplitude must be in [0, 1]")
    weights = np.arange(1, n_functions + 1, dtype=np.float64) ** -alpha
    weights /= weights.sum()
    two_pi = 2.0 * math.pi

    def fn_stream(i: int) -> Iterator[tuple]:
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        # per-function identity draws first, then the arrival stream —
        # one child stream per function keeps the whole trace reproducible
        phase = float(rng.uniform(0.0, two_pi))
        interactive = bool(rng.random() < interactive_fraction)
        amp = diurnal_amplitude if interactive else 0.0
        tag = "interactive" if interactive else "batch"
        name = fn_names[i] if fn_names is not None else f"{fn_prefix}{i:04d}"
        for t in _thinned_fn_stream(rng, total_rps * float(weights[i]), amp,
                                    phase, period_s, duration_s):
            yield (t, i, tag, name)

    streams = [fn_stream(i) for i in range(n_functions)]
    for rid, (t, _i, tag, name) in enumerate(heapq.merge(*streams)):
        yield Request(rid, t, tag, name)


def azure_multitenant(**kwargs) -> list:
    """Materialized ``azure_multitenant_stream`` (for small scales)."""
    return list(azure_multitenant_stream(**kwargs))


TRACE_SCHEMA_VERSION = 1


def trace_to_dict(requests: list) -> dict:
    """Serializable form of a trace (see ``trace_replay`` for the inverse)."""
    return {"version": TRACE_SCHEMA_VERSION,
            "requests": [{"rid": r.rid, "arrival_s": r.arrival_s,
                          "tag": r.tag, "fn": r.fn} for r in requests]}


def save_trace(requests: list, path: str) -> None:
    """Write a trace as JSON; ``trace_replay(path)`` round-trips it exactly
    (JSON preserves IEEE-754 doubles)."""
    with open(path, "w") as f:
        json.dump(trace_to_dict(requests), f, indent=1)


def save_trace_jsonl(requests, path: str) -> None:
    """Write a trace as JSONL — a header line, then one request per line —
    consuming ``requests`` lazily, so a generator (e.g.
    ``azure_multitenant_stream``) streams straight to disk without the
    one-giant-JSON-list memory spike of ``save_trace``.
    ``trace_replay(path)`` (eager) and ``iter_trace_jsonl(path)`` (lazy)
    both read it back; round-trip is exact (IEEE-754 doubles survive
    JSON)."""
    dumps = json.dumps
    with open(path, "w") as f:
        f.write(dumps({"version": TRACE_SCHEMA_VERSION,
                       "format": "jsonl"}) + "\n")
        for r in requests:
            f.write(dumps({"rid": r.rid, "arrival_s": r.arrival_s,
                           "tag": r.tag, "fn": r.fn},
                          separators=(",", ":")) + "\n")


def iter_trace_jsonl(path: str) -> Iterator[Request]:
    """Lazily yield requests from a ``save_trace_jsonl`` file in file
    order (generators write in arrival order, so the stream feeds
    ``ClusterSimulator.run`` directly without materializing the trace)."""
    with open(path) as f:
        header = json.loads(f.readline())
        version = header.get("version")
        if version != TRACE_SCHEMA_VERSION:
            raise ValueError(f"unsupported trace version {version!r} "
                             f"(expected {TRACE_SCHEMA_VERSION})")
        for line in f:
            r = json.loads(line)
            yield Request(rid=int(r["rid"]), arrival_s=float(r["arrival_s"]),
                          tag=r.get("tag", ""), fn=r.get("fn", ""))


def trace_replay(source) -> list:
    """Load a trace from ``save_trace`` or ``save_trace_jsonl`` output: a
    path (``.jsonl`` selects the line-oriented reader), a file-like
    object, or an already-parsed dict.  Requests come back sorted by
    arrival time with their recorded rid/tag/fn intact."""
    if isinstance(source, str) and source.endswith(".jsonl"):
        reqs = list(iter_trace_jsonl(source))
        reqs.sort(key=lambda r: (r.arrival_s, r.rid))
        return reqs
    if isinstance(source, str):
        with open(source) as f:
            payload = json.load(f)
    elif hasattr(source, "read"):
        payload = json.load(source)
    else:
        payload = source
    version = payload.get("version")
    if version != TRACE_SCHEMA_VERSION:
        raise ValueError(f"unsupported trace version {version!r} "
                         f"(expected {TRACE_SCHEMA_VERSION})")
    reqs = [Request(rid=int(r["rid"]), arrival_s=float(r["arrival_s"]),
                    tag=r.get("tag", ""), fn=r.get("fn", ""))
            for r in payload["requests"]]
    reqs.sort(key=lambda r: (r.arrival_s, r.rid))
    return reqs


def multi_function_trace(rates_rps: dict, duration_s: float,
                         seed: int = 0) -> list:
    """Mixed fleet trace: one independent arrival stream per function.

    ``rates_rps`` maps function name -> one of:

      * a number: Poisson arrivals at that rate (the original behaviour,
        bit-compatible with earlier releases);
      * a callable ``f(seed) -> list[Request]``: any generator above,
        invoked with a per-function child seed (e.g.
        ``lambda s: mmpp_bursty(duration_s=600, seed=s)``);
      * a pre-built list of ``Request`` (e.g. from ``trace_replay``).

    Streams are merged and re-numbered in arrival order; each request
    carries ``fn`` so the cluster router can fan them out over a shared
    container pool.  Requests from callables/lists keep their own tag when
    set (``"burst"``, ``"spike"``, ...), else the function name.
    """
    merged = []
    for i, (fn, spec) in enumerate(sorted(rates_rps.items())):
        if callable(spec) or isinstance(spec, (list, tuple)):
            child = int(np.random.SeedSequence([seed, i]).generate_state(1)[0])
            reqs = spec(child) if callable(spec) else spec
            for r in reqs:
                if r.arrival_s < duration_s:
                    merged.append((r.arrival_s, fn, r.tag or fn))
            continue
        rate = spec
        if rate < 0:
            raise ValueError(f"negative rate for {fn!r}: {rate}")
        if rate == 0:
            continue          # disabled function in a sweep
        rng = np.random.default_rng(np.random.SeedSequence([seed, i]))
        # vectorized Poisson stream, element-identical to the scalar
        # ``t += rng.exponential(1/rate)`` loop (see _ExpStream)
        for t in _ExpStream(rng).arrivals_until(0.0, duration_s, 1.0 / rate):
            merged.append((t, fn, fn))
    merged.sort()
    return [Request(rid, t, tag=tag, fn=fn)
            for rid, (t, fn, tag) in enumerate(merged)]
