"""Sim-to-real replay: run a suite-winning stack against the REAL engine.

The calibration loop's closing move (DESIGN.md §9): measure the serving
engine (``repro_torch.core.calibration``), feed the simulator per-model
phase costs, and then *replay* the winning ``PolicyStack`` on a time-scaled
scenario trace against the actual ``repro_torch.serving.continuous``
``ContinuousServer`` — reporting the simulator's error per metric.

The replay driver is a virtual-time harness over real inference:

  * arrivals come from the scenario's own (scaled) trace; inter-arrival
    gaps advance a virtual clock (nobody sleeps through a 400 s gap),
  * a warm hit runs a REAL ``ContinuousServer`` submit/run and charges its
    measured wall time,
  * a cold start REALLY constructs the server (param init) and serves the
    first request through it (on the card the first serve captures the
    admission and decode CUDA graphs, the counterpart of a jit compile),
    charging the measured wall plus the provider profile's virtual
    PROVISION and BOOTSTRAP phases — the two phases that only exist
    platform-side and are documented as virtual constants in the report,
  * keep-alive policy (fixed / adaptive TTL) evicts by virtual idle time,
    mirroring the cluster's arrival-time semantics (gap observed first,
    then stale idles evicted under the current TTL, MRU placement),
  * billing mirrors the cluster: per-100ms exec ticks at the provider
    rate, plus the bill-idle capacity surcharge (container up-time beyond
    the billed ticks) on GPU-serverless profiles.

Only the stack shape the real driver can faithfully execute is accepted:
single-function fleet, concurrency 1, no batching, no scaling, no
cold-start mitigation (everything the suite's ``gpu_serverless`` and
``sparse`` winners use).  Anything else raises rather than silently
diverging from the sim.

The port's counterpart of the reference's ``benchmarks/replay_real.py``:
the same checks, loop, billing, percentile rule, tolerances and report
keys.  It differs in three ways, each because the port measures on its own
engine and at full width on the card:

  * the simulator side deploys from a calibration cache, given as a loaded
    v2 dict (``calibrated=``) or loaded from ``path`` (measuring the
    scenario's model into it when absent, as the reference's platform
    measures on deploy), through ``ServerlessPlatform(calibrated=...)``;
  * the real side serves the config that cache was measured at (its
    fingerprint's ``configs``: ``full`` on the card, ``smoke`` on the CPU),
    on ``device``, so that both sides describe the same model;
  * an evicted container lets go of its server (weights, caches, captured
    graphs) and keeps only its bookkeeping for the billing pass: at full
    width each server holds the whole model, and a baseline replay makes
    dozens of colds.

Run (writes ``artifacts/replay_report_torch.json``):

    python -m repro_torch.core.replay_real --scenario gpu_serverless \
        --scale 0.05 [--path FILE] [--device cpu --smoke]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch import resolve_device, synchronize
from repro_torch.core import calibration, scenarios
from repro_torch.core.billing import billed_ticks
from repro_torch.core.platform import ServerlessPlatform
from repro_torch.core.providers import get as get_provider
from repro_torch.core.resources import NETWORK_OVERHEAD_S
from repro_torch.core.scenarios import POLICY_STACKS
from repro_torch.core.stack import run_stack

SCHEMA_VERSION = 1

# the reference's loose, documented tolerances: the sim's phase costs come
# from a prior calibration pass, the replay re-measures live — scheduler
# noise, capture state, and small-n percentiles all land inside these
TOLERANCES = {"cold_rate": {"abs": 0.25},
              "p50_s": {"rel": 1.5},
              "p95_s": {"rel": 1.5},
              "cost_per_1k": {"rel": 1.5}}


def _check_replayable(scenario, stack) -> None:
    if len(scenario.functions) != 1:
        raise ValueError(f"{scenario.name}: replay drives a single-function "
                         f"fleet, got {len(scenario.functions)}")
    model = scenario.functions[0].model
    if model in calibration.PAPER_MODELS:
        raise ValueError(f"{scenario.name}: replay serves registry models "
                         f"through ContinuousServer; {model!r} is a paper "
                         f"CNN")
    bad = []
    if stack.scaling.kind != "lambda":
        bad.append(f"scaling={stack.scaling.kind}")
    if stack.coldstart.kind != "full":
        bad.append(f"coldstart={stack.coldstart.kind}")
    if stack.concurrency != 1:
        bad.append(f"concurrency={stack.concurrency}")
    if stack.batching is not None:
        bad.append("batching")
    if stack.placement != "mru":
        bad.append(f"placement={stack.placement}")
    if bad:
        raise ValueError(
            f"replay driver cannot faithfully execute {', '.join(bad)}; "
            f"it supports MRU placement + fixed/adaptive keep-alive at "
            f"concurrency 1 with full colds only")


class _RealContainer:
    """One live ContinuousServer standing in for a warm container; once
    evicted, only its bookkeeping (``release``)."""

    def __init__(self, cfg, *, slots, max_seq, seed, device):
        from repro_torch.serving.continuous import ContinuousServer
        dev = resolve_device(device)
        synchronize(dev)
        t0 = time.perf_counter()
        self.server = ContinuousServer(cfg, slots=slots, max_seq=max_seq,
                                       seed=seed, device=dev)
        synchronize(dev)
        self.init_wall_s = time.perf_counter() - t0
        self.created_at = 0.0       # virtual; set by the driver
        self.last_used_at = 0.0
        self.billed_cost = 0.0

    def serve(self, rid: int, prompt: list, n_new: int) -> float:
        """Seconds from submit until the request's tokens are on the host
        (``run`` copies each decode chunk's tokens back)."""
        from repro_torch.serving.continuous import Request as SReq
        t0 = time.perf_counter()
        self.server.submit(SReq(rid=rid, prompt=prompt, n_new=n_new))
        done = self.server.run()
        wall = time.perf_counter() - t0
        if not done or done[-1].rid != rid:
            raise RuntimeError(f"request {rid} did not complete: {done}")
        return wall

    def release(self) -> None:
        """Drop the server (weights, caches, captured graphs); the virtual
        times and the billed cost stay for the billing pass."""
        self.server = None


def replay(scenario_name: str, *, stack_name: str | None = None,
           scale: float = 0.05, prompt_len: int = 8, n_new: int = 8,
           calibrated: dict | None = None, path: str | None = None,
           device="cuda", smoke: bool = False) -> dict:
    """Simulate -> replay one scenario; returns the report.

    ``calibrated`` (a loaded v2 cache) or the cache at ``path`` (default
    ``artifacts/calibration_torch.json``, for ``device`` and ``smoke``)
    feeds the simulator; the real side serves the configs that cache was
    measured at, on ``device``."""
    sc = scenarios.get(scenario_name)
    stack_name = stack_name or sc.expected_winner
    stack = sc.tune(POLICY_STACKS[stack_name])
    _check_replayable(sc, stack)

    fleet_fn = sc.functions[0]
    cache = calibrated
    if cache is None:       # load it, measuring the model when absent
        cache = calibration.ensure_measured(None, fleet_fn.model, path,
                                            smoke=smoke, device=device)
    configs = cache["host"].get("configs")
    if configs not in ("full", "smoke"):
        raise ValueError(f"the calibration names configs {configs!r}, not "
                         f"'full' or 'smoke': the real side cannot serve "
                         f"the model it measured")
    # the deployed handler carries the cache's phase costs into the simulator
    platform = ServerlessPlatform(seed=0, calibrated=cache, device=device,
                                  smoke=configs == "smoke")
    specs = sc.deploy(platform)
    spec = specs[0]
    trace = sc.build_trace([s.name for s in specs], scale=scale)

    sim_row = run_stack(specs, trace, POLICY_STACKS[stack_name],
                        seed=sc.seed, sla=sc.sla, scenario=sc)

    from repro_torch.configs import registry
    arch = registry.get(fleet_fn.model)
    cfg = arch.smoke if configs == "smoke" else arch.config
    prof = get_provider(fleet_fn.provider)
    keepalive = stack.keepalive.materialize()
    price_100ms = prof.price_per_100ms(spec.memory_mb)
    # platform-side phases the replay cannot run for real — virtual
    # constants, surfaced in the report
    provision_s = prof.provision_s(spec.memory_mb)
    bootstrap_s = prof.exec_time(spec.handler.bootstrap_cpu_seconds,
                                 spec.memory_mb)

    warm_pool: list[_RealContainer] = []     # MRU order: hottest last
    retired: list[_RealContainer] = []
    last_arrival = None
    lat, colds, billed = [], 0, 0.0
    fn = spec.name
    for req in trace:
        t = req.arrival_s
        # eviction order mirrors the cluster: mid-gap expire events fire
        # under the TTL known *before* this arrival's gap is observed;
        # after observing, the (possibly shrunk) new TTL lazily evicts
        ttl_prev = keepalive.ttl(fn)
        for c in [c for c in warm_pool
                  if t - c.last_used_at >= ttl_prev - 1e-9]:
            c.evicted_at = c.last_used_at + ttl_prev
            warm_pool.remove(c)
            retired.append(c)
            c.release()
        if last_arrival is not None:
            keepalive.observe_gap(fn, t - last_arrival)
        last_arrival = t
        ttl = keepalive.ttl(fn)
        for c in [c for c in warm_pool if t - c.last_used_at >= ttl - 1e-9]:
            c.evicted_at = t                     # lazy evict at dispatch
            warm_pool.remove(c)
            retired.append(c)
            c.release()
        prompt = [1 + (req.rid % 97)] * prompt_len   # deterministic per rid
        if warm_pool:
            c = warm_pool.pop()                      # MRU
            setup = 0.0
        else:
            c = _RealContainer(cfg, slots=1,
                               max_seq=prompt_len + n_new + 4, seed=sc.seed,
                               device=device)
            c.created_at = t
            colds += 1
            setup = provision_s + bootstrap_s + c.init_wall_s
        exec_s = c.serve(req.rid, prompt, n_new)     # REAL inference
        cost = max(1, billed_ticks(exec_s)) * price_100ms
        billed += cost
        c.billed_cost += cost
        lat.append(setup + exec_s + NETWORK_OVERHEAD_S)
        c.last_used_at = t + setup + exec_s + NETWORK_OVERHEAD_S
        warm_pool.append(c)

    # run end: mirror the cluster's finalize — every surviving container
    # idles out at last_used + TTL, and bill-idle profiles pay for their
    # whole up-time beyond the exec ticks already billed
    ttl = keepalive.ttl(fn)
    for c in warm_pool:
        c.evicted_at = c.last_used_at + ttl
        c.release()
    capacity = 0.0
    if prof.bill_idle:
        for c in warm_pool + retired:
            up = max(0.0, c.evicted_at - c.created_at)
            capacity += max(0.0, up * prof.per_second_usd - c.billed_cost)

    n = len(lat)
    lat_sorted = sorted(lat)

    def pct(p):
        return lat_sorted[min(n - 1, int(round(p / 100.0 * (n - 1))))]

    real_row = {"n": n,
                "cold_rate": colds / max(n, 1),
                "cold_starts": colds,
                "p50_s": pct(50), "p95_s": pct(95),
                "cost_per_1k": (billed + capacity) / max(n, 1) * 1000.0,
                "mitigation_per_1k": capacity / max(n, 1) * 1000.0}

    metrics, ok = {}, True
    for name, tol in TOLERANCES.items():
        s, r = float(sim_row[name]), float(real_row[name])
        abs_err = abs(s - r)
        rel_err = abs_err / max(abs(s), 1e-9)
        within = (abs_err <= tol["abs"] if "abs" in tol
                  else rel_err <= tol["rel"])
        ok = ok and within
        metrics[name] = {"sim": s, "real": r, "abs_err": abs_err,
                         "rel_err": rel_err, "within": within}

    return {"schema_version": SCHEMA_VERSION,
            "scenario": sc.name, "stack": stack_name, "scale": scale,
            "n_requests": n,
            "model": fleet_fn.model, "provider": fleet_fn.provider,
            "host": calibration.host_fingerprint(device, configs == "smoke"),
            "virtual_phases": {"provision_s": provision_s,
                               "bootstrap_s": bootstrap_s,
                               "network_overhead_s": NETWORK_OVERHEAD_S},
            "sim": {k: sim_row[k] for k in
                    ("n", "cold_rate", "cold_starts", "p50_s", "p95_s",
                     "cost_per_1k", "mitigation_per_1k")},
            "real": real_row,
            "metrics": metrics,
            "tolerances": TOLERANCES,
            "within_tolerance": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Replay a suite-winning policy stack against the port's "
                    "real ContinuousServer and report sim-vs-real error.")
    ap.add_argument("--scenario", default="gpu_serverless",
                    choices=scenarios.names())
    ap.add_argument("--stack", default=None,
                    help="POLICY_STACKS name (default: the scenario's "
                         "expected winner)")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="trace time scale (default 0.05: a CI-sized "
                         "replay)")
    # beside the port's calibration cache, never the reference's report
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(calibration.default_cal_path()),
        "replay_report_torch.json"))
    ap.add_argument("--path", default=None,
                    help="calibration cache (default: "
                         "artifacts/calibration_torch.json); the scenario's "
                         "model is measured into it when absent")
    ap.add_argument("--smoke", action="store_true",
                    help="calibrate and serve the smoke config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    report = replay(args.scenario, stack_name=args.stack, scale=args.scale,
                    path=args.path, device=args.device, smoke=args.smoke)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(f"replayed {report['n_requests']} requests of "
          f"{report['scenario']!r} under {report['stack']!r} "
          f"(scale {report['scale']:g}, {report['host']['configs']} config "
          f"on {report['host']['device']})")
    for name, m in report["metrics"].items():
        print(f"  {name:14s} sim={m['sim']:.4f} real={m['real']:.4f} "
              f"rel_err={m['rel_err']:.2%} "
              f"{'ok' if m['within'] else 'OUT OF TOLERANCE'}")
    print(f"report -> {args.out} "
          f"(within_tolerance={report['within_tolerance']})")
    return 0 if report["within_tolerance"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
