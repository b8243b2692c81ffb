"""One cell of ``BENCHMARK.json``, run once: set-up, window, judgement,
metrics.  ``run.py`` is its command line; the tools and the tests call the
same functions."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import check, loop, stats, traffic as traffic_mod
from .trace import Tracer
from .work import Dims, peaks

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: dict      # metric name -> unit
    per_layer: dict


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files."""
    bench = bench or json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name, conf["name"], json.loads((REPO / conf["file"]).read_text()),
        json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        json.loads((HERE / "limits" / f"{name}.json").read_text()),
        {m["name"]: m["unit"] for m in bench["end_to_end"] if _reports(m, name)},
        {m["name"]: m["unit"] for m in bench["per_layer"] if _reports(m, name)})


def reader(kind: str, name: str):
    """The ``read(run)`` of ``<kind>/<name>.py`` (``e2e`` or ``metrics``)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def family(cell: Cell):
    return importlib.import_module(f"port_bench.families.{cell.config['family']}")


def reference(cell: Cell, weights: dict, precision: str = "float32"):
    mod = importlib.import_module(f"port_bench.reference.{cell.config['family']}")
    return mod.Reference(cell.config, weights, precision)


def say(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(cell: Cell, seed: int, device, items):
    """The weights from ``seed`` and the server, built and warmed up: every
    admission bucket that the prompts of ``items`` (``traffic.Item``) reach
    is admitted once and drained, which also captures the decode step.
    -> (weights, server)."""
    fam = family(cell)
    t = time.perf_counter()
    weights = fam.make_weights(cell.config, seed, device)
    _sync(device)
    say(f"weights {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    tr = cell.traffic
    server = fam.make_server(cell.config, cell.config_name, weights, slots=tr["slots"],
                             max_seq=tr["max_seq"], device=device)
    for j, b in enumerate(traffic_mod.buckets(tr, items, fam.bucket)):
        n = min(b, tr["prompt"]["max"])
        server.submit(fam.request(-1 - j, [1] * n, 2))
        server.prefill_pending()
        while server.n_active():
            server.step()
    _sync(device)
    say(f"server and warm-up {time.perf_counter() - t:.3f} s, "
        f"compile_stats {server.compile_stats()}")
    return weights, server


def schedule(cell: Cell, seed: int, seconds: float, rate=None) -> list:
    return traffic_mod.schedule(cell.traffic, seed, seconds, rate)


def serve(cell: Cell, server, seed: int, items, seconds: float, *, tracer=None):
    """The window over ``items``, the cell's traffic.  -> (window, prompts by
    rid)."""
    fam = family(cell)
    prompts = traffic_mod.prompts(items, cell.config["vocab_size"], seed)
    win = loop.serve(server, items, prompts, lead_in=cell.traffic["lead_in_s"],
                     seconds=seconds, slots=cell.traffic["slots"], request=fam.request,
                     tracer=tracer)
    return win, {it.rid: p for it, p in zip(items, prompts)}


def served_tokens(server, win) -> dict:
    """Each request's served tokens, by rid, as the server holds them."""
    return {r.rid: list(server.out[r.rid]) for r in win.records if r.tokens}


def judge(cell: Cell, win, prompts: dict, served: dict, seed: int, device,
          control: bool = False) -> dict:
    """The check of the window's served tokens against the reference, on
    weights drawn again from ``seed``; with ``control`` also the control's
    reading (the reference in fp8) on the same sample."""
    weights = family(cell).make_weights(cell.config, seed, device)
    c = cell.traffic["check"]
    picked = check.sample(win.records, served, seed, c["served_tokens"], c["max_requests"])
    ctl = reference(cell, weights, "fp8") if control else None
    result = check.gaps(reference(cell, weights), prompts, served, picked, ctl)
    del weights
    return result


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _say_window(win) -> None:
    """The window's lateness against the schedule and its calls, on
    standard error."""
    late = win.lateness()
    if late:
        say(f"lateness against the schedule: mean {sum(late) / len(late):.6f} s, "
            f"max {max(late):.6f} s, over {len(late)} requests due in the window")
    steps = [s for s in win.spans if s.kind == "step"]
    adm = [s for s in win.spans if s.kind == "admission" and s.rows]
    say(f"window: {len(adm)} admissions of {sum(s.rows for s in adm)} requests, "
        f"{len(steps)} steps")
    for traced in (False, True):
        xs = [s.t1 - s.t0 for s in steps if s.traced == traced]
        if xs:
            say(f"{'traced' if traced else 'untraced'} steps: {len(xs)}, mean "
                f"{1e3 * sum(xs) / len(xs):.3f} ms")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             started: float) -> dict:
    """One run; ``started``: the process's start on ``perf_counter``.
    -> the result line's object."""
    device = torch.device(device)
    tracer = Tracer(cell.traffic["trace"]) if trace else None
    items = schedule(cell, seed, seconds)
    weights, server = build(cell, seed, device, items)
    if tracer is not None:
        tracer.warm()
    setup_s = time.perf_counter() - started
    say(f"setup_s {setup_s:.3f}")
    win, prompts = serve(cell, server, seed, items, seconds, tracer=tracer)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    served = served_tokens(server, win)
    del server, weights
    free(device)
    _say_window(win)
    t = time.perf_counter()
    stretch = tracer.reduce() if tracer is not None else None
    if stretch is not None:
        say(f"trace reduced in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    result = judge(cell, win, prompts, served, seed, device)
    free(device)
    say(f"reference check {time.perf_counter() - t:.3f} s")
    ok, checks = check.verdict(result, cell.limits)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = stats.Run(cell.config, cell.traffic, Dims.of(cell.config), win, setup_s,
                    peaks(kind), stretch,
                    (tracer.started, tracer.resumed) if tracer is not None else None)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name, unit in wanted.items():
        value = reader("metrics" if trace else "e2e", name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": ok,
            "attempted": sum(1 for r in win.records
                             if win.start <= r.due < win.end
                             or (r.last is not None and r.last >= win.start)),
            "failed": sum(g > cell.limits["widest_logit_gap"] for g in result["per_request"]),
            "metrics": metrics, "device": dev}
    if stretch is not None:
        dev["busy_s"], dev["window_s"] = stretch.busy_s, stretch.window_s
        line["breakdown"] = stretch.breakdown()
        say(f"traced stretch {stretch.window_s:.6f} s, busy {stretch.busy_s:.6f} s, "
            f"longest idle gaps {stretch.longest_idle}")
    say(f"compared {result['requests']} requests, {result['tokens']} served tokens")
    for name, c in checks.items():
        say(f"check {name} {c['value']} limit {c['limit']}")
    line["checks"] = checks
    return line
