"""The profiled stretch of a traced run, and its reduction.

A traced run (``--trace 1``) profiles one stretch of its window with
``torch.profiler`` (host annotations and the device's kernels, copies and
fills): from ``start_s`` into the window until it has lasted ``min_s`` and
held ``min_admissions`` admissions (the traffic file's ``trace`` entry).  The
profiler is started once in set-up, so that its own start-up falls there.
After the window the trace is written to a temporary file, reduced to a
``Stretch`` and deleted; a stretch of some hundred thousand kernels keeps it
to some tens of MB.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LABELS = ("bench.admission", "bench.step", "bench.wait")
BETWEEN_CALLS = "bench.loop"
STRETCH = "bench.stretch"


@dataclass
class Stretch:
    """A profiled stretch, reduced: its seconds, the seconds in which the
    device ran an operation, device seconds by operation name, and the
    device's idle seconds by what the host was doing then."""
    window_s: float
    busy_s: float
    by_name: dict = field(default_factory=dict)
    idle_by_host: dict = field(default_factory=dict)
    longest_idle: list = field(default_factory=list)

    def seconds_of(self, names) -> float:
        """Device seconds of the operations whose name contains any of
        ``names``."""
        return sum(s for n, s in self.by_name.items() if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _split(a: float, b: float, host: list, ends: list, idle: dict) -> str:
    """Add the idle interval [a, b] to ``idle`` by the host annotations that
    cover its parts (the rest between calls); -> the label of its largest
    part."""
    parts = {}
    k = bisect.bisect_right(ends, a)
    t = a
    while k < len(host) and host[k][0] < b:
        h0, h1, name = host[k]
        if h0 > t:
            parts[BETWEEN_CALLS] = parts.get(BETWEEN_CALLS, 0.0) + h0 - t
        lo, hi = max(h0, t), min(h1, b)
        parts[name] = parts.get(name, 0.0) + hi - lo
        t = hi
        k += 1
    if b > t:
        parts[BETWEEN_CALLS] = parts.get(BETWEEN_CALLS, 0.0) + b - t
    for name, us in parts.items():
        idle[name] = idle.get(name, 0.0) + us * 1e-6
    return max(parts, key=parts.get)


def reduce_events(events: list) -> Stretch:
    """Reduce a Chrome trace's events (``traceEvents``) to a ``Stretch``:
    everything inside the ``bench.stretch`` annotation."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    outer = [e for e in spans if e.get("name") == STRETCH and e.get("cat") == "user_annotation"]
    if not outer:
        raise ValueError("the trace holds no stretch annotation")
    s0 = float(outer[0]["ts"])
    s1 = s0 + float(outer[0]["dur"])
    dev, by_name = [], {}
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), s0), min(float(e["ts"]) + float(e["dur"]), s1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans
                  if e.get("cat") == "user_annotation" and e.get("name") in HOST_LABELS)
    ends = [h[1] for h in host]
    idle, gaps, t = {}, [], s0
    for a, b in busy + [[s1, s1]]:
        if a > t:
            gaps.append(((a - t) * 1e-6, _split(t, a, host, ends, idle)))
        t = max(t, b)
    return Stretch((s1 - s0) * 1e-6, sum(b - a for a, b in busy) * 1e-6, by_name, idle,
                   sorted(gaps, reverse=True)[:10])


class Tracer:
    """Profiles one stretch of the window; ``loop.serve`` calls ``before``
    and ``after`` around each call of the server."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.prof = None
        self.annotation = None
        self.started = self.resumed = None   # host times: stretch start, loop resumed after stop
        self.admissions = 0

    @staticmethod
    def _profile():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def warm(self) -> None:
        """A throw-away profile, so that the profiler's start-up is set-up's."""
        with self._profile():
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.resumed is None

    def label(self, name: str):
        return torch.profiler.record_function(name) if self.active else nullcontext()

    def before(self, now: float, win) -> bool:
        if self.prof is None and now >= win.start + self.spec["start_s"]:
            self.prof = self._profile()
            self.prof.start()
            self.annotation = torch.profiler.record_function(STRETCH)
            self.annotation.__enter__()
            self.started = time.perf_counter()
        return self.active

    def after(self, now: float, win) -> None:
        if not self.active:
            return
        if win.spans and win.spans[-1].kind == "admission":
            self.admissions += 1
        if (now - self.started >= self.spec["min_s"]
                and self.admissions >= self.spec["min_admissions"]):
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.annotation.__exit__(None, None, None)
        self.prof.stop()
        self.resumed = time.perf_counter()

    def close(self) -> None:
        """At the window's close: end a stretch still open."""
        if self.active:
            self._stop()

    def reduce(self) -> Stretch | None:
        """The stretch, reduced (None when no stretch was profiled)."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_events(events)
