"""What the per-layer metrics' readers (``metrics/<name>.py``) share: the
window's host spans, the work they did, and the profiled stretch.

Host spans are the server's calls that returned inside the window, less those
of the profiled stretch and of the profiler's stop after it, which the
profiler slows.  Shares are percentages.
"""
from __future__ import annotations

from . import work


def spans(run, kind: str, traced: bool = False) -> list:
    """The window's ``kind`` spans: those of the profiled stretch
    (``traced``), or those outside it."""
    win = run.window
    out = [s for s in win.spans if s.kind == kind and win.start <= s.t1 <= win.end]
    if traced:
        return [s for s in out if s.traced]
    if run.untraced is None:
        return out
    began, resumed = run.untraced
    return [s for s in out if s.t1 <= began or (resumed is not None and s.t0 >= resumed)]


def untraced_seconds(run) -> float:
    """The window's seconds less the profiled stretch and the stop after it."""
    win = run.window
    if run.untraced is None:
        return win.seconds
    began, resumed = run.untraced
    resumed = win.end if resumed is None else resumed
    return win.seconds - max(0.0, min(resumed, win.end) - max(began, win.start))


def mean_ms(run, kind: str) -> float | None:
    """Mean host milliseconds of a ``kind`` call (an admission that admitted
    at least one request)."""
    xs = [s.t1 - s.t0 for s in spans(run, kind) if s.rows]
    return 1e3 * sum(xs) / len(xs) if xs else None


def span_flops(run, s) -> int:
    m = run.dims
    if s.kind == "admission":
        return sum(work.prompt_flops(m, n) for n in s.lengths)
    return work.decode_flops(m, s.rows, s.keys)


def mfu_of_steps(run) -> float | None:
    """Useful operations of the decode steps over their host seconds at the
    bf16 peak."""
    steps = spans(run, "step")
    if run.peak is None or not steps:
        return None
    busy = sum(s.t1 - s.t0 for s in steps)
    return 100.0 * sum(span_flops(run, s) for s in steps) / (busy * run.peak["bf16_flops_per_s"])


def mfu_of_window(run) -> float | None:
    """Useful operations of every call over the window's seconds at the bf16
    peak (the profiled stretch left out of both)."""
    calls = spans(run, "admission") + spans(run, "step")
    if run.peak is None or not calls:
        return None
    return 100.0 * sum(span_flops(run, s) for s in calls) / (
        untraced_seconds(run) * run.peak["bf16_flops_per_s"])


def roofline(run, kind: str, least, kernels) -> float | None:
    """The least seconds the stretch's ``kind`` calls need of the kernels
    (``least(span)``), over the device seconds of the kernels whose names
    hold one of ``kernels``."""
    if run.trace is None or run.peak is None:
        return None
    device = run.trace.seconds_of(kernels)
    calls = spans(run, kind, traced=True)
    if device <= 0 or not calls:
        return None
    return 100.0 * sum(least(s) for s in calls) / device

