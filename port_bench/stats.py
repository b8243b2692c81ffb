"""The arithmetic of the end-to-end metrics, over one window's records.

A request counts when it fell due inside the window.  One that has no first
token when the window closes counts at its age then; one that has not
finished counts its time per output token up to the close.  Percentiles are
numpy's, interpolated linearly between order statistics.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .loop import Window
from .work import Dims


@dataclass
class Run:
    """What the metrics' readers read: the cell's files, the window, the
    set-up time, the card's peaks and, in a traced run, the profiled
    stretch (``trace.Stretch``)."""
    config: dict
    traffic: dict
    dims: Dims
    window: Window
    setup_s: float
    peak: dict | None = None
    trace: object | None = None
    untraced: tuple | None = None   # host times the profiled stretch began and the loop resumed


def due_in_window(win: Window) -> list:
    return [r for r in win.records if win.start <= r.due < win.end]


def percentile(values, q: float) -> float | None:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None


def ttft(win: Window) -> list:
    """Seconds from due to first token of each request due in the window."""
    return [(r.first if r.first is not None and r.first <= win.end else win.end) - r.due
            for r in due_in_window(win)]


def tpot(win: Window) -> list:
    """(last token - first token) / (output tokens - 1) of each request due
    in the window that has a first token; one still decoding at the close
    counts up to the close, over the tokens it has then."""
    out = []
    for r in due_in_window(win):
        if r.first is None or r.first > win.end or r.n_new < 2:
            continue
        if r.finished and r.last <= win.end:
            out.append((r.last - r.first) / (r.tokens - 1))
        else:
            out.append((win.end - r.first) / max(r.tokens - 1, 1))
    return out


def tokens_per_s(win: Window) -> float:
    """Prompt tokens admitted plus tokens served, by calls that returned
    inside the window, over the window's seconds; padding is not counted."""
    n = sum(sum(s.lengths) + s.tokens for s in win.spans if win.start <= s.t1 <= win.end)
    return n / win.seconds


def spread(values) -> float:
    """The distance between the first and third quartiles, as a share of the
    median (``statistics.quantiles``, exclusive method)."""
    import statistics
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
