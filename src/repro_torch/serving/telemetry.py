"""An in-memory recorder of the serving path: spans, counters, each
request's times, and the device time of its graphs' replays.  Off unless a
``Telemetry`` is handed to ``ContinuousServer.telemetry``; each instrumented
point then costs one ``is not None`` test.

Host times are ``time.perf_counter()``.  A span records its name, start and
end, its parent (the innermost span open when it began) and the request ids it
serves; a counter adds an integer to the recorder's total and to the
innermost open span's, so that a reader can take the counts of a stretch of
time.  Device work is bracketed by a pair of CUDA events (timing on) from a
pool made with the recorder, and nothing is read back until the recorder is
read: ``device_times()`` and ``idle_by_span()`` resolve every pair with one
``synchronize``.  Device times go onto the host clock at a server call's
closing copy to the host: once ``.cpu()`` has returned the stream is drained,
so an event recorded then (an anchor) fires as it is recorded, and each pair
before it is placed back from it by ``elapsed_time``.  An anchor slows the
next call (by some 0.08 ms on an H100, whose first copy to the device waits
for the stream), so a call anchors only where ``ANCHOR_S`` has passed since
the last anchor; within that the clocks drift apart by microseconds at
most.

On the CPU there are no events: device readings are ``None``.  While
``torch.profiler`` records, each span also opens a ``record_function`` of
its name, so the program's spans sit in the profiler's trace.
"""
from __future__ import annotations

import bisect
import time
from contextlib import nullcontext
from dataclasses import dataclass

import torch

OUTSIDE = "outside"      # idle while no program span was open
ANCHOR_S = 0.25          # host seconds from one anchor to the next, at least
NULL = nullcontext()


class Span:
    """A host span: ``t1`` is None while it is open; ``parent`` is the index
    in ``Telemetry.spans`` of the span it opened inside."""
    __slots__ = ("name", "t0", "t1", "parent", "rids", "detail", "counts")

    def __init__(self, name: str, t0: float, parent, detail=None):
        self.name, self.t0, self.t1, self.parent = name, t0, None, parent
        self.rids: tuple = ()
        self.detail = detail
        self.counts: dict | None = None


@dataclass
class RequestTimes:
    """One request's host times: queued, its admission began, its first
    token reached the host, its last token settled."""
    rid: int
    submitted: float | None = None
    admitted: float | None = None
    first_token_on_host: float | None = None
    finished: float | None = None


@dataclass(slots=True)
class DeviceTime:
    """A stretch of device work between two events, on the host clock once
    resolved (None until then, and always on the CPU); ``span`` is the
    index of the innermost program span open when it was launched."""
    name: str
    span: int | None
    t0: float | None = None
    t1: float | None = None

    @property
    def seconds(self) -> float | None:
        return None if self.t0 is None else self.t1 - self.t0


class _Open:
    """The context of the spans of one name and options, made once a
    recorder: its state lives on the recorder's stack of open spans."""
    __slots__ = ("tel", "name", "detail", "sync", "anchor")

    def __init__(self, tel, name, detail, sync, anchor):
        self.tel, self.name, self.detail, self.sync, self.anchor = tel, name, detail, sync, anchor

    def __enter__(self) -> Span:
        tel = self.tel
        if tel._open:
            parent = tel._open[-1]
        else:
            parent = None
            if tel.cuda:             # once a call: the stream its events go on
                tel._stream = torch.cuda.current_stream(tel.device)
        sp = Span(self.name, 0.0, parent, self.detail)
        tel._open.append(len(tel.spans))
        tel.spans.append(sp)
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            tel._functions[len(tel._open)] = rf
        sp.t0 = time.perf_counter()
        return sp

    def __exit__(self, *exc) -> None:
        tel = self.tel
        if self.sync and tel.cuda:
            torch.cuda.synchronize(tel.device)
        if self.anchor:
            tel.anchor()
        sp = tel.spans[tel._open[-1]]
        sp.t1 = time.perf_counter()
        rf = tel._functions.pop(len(tel._open), None)
        if rf is not None:
            rf.__exit__(*exc)
        tel._open.pop()


class _Timed:
    """The context of the event pairs of one name, made once a recorder."""
    __slots__ = ("tel", "name")

    def __init__(self, tel, name):
        self.tel, self.name = tel, name

    def __enter__(self) -> DeviceTime:
        tel = self.tel
        dev = DeviceTime(self.name, tel._open[-1] if tel._open else None)
        tel.devices.append(dev)
        if tel.cuda:
            if not tel._open:
                tel._stream = torch.cuda.current_stream(tel.device)
            e0 = tel._event()
            e0.record(tel._stream)
            tel._started.append((dev, e0))
        return dev

    def __exit__(self, *exc) -> None:
        tel = self.tel
        if tel.cuda:
            dev, e0 = tel._started.pop()
            e1 = tel._event()
            e1.record(tel._stream)
            tel._pending.append((dev, e0, e1))


class Telemetry:
    """The recorder.  ``spans``, ``counters``, ``requests`` (rid ->
    ``RequestTimes``) are plain containers a reader may walk;
    ``device_times()`` resolves the device readings first."""

    def __init__(self, device="cuda", events: int = 1 << 14):
        """``events``: CUDA events made (and recorded once, so that CUDA
        creates them) now; more are made if a run needs them."""
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.requests: dict[int, RequestTimes] = {}
        self.devices: list[DeviceTime] = []
        self._open: list[int] = []         # indices of the open spans, innermost last
        self._functions: dict = {}         # depth -> its span's record_function
        self._contexts: dict = {}
        self._started: list = []           # (DeviceTime, start event) of open pairs
        self._pending: list = []           # (DeviceTime, start, end) not yet read
        self._anchors: list = []           # (pairs before it in _pending, event, host time)
        self._anchored = float("-inf")     # host time of the last anchor
        self._stream = None
        self._pool: list = []
        if self.cuda:
            stream = torch.cuda.current_stream(self.device)
            for _ in range(events):
                e = torch.cuda.Event(enable_timing=True)
                e.record(stream)
                self._pool.append(e)
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------------- record
    def span(self, name: str, *, detail=None, sync: bool = False, anchor: bool = False):
        """A context that records a span of ``name``: ``sync`` synchronises
        the device before it ends, ``anchor`` records an anchor where one
        is due (the caller's stream has just been drained)."""
        key = (name, detail, sync, anchor)
        ctx = self._contexts.get(key)
        if ctx is None:
            ctx = self._contexts[key] = _Open(self, name, detail, sync, anchor)
        return ctx

    def timed(self, name: str):
        """A context whose device work is bracketed by an event pair."""
        ctx = self._contexts.get(name)
        if ctx is None:
            ctx = self._contexts[name] = _Timed(self, name)
        return ctx

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self._open:
            sp = self.spans[self._open[-1]]
            if sp.counts is None:
                sp.counts = {}
            sp.counts[name] = sp.counts.get(name, 0) + n

    def submitted(self, rid: int) -> None:
        """A new record of request ``rid``, queued now."""
        self.requests[rid] = RequestTimes(rid, time.perf_counter())

    def stamp(self, rids, field: str, t: float | None = None) -> None:
        """Set ``field`` of each request in ``rids`` to ``t`` (now if
        None)."""
        t = time.perf_counter() if t is None else t
        for rid in rids:
            rec = self.requests.get(rid)
            if rec is None:
                rec = self.requests[rid] = RequestTimes(rid)
            setattr(rec, field, t)

    def _event(self):
        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def _unanchored(self) -> bool:
        return len(self._pending) > (self._anchors[-1][0] if self._anchors else 0)

    def anchor(self, force: bool = False) -> None:
        """Tie the unanchored event pairs to the host clock: an event
        recorded now, on a drained stream, and the host time; unless
        ``force``, only where ``ANCHOR_S`` has passed since the last."""
        if not self.cuda or not self._unanchored():
            return
        now = time.perf_counter()
        if not force and now - self._anchored < ANCHOR_S:
            return
        ev = self._event()
        ev.record(self._stream if self._open else torch.cuda.current_stream(self.device))
        self._anchored = time.perf_counter()
        self._anchors.append((len(self._pending), ev, self._anchored))

    # ------------------------------------------------------------------ read
    def device_times(self) -> list[DeviceTime]:
        """Every event-timed stretch, resolved onto the host clock (one
        ``synchronize``; on the CPU their readings stay None)."""
        if not self._pending:
            return self.devices
        if self._unanchored():
            torch.cuda.synchronize(self.device)
            self.anchor(force=True)
        torch.cuda.synchronize(self.device)
        k = 0
        for end, ea, ta in self._anchors:
            for dev, e0, e1 in self._pending[k:end]:
                seconds = e0.elapsed_time(e1) * 1e-3
                dev.t1 = ta - e1.elapsed_time(ea) * 1e-3
                dev.t0 = dev.t1 - seconds
                self._pool += (e0, e1)
            self._pool.append(ea)
            k = end
        self._pending, self._anchors = [], []
        return self.devices

    def _timeline(self) -> tuple[list, list]:
        """Host times and the innermost span's name from each of them on."""
        marks = []
        for i, s in enumerate(self.spans):
            marks.append((s.t0, 1, i))
            marks.append((s.t1 if s.t1 is not None else float("inf"), 0, -i))
        marks.sort()
        times, names, stack = [], [], []
        for t, opening, i in marks:
            if opening:
                stack.append(i)
            else:
                stack.remove(-i)
            name = self.spans[stack[-1]].name if stack else OUTSIDE
            if times and times[-1] == t:
                names[-1] = name
            else:
                times.append(t)
                names.append(name)
        return times, names

    def idle_by_span(self, intervals=None) -> dict | None:
        """The device's idle seconds inside ``intervals`` (host-clock
        ``(start, end)`` pairs; by default from the first device reading to
        the last), each part of each gap under the innermost program span
        open over it (``OUTSIDE`` where none was).  None on the CPU."""
        if not self.cuda:
            return None
        busy = sorted((d.t0, d.t1) for d in self.device_times() if d.t0 is not None)
        if intervals is None:
            intervals = [(busy[0][0], max(b for _, b in busy))] if busy else []
        times, names = self._timeline()
        starts = [a for a, _ in busy]
        idle: dict[str, float] = {}
        for a, b in intervals:
            t = a
            k = max(bisect.bisect_right(starts, a) - 1, 0)
            for d0, d1 in busy[k:]:
                if d0 >= b:
                    break
                if d0 > t:
                    _split(t, d0, times, names, idle)
                t = max(t, d1)
            if b > t:
                _split(t, b, times, names, idle)
        return idle


def _split(a: float, b: float, times: list, names: list, idle: dict) -> None:
    """Add [a, b] to ``idle`` by the timeline's name over each part."""
    k = bisect.bisect_right(times, a) - 1
    t = a
    while t < b:
        name = names[k] if k >= 0 else OUTSIDE
        end = times[k + 1] if k + 1 < len(times) else b
        end = min(end, b)
        idle[name] = idle.get(name, 0.0) + end - t
        t = end
        k += 1


def span(tel: Telemetry | None, name: str, **kw):
    """``tel.span(name, **kw)``, or a context that records nothing when
    ``tel`` is None."""
    return NULL if tel is None else tel.span(name, **kw)


def timed(tel: Telemetry | None, name: str):
    """``tel.timed(name)``, or a context that records nothing."""
    return NULL if tel is None else tel.timed(name)
