"""The measured window: one loop over the server's public calls.

Each turn submits the requests that have fallen due, then admits when the
queue holds a request and a slot is free (``prefill_pending``), else decodes
one step while a slot is active (``step``), else sleeps until the next
request falls due.  Both calls end in a copy from the device to the host, so
the host clock around them is a synchronised span: a request's first token is
on the host when its admitting call returns, each later token when its step
returns.  Requests are timed from when they fell due, so a stall that delays
their submission counts.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field


@dataclass
class Record:
    """One request as the window saw it (times on the host's
    ``perf_counter``)."""
    rid: int
    due: float
    prompt_len: int
    n_new: int
    submitted: float | None = None
    first: float | None = None
    last: float | None = None
    tokens: int = 0

    @property
    def finished(self) -> bool:
        return self.tokens >= self.n_new


@dataclass
class Span:
    """One call of the server: ``admission`` or ``step``."""
    kind: str
    t0: float
    t1: float
    rows: int                  # requests admitted, or rows decoding
    keys: int = 0              # a step: keys its rows attend, summed
    lengths: tuple = ()        # an admission: the admitted prompts' lengths
    tokens: int = 0            # tokens that reached the host at t1
    traced: bool = False       # inside the profiled stretch


@dataclass
class Window:
    start: float
    end: float
    records: list
    spans: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def lateness(self) -> list:
        """Seconds each request due in the window was submitted after it fell
        due."""
        return [r.submitted - r.due for r in self.records
                if self.start <= r.due < self.end and r.submitted is not None]


def serve(server, items, prompts, *, lead_in: float, seconds: float, slots: int,
          request, tracer=None) -> Window:
    """Drive ``server`` with ``items`` (``traffic.Item``) from now: a lead-in,
    then the window of ``seconds``.  ``request(rid, prompt, n_new)`` makes the
    server's request object.  ``tracer`` (``trace.Tracer``), when given,
    profiles a stretch of the window."""
    origin = time.perf_counter()
    recs = [Record(it.rid, origin + it.due, it.prompt_len, it.n_new) for it in items]
    win = Window(origin + lead_in, origin + lead_in + seconds, recs)
    pending: deque = deque()
    inflight: dict[int, Record] = {}
    out = server.out
    label = tracer.label if tracer is not None else (lambda name: nullcontext())
    i = 0
    while True:
        now = time.perf_counter()
        if now >= win.end:
            break
        while i < len(recs) and recs[i].due <= now:
            r = recs[i]
            server.submit(request(r.rid, prompts[i], r.n_new))
            r.submitted = now
            pending.append(r)
            i += 1
        traced = tracer is not None and tracer.before(now, win)
        if pending and len(inflight) < slots:
            with label("bench.admission"):
                server.prefill_pending()
            t = time.perf_counter()
            admitted = []
            while pending and pending[0].rid in out:
                r = pending.popleft()
                r.first = r.last = t
                r.tokens = len(out[r.rid])
                admitted.append(r)
                if not r.finished:
                    inflight[r.rid] = r
            win.spans.append(Span("admission", now, t, len(admitted),
                                  lengths=tuple(r.prompt_len for r in admitted),
                                  tokens=sum(r.tokens for r in admitted), traced=traced))
        elif inflight:
            keys = sum(r.prompt_len + r.tokens for r in inflight.values())
            rows = len(inflight)
            with label("bench.step"):
                server.step()
            t = time.perf_counter()
            emitted = 0
            for rid in list(inflight):
                r = inflight[rid]
                n = len(out[rid])
                if n > r.tokens:
                    emitted += n - r.tokens
                    r.tokens, r.last = n, t
                if r.finished:
                    del inflight[rid]
            win.spans.append(Span("step", now, t, rows, keys=keys, tokens=emitted,
                                  traced=traced))
        else:
            wake = min(recs[i].due if i < len(recs) else win.end, win.end)
            with label("bench.wait"):
                time.sleep(max(0.0, wake - now))
            continue
        if tracer is not None:
            tracer.after(time.perf_counter(), win)
    if tracer is not None:
        tracer.close()
    return win
