"""The serving path's recorder (``repro_torch.serving.telemetry``): on the CPU,
a recorded server's tokens against an unrecorded one's, the spans' nesting,
each request's times, the admission counters against a count of their own,
graphs made after the recorder was set, device readings absent; the
recorder's arithmetic (the host-clock placement of event pairs, the idle
split by span) on a stand-in for CUDA events; and, on a card (``pytest -m
gpu``), event-timed replays inside their host spans and one capture span a
graph."""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_7b, granite_moe_3b
from repro_torch.serving import telemetry as tm
from repro_torch.serving.continuous import ContinuousServer, Request
from repro_torch.serving.engine import bucket_len
from repro_torch.serving.telemetry import OUTSIDE, Span, Telemetry

CFG = deepseek_7b.SMOKE
SLOTS, MAX_SEQ = 4, 128


def _requests(seed=5, n=9):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, 512, size=int(rng.integers(3, 70))).tolist(),
                    int(rng.integers(1, 12))) for i in range(n)]


def _serve(server, reqs):
    """Submit in two waves, admitting and stepping as the benchmark's loop
    does; -> each request's tokens."""
    for wave in (reqs[:5], reqs[5:]):
        for r in wave:
            server.submit(Request(r.rid, list(r.prompt), r.n_new))
        while server.queue or server.n_active():
            if server.queue and server.n_active() < server.slots:
                server.prefill_pending()
            else:
                server.step()
    return {rid: list(t) for rid, t in server.out.items()}


@pytest.fixture(scope="module")
def served():
    """A server with no recorder and one recorded from its construction, on
    the same weights."""
    plain = ContinuousServer(CFG, slots=SLOTS, max_seq=MAX_SEQ, seed=0, device="cpu")
    rec = ContinuousServer(CFG, slots=SLOTS, max_seq=MAX_SEQ, params=plain.params,
                           device="cpu")
    tel = Telemetry("cpu")
    rec.telemetry = tel
    reqs = _requests()
    return plain, rec, tel, reqs, _serve(plain, reqs), _serve(rec, reqs)


def test_recorded_tokens_equal_unrecorded_and_nothing_is_recorded_when_off(served):
    plain, rec, tel, reqs, want, got = served
    assert got == want and len(want) == len(reqs)
    assert plain.telemetry is None
    assert all(g.telemetry is None for g in plain._graphs())
    assert all(g.telemetry is tel for g in rec._graphs())
    # switched on and off again before serving, a server records nothing
    off = ContinuousServer(CFG, slots=SLOTS, max_seq=MAX_SEQ, params=plain.params,
                           device="cpu")
    off.telemetry = unused = Telemetry("cpu")
    off.telemetry = None
    assert _serve(off, reqs) == want
    assert not (unused.spans or unused.devices or unused.counters or unused.requests)
    assert all(g.telemetry is None for g in off._graphs())


CHILDREN = {"admit": ["admit.prefill", "admit.scatter", "admit.first_tokens",
                      "admit.bookkeeping"],
            "step": ["step.launch", "step.copy_out", "step.settle"]}


def test_spans_nest_as_stated(served):
    _, rec, tel, reqs, _, _ = served
    spans = tel.spans
    tops = [i for i, s in enumerate(spans) if s.parent is None]
    assert {spans[i].name for i in tops} == {"admit", "step"}
    for i in tops:
        kids = [s for s in spans if s.parent == i]
        assert [k.name for k in kids] == CHILDREN[spans[i].name]
        assert all(spans[i].t0 <= k.t0 <= k.t1 <= spans[i].t1 for k in kids)
        assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
        assert spans[i].rids
    assert sum(s.name == "step" for s in spans) == rec.steps
    # each device reading is made inside the span that launched it
    by_name = {"replay.prefill": "admit.prefill", "replay.decode": "step.launch",
               "admit.scatter": "admit.scatter", "admit.first_tokens": "admit.first_tokens"}
    assert tel.devices
    for d in tel.devices:
        assert spans[d.span].name == by_name[d.name]


def test_each_request_is_submitted_admitted_served_and_finished_in_order(served):
    _, _, tel, reqs, _, _ = served
    for r in reqs:
        t = tel.requests[r.rid]
        assert t.submitted <= t.admitted <= t.first_token_on_host <= t.finished
    admits = [s for s in tel.spans if s.name == "admit"]
    assert sorted(rid for s in admits for rid in s.rids) == sorted(r.rid for r in reqs)
    for s in admits:
        assert all(tel.requests[rid].admitted == s.t0 for rid in s.rids)


def test_admission_counters_equal_a_count_from_prompts_slots_and_buckets(served):
    _, _, tel, reqs, _, _ = served
    prompts = {r.rid: r.prompt for r in reqs}
    want = {"admit.rows": 0, "admit.padded_rows": 0, "admit.prompt_tokens": 0,
            "admit.prefill_positions": 0}
    for i, s in enumerate(tel.spans):
        if s.name != "admit":
            continue
        lens = [len(prompts[rid]) for rid in s.rids]
        bucket = min(bucket_len(max(lens)), MAX_SEQ)
        one = {"admit.rows": len(lens), "admit.padded_rows": SLOTS,
               "admit.prompt_tokens": sum(lens), "admit.prefill_positions": SLOTS * bucket}
        prefill = next(k for k in tel.spans if k.parent == i and k.name == "admit.prefill")
        assert prefill.counts == one
        for k, v in one.items():
            want[k] += v
    assert tel.counters == want


def test_the_exact_length_admission_counts_its_own_length():
    cfg = granite_moe_3b.SMOKE
    srv = ContinuousServer(cfg, slots=3, max_seq=48, seed=0, device="cpu")
    srv.telemetry = tel = Telemetry("cpu")
    reqs = [Request(i, list(range(1, n + 1)), 2) for i, n in enumerate((5, 9, 3, 17))]
    for r in reqs:
        srv.submit(r)
    srv.run()
    n = sum(len(r.prompt) for r in reqs)
    assert tel.counters == {"admit.rows": 4, "admit.padded_rows": 4,
                            "admit.prompt_tokens": n, "admit.prefill_positions": n}
    assert all(g.telemetry is tel and g.label == f"exact {length}"
               for length, g in srv._exact.items())


def test_graphs_made_after_the_recorder_was_set_report_to_it():
    srv = ContinuousServer(CFG, slots=SLOTS, max_seq=MAX_SEQ, seed=0, device="cpu")
    srv.telemetry = tel = Telemetry("cpu")
    assert not srv._admissions
    reqs = [Request(0, [1] * 5, 3), Request(1, [2] * 40, 3)]
    for r in reqs:
        srv.submit(r)
        srv.prefill_pending()
    assert sorted(srv._admissions) == [8, 64]
    for bucket, (g, _) in srv._admissions.items():
        assert g.telemetry is tel and g.label == f"bucket {bucket}"
    assert [d.name for d in tel.devices if d.name.startswith("replay")] == ["replay.prefill"] * 2


def test_device_readings_are_none_on_the_cpu(served):
    _, _, tel, _, _, _ = served
    assert not tel.cuda
    assert all(d.t0 is None and d.seconds is None for d in tel.device_times())
    assert tel.idle_by_span() is None


# ----------------------------------------------------------------------
# the recorder's arithmetic, on a stand-in for CUDA events
# ----------------------------------------------------------------------

class FakeDevice:
    """A device clock on another epoch than the host's: an event fires when
    the device reaches it, ``lag`` seconds after its record."""

    def __init__(self):
        self.lag, self.epoch = 0.0, 1000.0

    def event(self, enable_timing=False):
        dev = self

        class Event:
            def record(self, stream=None):
                self.t = time.perf_counter() + dev.epoch + dev.lag

            def elapsed_time(self, other):
                return (other.t - self.t) * 1e3

        return Event()


@pytest.fixture
def fake_cuda(monkeypatch):
    dev = FakeDevice()
    monkeypatch.setattr(torch.cuda, "Event", dev.event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return dev


def test_event_pairs_go_onto_the_host_clock_at_the_calls_anchor(fake_cuda, monkeypatch):
    monkeypatch.setattr(tm, "ANCHOR_S", 0.0)
    tel = Telemetry("cuda", events=4)
    assert len(tel._pool) == 4
    marks = []
    for _ in range(3):               # three calls, each anchored at its close
        with tel.span("call"):
            fake_cuda.lag = 0.003    # the device runs behind the host ...
            h0 = time.perf_counter()
            with tel.timed("replay.decode"):
                time.sleep(0.002)
            fake_cuda.lag = 0.0      # ... until the copy to the host drains it
            time.sleep(0.004)
            with tel.span("copy", anchor=True) as copy:
                pass
        marks.append((h0, copy.t1))
    with tel.timed("replay.prefill"):   # no anchor of its own: one at the read
        time.sleep(0.001)
    got = tel.device_times()
    assert [d.name for d in got] == ["replay.decode"] * 3 + ["replay.prefill"]
    for d, (h0, h1) in zip(got, marks):
        assert h0 + 0.003 <= d.t0 < d.t1 <= h1 and d.seconds >= 0.002
    assert got[3].seconds >= 0.001 and got[3].t0 > marks[-1][1]
    assert not tel._pending and len(tel._pool) >= 4    # the events went back to the pool


def test_calls_within_the_anchor_period_share_the_next_anchor(fake_cuda, monkeypatch):
    monkeypatch.setattr(tm, "ANCHOR_S", 0.05)
    tel = Telemetry("cuda", events=2)
    anchored, marks = [], []
    for wait in (0.0, 0.0, 0.06, 0.0):   # the third call closes past the period
        time.sleep(wait)
        with tel.span("call"):
            fake_cuda.lag = 0.002
            h0 = time.perf_counter()
            with tel.timed("replay.decode"):
                time.sleep(0.001)
            fake_cuda.lag = 0.0
            time.sleep(0.003)
            with tel.span("copy", anchor=True) as copy:
                pass
        anchored.append(len(tel._anchors))
        marks.append((h0, copy.t1))
    assert anchored == [1, 1, 2, 2]
    got = tel.device_times()             # the fourth call's anchor is the read's
    for d, (h0, h1) in zip(got, marks):
        assert h0 + 0.002 <= d.t0 < d.t1 <= h1 and d.seconds >= 0.001


def test_idle_splits_each_gap_by_the_innermost_span_open_over_it():
    tel = Telemetry("cpu")
    tel.cuda = True                  # readings made by hand, already resolved

    def span(name, t0, t1, parent=None):
        s = Span(name, t0, parent)
        s.t1 = t1
        tel.spans.append(s)
        return len(tel.spans) - 1

    step = span("step", 1.0, 2.0)
    span("step.launch", 1.0, 1.2, step)
    span("step.copy_out", 1.2, 1.9, step)
    span("step.settle", 1.9, 2.0, step)
    tel.devices = [tm.DeviceTime("replay.decode", 1, 1.1, 1.5),
                   tm.DeviceTime("replay.decode", 1, 2.5, 3.0)]
    idle = tel.idle_by_span([(0.5, 3.5)])
    assert idle == pytest.approx({OUTSIDE: 0.5 + 0.5 + 0.5, "step.launch": 0.1,
                                  "step.copy_out": 0.4, "step.settle": 0.1})
    # an interval that cuts a reading counts only its own part
    assert tel.idle_by_span([(1.4, 1.6), (2.9, 3.2)]) == pytest.approx(
        {"step.copy_out": 0.1, OUTSIDE: 0.2})
    assert sum(tel.idle_by_span().values()) == pytest.approx(1.0)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_event_timed_replays_lie_inside_their_host_spans(cuda):
    srv = ContinuousServer(CFG, slots=SLOTS, max_seq=MAX_SEQ, seed=0, device=cuda)
    srv.telemetry = tel = Telemetry(cuda)
    t0 = time.perf_counter()
    _serve(srv, _requests(n=12))
    t1 = time.perf_counter()
    spans = tel.spans
    got = tel.device_times()
    assert got and all(d.seconds is not None and d.seconds > 0 for d in got)
    slack = 1e-4     # the anchor's event fires a few microseconds after its record
    for d in got:
        top = spans[d.span]
        while top.parent is not None:
            top = spans[top.parent]
        assert d.seconds <= top.t1 - top.t0
        assert top.t0 - slack <= d.t0 and d.t1 <= top.t1 + slack
    idle = tel.idle_by_span([(t0, t1)])
    share = 100.0 * sum(idle.values()) / (t1 - t0)
    assert 0.0 <= share <= 100.0
    stats = srv.compile_stats()
    captures = [s for s in spans if s.name == "graph.capture"]
    assert len(captures) == stats["graphs"] + stats["prefill_graphs"]
    assert sorted(s.detail for s in captures) == sorted(
        ["decode"] + [f"bucket {b}" for b in srv._admissions])
