"""The port's serverless run (``launch/serve.py --serverless``): its
single-function ``Simulator`` (``core/simulator.py``, the facade over the
port's cluster) and ``FunctionSpec`` against the reference's ``Simulator``
and ``FunctionSpec`` on the same measured engine numbers, at jitter 0 and at
the default 0.03, and the CLI on the CPU."""
import dataclasses
import itertools
import re
from unittest import mock

import numpy as np
import pytest

from repro.configs.registry import ARCHS
from repro.core import container as ref_container
from repro.core import function as ref_function
from repro.core import simulator as ref_simulator
from repro.core import workload as ref_workload
from repro.serving import handler as ref_handler
from repro_torch.configs import registry
from repro_torch.core import container, function, simulator, workload
from repro_torch.serving import handler

# measured engine numbers (``measure_engine``'s keys): a warm request well
# inside the 1 s interval; a cold start (load + warm-up) that outlasts the
# 5 s priming gap, so the first warm arrival finds the container still
# starting; a batch slower than the 1 s interval, so warm arrivals overlap
# and take more containers; both; a package past the 510 MB cap
MEASURED = [
    dict(load_s=0.8, compile_s=1.4, serve_batch_s=0.061, package_mb=12.5),
    dict(load_s=3.2, compile_s=4.9, serve_batch_s=0.25, package_mb=40.0),
    dict(load_s=0.3, compile_s=0.2, serve_batch_s=2.35, package_mb=7.0),
    dict(load_s=4.0, compile_s=2.5, serve_batch_s=1.7, package_mb=300.0),
    dict(load_s=0.05, compile_s=0.01, serve_batch_s=0.999, package_mb=900.0),
]


def _specs(m: dict, memory_mb: int = 1536):
    cfg = registry.get("deepseek-7b").smoke
    mine = function.FunctionSpec(handler=handler.llm_handler(cfg, measured=m),
                                 memory_mb=memory_mb)
    ref = ref_function.FunctionSpec(
        handler=ref_handler.llm_handler(ARCHS["deepseek-7b"].smoke, measured=m),
        memory_mb=memory_mb)
    return mine, ref


def test_the_handlers_carry_the_same_numbers():
    for m in MEASURED:
        mine, ref = _specs(m)
        assert dataclasses.asdict(mine.handler) == dataclasses.asdict(ref.handler)
        assert mine.name == ref.name


@pytest.mark.parametrize("m", MEASURED)
@pytest.mark.parametrize("memory_mb", [1536, 512, 1024])
def test_records_equal_the_reference_simulator(m, memory_mb):
    """Cold flags, start, end and response times of ``warm_burst(n=10)``
    (and of a longer burst) equal the reference ``Simulator``'s at jitter 0,
    float for float."""
    mine, ref = _specs(m, memory_mb)
    for n in (10, 25):
        got = simulator.Simulator(mine, jitter=0.0).run(workload.warm_burst(n=n))
        want = list(ref_simulator.Simulator(ref, seed=0, jitter=0.0).run(
            ref_workload.warm_burst(n=n)))
        assert len(got) == len(want) == n + 1
        for g, w in zip(got, want):
            assert (g.rid, g.arrival_s, g.start_exec_s, g.end_s, g.cold, g.exec_s, g.tag) == \
                (w.rid, w.arrival_s, w.start_exec_s, w.end_s, w.cold, w.exec_s, w.tag)
            assert g.response_s == w.response_s


def test_the_measured_cases_take_the_paths_they_stand_for():
    """At 1536 MB: the quick engine serves the burst from one warm
    container; a cold start past the 5 s gap and a batch past the 1 s
    interval each start more containers."""
    colds = [sum(r.cold for r in simulator.Simulator(_specs(m)[0], jitter=0.0).run(
        workload.warm_burst(n=10))) for m in MEASURED]
    assert colds[0] == 1 and colds[1] > 1 and colds[2] > 1 and colds[3] > 1


def test_records_follow_the_reference_across_a_keepalive_eviction():
    """Arrivals 10 minutes apart (past the 480 s keep-alive) start cold
    again, and a burst after them reuses the most recent container."""
    mine, ref = _specs(MEASURED[0])
    arrivals = [0.0, 700.0, 720.0, 721.0, 1500.0, 1530.0]
    got = simulator.Simulator(mine, jitter=0.0).run([workload.Request(i, t)
                                                     for i, t in enumerate(arrivals)])
    want = list(ref_simulator.Simulator(ref, jitter=0.0).run(
        [ref_workload.Request(i, t) for i, t in enumerate(arrivals)]))
    assert [(r.cold, r.end_s) for r in got] == [(r.cold, r.end_s) for r in want]
    assert [r.cold for r in got] == [True, True, False, False, True, False]


def test_cold_start_breakdown_and_warm_burst_equal_the_reference():
    for m in MEASURED:
        for memory_mb in (128, 640, 1536):
            mine, ref = _specs(m, memory_mb)
            a = container.cold_start_breakdown(mine)
            b = ref_container.cold_start_breakdown(ref)
            assert (a.provision_s, a.bootstrap_s, a.load_s, a.total_s) == \
                (b.provision_s, b.bootstrap_s, b.load_s, b.total_s)
    for kw in ({}, {"n": 10}, {"n": 1}):
        assert [(r.rid, r.arrival_s, r.tag) for r in workload.warm_burst(**kw)] == \
            [(r.rid, r.arrival_s, r.tag) for r in ref_workload.warm_burst(**kw)]


def test_function_spec_refuses_what_the_reference_refuses():
    h = handler.llm_handler(registry.get("deepseek-7b").smoke, measured=MEASURED[0])
    assert function.MEMORY_TIERS == ref_function.MEMORY_TIERS
    for memory_mb in (1000, 64, 1600):
        with pytest.raises(ValueError, match="tier"):
            function.FunctionSpec(handler=h, memory_mb=memory_mb)
        with pytest.raises(ValueError, match="tier"):
            ref_function.FunctionSpec(handler=ref_function.Handler(**dataclasses.asdict(h)),
                                      memory_mb=memory_mb)
    huge = dataclasses.replace(h, package_mb=600.0)
    with pytest.raises(ValueError, match="512"):
        function.FunctionSpec(handler=huge, memory_mb=1536)
    big = dataclasses.replace(h, peak_memory_mb=2000.0)
    with pytest.raises(ValueError, match="OOM"):
        function.FunctionSpec(handler=big, memory_mb=1536)
    with pytest.raises(ValueError, match="OOM"):
        ref_function.FunctionSpec(handler=ref_function.Handler(**{
            k: v for k, v in dataclasses.asdict(big).items()}), memory_mb=1536)


@pytest.mark.parametrize("seed", [0, 5])
def test_records_equal_the_reference_simulator_at_the_default_jitter(seed):
    """At the reference's default jitter of 0.03 the lognormal draws come
    from the same seeded numpy stream: every field of every record, the
    container ids and the cold starts equal the reference's."""
    for m in MEASURED:
        mine, ref = _specs(m)
        trace = workload.warm_burst(n=25) + [workload.Request(26 + i, 700.0 + 0.3 * i)
                                             for i in range(8)]
        ref_trace = ref_workload.warm_burst(n=25) + [
            ref_workload.Request(26 + i, 700.0 + 0.3 * i) for i in range(8)]
        container._ids = itertools.count()
        sim = simulator.Simulator(mine, seed=seed)
        got = [dataclasses.astuple(r) for r in sim.run(trace)]
        ref_container._ids = itertools.count()
        ref_sim = ref_simulator.Simulator(ref, seed=seed)
        want = [dataclasses.astuple(r) for r in ref_sim.run(ref_trace)]
        assert sim.jitter == ref_sim.jitter == 0.03
        assert got == want and len(got) == 34
        assert sim.cold_starts == ref_sim.cold_starts
    # the jitter is drawn: another seed moves the times
    assert got != [dataclasses.astuple(r) for r in simulator.Simulator(mine, seed=seed + 1).run(
        trace)]


def test_serve_cli_serverless_prints_the_reference_simulators_times(capsys):
    """``serve --serverless --smoke --device cpu`` prints the reference's
    line, with the cold and warm times the reference ``Simulator`` gives for
    the engine numbers the CLI measured."""
    from repro_torch.launch import serve

    seen, measure = [], handler.measure_engine

    def measured(*args, **kw):
        m = measure(*args, **kw)
        seen.append(m)
        return m

    with mock.patch.object(handler, "measure_engine", measured):
        serve.main(["--arch", "deepseek-7b", "--smoke", "--requests", "2", "--n-new", "3",
                    "--device", "cpu", "--serverless"])
    out = capsys.readouterr().out
    line = re.search(r"\[serve\] serverless: cold=(\S+)s warm=(\S+)s \(bimodality x(\S+)\)",
                     out)
    assert line and len(seen) == 1
    ref = ref_function.FunctionSpec(
        handler=ref_handler.llm_handler(ARCHS["deepseek-7b"].smoke, measured=seen[0]),
        memory_mb=1536)
    recs = list(ref_simulator.Simulator(ref, seed=0, jitter=0.0).run(
        ref_workload.warm_burst(n=10)))
    cold = [r for r in recs if r.cold][0].response_s
    warm = [r for r in recs if not r.cold][0].response_s
    assert line.groups() == (f"{cold:.2f}", f"{warm:.3f}", f"{cold / warm:.1f}")
    assert np.isfinite(cold) and cold > warm > 0
