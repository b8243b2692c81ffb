"""The port's policy-driven cluster (``repro_torch.core.cluster`` and the
modules it reaches) against the reference's on the same traces: records
column by column, cold starts, evictions, prewarms and billing totals, with
tolerance 0.  Both packages run the same float64 arithmetic on the same
seeded numpy streams on this host, so any difference is a fault of the
port.

The grid crosses the workload generators with the baseline stack and each
policy axis moved once (placement, keep-alive, scaling, the three cold-start
mitigations, batching on a measured batch curve, a gang fan-out and the
reliability axis under ``modal_gpu``'s faults), at jitter 0 and 0.03."""
import dataclasses
import itertools
import math
import types

import numpy as np
import pytest

import repro.core.cluster as r_cluster
from repro.core import container as r_container
from repro.core import faults as r_faults
from repro.core import function as r_function
from repro.core import metrics as r_metrics
from repro.core import providers as r_providers
from repro.core import sla as r_sla
from repro.core import stack as r_stack
from repro.core import workload as r_workload
from repro.core.cluster import events as r_events
from repro.core.cluster import policies as r_policies
import repro_torch.core.cluster as p_cluster
from repro_torch.core import container as p_container
from repro_torch.core import faults as p_faults
from repro_torch.core import function as p_function
from repro_torch.core import metrics as p_metrics
from repro_torch.core import providers as p_providers
from repro_torch.core import sla as p_sla
from repro_torch.core import stack as p_stack
from repro_torch.core import workload as p_workload
from repro_torch.core.cluster import events as p_events
from repro_torch.core.cluster import policies as p_policies

REF = types.SimpleNamespace(cluster=r_cluster, container=r_container, faults=r_faults,
                            function=r_function, metrics=r_metrics, providers=r_providers,
                            sla=r_sla, stack=r_stack, workload=r_workload, events=r_events,
                            policies=r_policies)
PORT = types.SimpleNamespace(cluster=p_cluster, container=p_container, faults=p_faults,
                             function=p_function, metrics=p_metrics, providers=p_providers,
                             sla=p_sla, stack=p_stack, workload=p_workload, events=p_events,
                             policies=p_policies)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def _no_host_calibration(monkeypatch):
    """Neither package's scaling estimate reads a cache file of this host."""
    monkeypatch.setattr(r_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(p_policies, "_MEASURED_MODELS", {})


# the paper's three CNN payloads (fallback figures), one tenant each
HANDLERS = (dict(name="squeezenet", base_cpu_seconds=0.22, package_mb=5.0,
                 peak_memory_mb=85.0),
            dict(name="resnet18", base_cpu_seconds=0.35, package_mb=45.0,
                 peak_memory_mb=229.0),
            dict(name="resnext50", base_cpu_seconds=0.80, package_mb=98.0,
                 peak_memory_mb=429.0))
MEMORY = (1024, 768, 1536)
CURVE = ((1, 1.0), (2, 0.62), (4, 0.41), (8, 0.3))


@dataclasses.dataclass(frozen=True)
class Case:
    """One stack of the grid, built per package from its own modules."""
    stack: object                      # side -> PolicyStack
    handler: dict = dataclasses.field(default_factory=dict)
    first_name: str = ""               # rename the first tenant
    provider: str = "lambda"
    faults: object = None              # side -> FaultConfig


def _modal_faults(side):
    return side.faults.FaultConfig.from_provider(side.providers.MODAL_GPU, severity=25.0,
                                                 seed=3)


CASES = {
    "baseline": Case(lambda s: s.stack.BASELINE),
    "placement_lru": Case(lambda s: s.stack.BASELINE.with_(placement="lru")),
    "placement_least_loaded_c2": Case(
        lambda s: s.stack.BASELINE.with_(placement="least_loaded", concurrency=2)),
    "keepalive_adaptive": Case(lambda s: s.stack.BASELINE.with_(keepalive="adaptive")),
    "scaling_predictive": Case(lambda s: s.stack.BASELINE.with_(scaling="predictive")),
    "coldstart_snapshot": Case(lambda s: s.stack.BASELINE.with_(coldstart="snapshot")),
    "coldstart_layered_capped": Case(
        lambda s: s.stack.BASELINE.with_(coldstart="layered", max_containers=4)),
    "coldstart_package_cache": Case(
        lambda s: s.stack.BASELINE.with_(coldstart="package_cache")),
    "batching_curve": Case(
        lambda s: s.stack.BASELINE.with_(
            batching=s.cluster.BatchingConfig(max_batch=4, max_wait_s=0.2)),
        handler={"batch_curve": CURVE}),
    "sharding_gang4": Case(
        lambda s: s.stack.BASELINE.with_(
            sharding=s.stack.ShardingConfig(kind="gang", fanout=4)),
        first_name="deepseek-7b"),
    "reliability_modal_faults": Case(
        lambda s: s.stack.BASELINE.with_(
            reliability=s.stack.ReliabilityConfig(kind="hedge", timeout_s=30.0)),
        provider="modal_gpu", faults=_modal_faults),
}


def _specs(side, case: Case, n: int):
    out = []
    for i, (h, m) in enumerate(zip(HANDLERS[:n], MEMORY)):
        kw = dict(h, bootstrap_cpu_seconds=1.2, **case.handler)
        if i == 0 and case.first_name:
            kw["name"] = case.first_name
        out.append(side.function.FunctionSpec(handler=side.function.Handler(**kw),
                                              memory_mb=m, provider=case.provider))
    return out


def _multi(side, specs):
    w = side.workload
    names = [s.name for s in specs]
    return w.multi_function_trace(
        {names[0]: 0.4, names[1]: lambda seed: w.mmpp_bursty(duration_s=400.0, seed=seed),
         names[2]: 0.15}, duration_s=400.0, seed=5)


# workload -> (trace of one package for its specs, tenants it addresses)
WORKLOADS = {
    "cold_probe": (lambda s, _: s.workload.cold_probe(), 1),
    "warm_burst": (lambda s, _: s.workload.warm_burst(), 1),
    "step_ramp": (lambda s, _: s.workload.step_ramp(start_rps=5, step_rps=5, duration_s=6), 1),
    "poisson": (lambda s, _: s.workload.poisson(1.5, 300.0, seed=1), 1),
    "mmpp_bursty": (lambda s, _: s.workload.mmpp_bursty(duration_s=1200.0, seed=2), 1),
    "diurnal": (lambda s, _: s.workload.diurnal(base_rps=0.3, period_s=600.0,
                                             duration_s=1200.0, seed=3), 1),
    "flash_crowd": (lambda s, _: s.workload.flash_crowd(spike_at_s=200.0, duration_s=600.0,
                                                     seed=4), 1),
    "multi_function_3": (_multi, 3),
}


def _run(side, workload: str, case: str, jitter: float, *, record_sink=None, seed: int = 7):
    side.container._ids = itertools.count()
    make, n = WORKLOADS[workload]
    c = CASES[case]
    specs = _specs(side, c, n)
    sim = side.cluster.ClusterSimulator(
        specs, stack=c.stack(side), seed=seed, jitter=jitter,
        faults=c.faults(side) if c.faults else None, record_sink=record_sink)
    return sim, sim.run(make(side, specs))


def _same(a, b, where="") -> None:
    """Exact equality of nested values; NaN equals NaN."""
    if isinstance(a, float) or isinstance(b, float):
        assert (a == b) or (math.isnan(a) and math.isnan(b)), (where, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


SIM_TOTALS = ("cold_starts", "evictions", "prewarms", "events", "mitigation_cost",
              "idle_capacity_cost", "sim_end_s")


def _assert_same_run(ref_sim, ref_recs, sim, recs) -> None:
    assert len(recs) == len(ref_recs) > 0
    assert p_events.RECORD_FIELDS == r_events.RECORD_FIELDS
    for f in r_events.RECORD_FIELDS:
        want, got = ref_recs.column(f), recs.column(f)
        if want.dtype == object:
            assert list(got) == list(want), f
        else:
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f
    for name in SIM_TOTALS:
        _same(getattr(sim, name), getattr(ref_sim, name), name)
    _same(dataclasses.asdict(p_metrics.summarize(recs)),
          dataclasses.asdict(r_metrics.summarize(ref_recs)), "summary")


@pytest.mark.parametrize("jitter", [0.0, 0.03], ids=["jitter0", "jitter0.03"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_cluster_records_equal_the_reference(workload, case, jitter):
    ref_sim, ref_recs = _run(REF, workload, case, jitter)
    sim, recs = _run(PORT, workload, case, jitter)
    _assert_same_run(ref_sim, ref_recs, sim, recs)


# what each case must visibly do on a trace that reaches it, so that the
# parity above is not vacuous
COVERAGE = {
    "placement_least_loaded_c2": ("step_ramp", lambda sim, r: r.column("start_exec_s").size
                                  > sim.cold_starts),
    "keepalive_adaptive": ("mmpp_bursty", lambda sim, r: sim.evictions > 0),
    "scaling_predictive": ("diurnal", lambda sim, r: sim.prewarms > 0),
    "coldstart_snapshot": ("cold_probe", lambda sim, r: r.column("restore_s").max() > 0),
    "coldstart_layered_capped": ("flash_crowd", lambda sim, r: "pool" in set(r.column("cold_kind"))),
    "coldstart_package_cache": ("cold_probe", lambda sim, r: r.column("load_s")[-1]
                                < r.column("load_s")[0]),
    "batching_curve": ("step_ramp", lambda sim, r: r.column("batch_size").max() > 1),
    "sharding_gang4": ("poisson", lambda sim, r: sim.mitigation_cost > 0),
    "reliability_modal_faults": ("poisson", lambda sim, r: r.column("attempts").max() > 1
                                 and sim.idle_capacity_cost > 0),
}


@pytest.mark.parametrize("case", sorted(COVERAGE))
def test_each_case_takes_the_path_it_names(case):
    workload, check = COVERAGE[case]
    for side in SIDES:
        sim, recs = _run(side, workload, case, 0.03)
        assert check(sim, recs), (case, side is PORT)


@pytest.mark.parametrize("mode", ["spill", "fold", "hold"])
@pytest.mark.parametrize("workload,case", [("poisson", "baseline"),
                                           ("multi_function_3", "coldstart_layered_capped"),
                                           ("flash_crowd", "reliability_modal_faults")])
def test_streaming_sinks_equal_the_reference(tmp_path, mode, workload, case):
    """A chunked ``StreamingRecordArray``: the spilled file read back by
    ``iter_spilled`` (its text too), the folded summary and bimodality, and
    a held sink's rows equal the reference's."""
    def sink(side, tag):
        path = tmp_path / f"{tag}.jsonl" if mode == "spill" else None
        return side.events.StreamingRecordArray(chunk_size=37, mode=mode, spill_path=path)

    ref_sim, ref_recs = _run(REF, workload, case, 0.03, record_sink=sink(REF, "ref"))
    sim, recs = _run(PORT, workload, case, 0.03, record_sink=sink(PORT, "port"))
    for name in SIM_TOTALS:
        _same(getattr(sim, name), getattr(ref_sim, name), name)
    _same(dataclasses.asdict(p_metrics.summarize(recs)),
          dataclasses.asdict(r_metrics.summarize(ref_recs)), "summary")
    _same(p_sla.bimodality_report(recs), r_sla.bimodality_report(ref_recs), "bimodality")
    if mode == "spill":
        assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "ref.jsonl").read_text()
        got = [dataclasses.astuple(r) for r in p_events.iter_spilled(tmp_path / "port.jsonl")]
        want = [dataclasses.astuple(r) for r in r_events.iter_spilled(tmp_path / "ref.jsonl")]
        assert got == want and len(got) > 0
        _, plain = _run(PORT, workload, case, 0.03)
        assert got == [dataclasses.astuple(r) for r in plain]
    if mode == "hold":
        _assert_same_run(ref_sim, ref_recs, sim, recs)


# ------------------------------------------------------------- workloads
GENERATORS = {
    "cold_probe": lambda w: w.cold_probe(n=7, gap_s=450.0),
    "warm_burst": lambda w: w.warm_burst(n=12, interval_s=0.5),
    "warm_burst_unprimed": lambda w: w.warm_burst(prime=False),
    "step_ramp": lambda w: w.step_ramp(),
    "poisson": lambda w: w.poisson(3.0, 500.0, seed=11),
    "mmpp_bursty": lambda w: w.mmpp_bursty(duration_s=2400.0, seed=12, start_on=True),
    "diurnal": lambda w: w.diurnal(seed=13),
    "flash_crowd": lambda w: w.flash_crowd(seed=14),
    "azure_multitenant": lambda w: w.azure_multitenant(n_functions=12, total_rps=0.5,
                                                       duration_s=3600.0, seed=15),
    "multi_function_trace": lambda w: w.multi_function_trace(
        {"a": 0.5, "b": lambda s: w.flash_crowd(duration_s=900.0, seed=s), "c": 0.0,
         "d": w.poisson(0.2, 900.0, seed=3)}, duration_s=900.0, seed=16),
}


def _rows(trace):
    return [(r.rid, r.arrival_s, r.tag, r.fn) for r in trace]


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_workload_generators_equal_the_reference(name):
    got, want = _rows(GENERATORS[name](p_workload)), _rows(GENERATORS[name](r_workload))
    assert got == want and len(got) > 0


def test_traces_cross_between_the_packages(tmp_path):
    """A trace saved by either package (JSON and JSONL) replays in the
    other to the same requests."""
    trace = p_workload.multi_function_trace({"a": 0.5, "b": 0.3}, duration_s=200.0, seed=1)
    p_workload.save_trace(trace, str(tmp_path / "p.json"))
    r_workload.save_trace(r_workload.trace_replay(str(tmp_path / "p.json")),
                          str(tmp_path / "r.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "r.json").read_text()
    p_workload.save_trace_jsonl(trace, str(tmp_path / "p.jsonl"))
    assert _rows(r_workload.trace_replay(str(tmp_path / "p.jsonl"))) == _rows(trace)
    assert _rows(p_workload.iter_trace_jsonl(str(tmp_path / "p.jsonl"))) == _rows(trace)
    assert p_workload.trace_to_dict(trace) == r_workload.trace_to_dict(
        r_workload.trace_replay(str(tmp_path / "p.json")))


# ---------------------------------------------------- metrics and the SLA
@pytest.mark.parametrize("as_list", [False, True], ids=["columnar", "records"])
@pytest.mark.parametrize("workload,case", [("warm_burst", "baseline"),
                                           ("flash_crowd", "coldstart_snapshot"),
                                           ("poisson", "reliability_modal_faults")])
def test_metrics_and_sla_equal_the_reference(workload, case, as_list):
    """``summarize`` (all, warm, cold), ``phase_breakdown``,
    ``container_seconds``, ``bimodality_report`` and each SLA's
    ``evaluate`` on the columnar sink and on plain record lists."""
    _, ref_recs = _run(REF, workload, case, 0.03)
    _, recs = _run(PORT, workload, case, 0.03)
    if as_list:
        ref_recs, recs = list(ref_recs), list(recs)
    for kw in ({}, {"warm_only": True}, {"cold_only": True}, {"drop_tags": ()}):
        _same(dataclasses.asdict(p_metrics.summarize(recs, **kw)),
              dataclasses.asdict(r_metrics.summarize(ref_recs, **kw)), str(kw))
    _same(p_metrics.phase_breakdown(recs), r_metrics.phase_breakdown(ref_recs), "phases")
    _same(p_metrics.container_seconds(recs, 300.0),
          r_metrics.container_seconds(ref_recs, 300.0), "container_seconds")
    _same(p_sla.bimodality_report(recs), r_sla.bimodality_report(ref_recs), "bimodality")
    for name in ("INTERACTIVE", "STRINGENT", "GPU_INTERACTIVE"):
        _same(getattr(p_sla, name).evaluate(recs), getattr(r_sla, name).evaluate(ref_recs),
              name)


def test_quantile_sketch_equals_the_reference():
    xs = np.random.default_rng(0).lognormal(0.0, 1.0, 5000)
    a, b = p_metrics.QuantileSketch(0.001), r_metrics.QuantileSketch(0.001)
    for chunk in np.array_split(xs, 7):
        a.update(chunk)
        b.update(chunk)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert a.quantile(q) == b.quantile(q)
