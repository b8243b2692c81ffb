"""The port's named scenarios, experiment specs, keep-alive studies and
memory advisor (``repro_torch.core.scenarios``, ``stack.ExperimentSpec``,
``stack.run_specs``, ``keepalive``, ``advisor``) against the reference's, on
the CPU.  Tolerance 0: both run the same float64 arithmetic on the same
seeded numpy streams.  The scenarios of registry language models
(``gpu_serverless``, ``sharded_110b``) run on the reference's fallback
platform, which takes its pinned figures, and on a port platform built with
``calibrated=`` from those same pinned entries, read here and handed across
as a dict."""
import dataclasses
import itertools
import json
import math
from pathlib import Path

import pytest

from repro.core import advisor as r_advisor
from repro.core import calibration as r_cal
from repro.core import container as r_container
from repro.core import function as r_function
from repro.core import keepalive as r_keepalive
from repro.core import platform as r_platform
from repro.core import scenarios as r_scenarios
from repro.core import sla as r_sla
from repro.core import stack as r_stack
from repro.core import workload as r_workload
from repro.core.cluster import policies as r_policies
from repro_torch.core import advisor as p_advisor
from repro_torch.core import calibration as p_cal
from repro_torch.core import container as p_container
from repro_torch.core import function as p_function
from repro_torch.core import keepalive as p_keepalive
from repro_torch.core import platform as p_platform
from repro_torch.core import scenarios as p_scenarios
from repro_torch.core import simulator as p_simulator
from repro_torch.core import sla as p_sla
from repro_torch.core import stack as p_stack
from repro_torch.core import workload as p_workload
from repro_torch.core.cluster import policies as p_policies

ROOT = Path(__file__).resolve().parents[1]
SPEC_FILES = sorted((ROOT / "examples" / "specs").glob("*.json"))
SCENARIOS = r_scenarios.names()
STACKS = list(r_scenarios.POLICY_STACKS)
# the registry language models of the named scenarios, whose numbers only
# the reference pins
LLMS = ("deepseek-7b", "qwen1.5-110b")
CNNS = ("squeezenet", "resnet18", "resnext50")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Neither package's scaling estimate reads a cache file of this host,
    container ids start from 0 on both sides, and the port's per-process
    scenario contexts start empty."""
    monkeypatch.setattr(r_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(p_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(r_container, "_ids", itertools.count())
    monkeypatch.setattr(p_container, "_ids", itertools.count())
    monkeypatch.setattr(p_stack, "_WORKER_CTX", {})
    monkeypatch.setattr(r_stack, "_WORKER_CTX", {})


def _pinned() -> dict:
    """The reference's pinned language-model entries as a v2 cache dict."""
    return {"schema_version": p_cal.SCHEMA_VERSION,
            "host": {"configs": "the reference's pinned figures"},
            "models": {m: dict(r_cal.MODERN_MODELS[m]["fallback"]) for m in LLMS}}


def _port_platform(scenario: str):
    """The platform a port spec of ``scenario`` runs on: the default
    (fallback) one, or one over the pinned entries where the fleet holds a
    registry language model."""
    fleet = {f.model for f in p_scenarios.get(scenario).functions}
    if fleet & set(LLMS):
        return p_platform.ServerlessPlatform(seed=0, calibrated=_pinned(), device="cpu")
    return None


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


def _plain(x):
    """A scenario field as plain values: dataclasses as dicts, types by name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__, **{k: _plain(v) for k, v in
                                             dataclasses.asdict(x).items()}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _fleet_names(sc) -> list:
    return [f.name or f.model for f in sc.functions]


def _requests(trace) -> list:
    return [dataclasses.astuple(r) for r in trace]


# ---------------------------------------------------------------- definitions
@pytest.mark.parametrize("name", STACKS)
def test_policy_stack_equals_the_reference(name):
    assert list(p_scenarios.POLICY_STACKS) == STACKS
    assert p_scenarios.POLICY_STACKS[name].to_dict() == r_scenarios.POLICY_STACKS[name].to_dict()
    assert p_stack._named_stack(name) == p_scenarios.POLICY_STACKS[name]


def test_policy_stacks_compare_equal_where_the_reference_s_do():
    p, r = p_scenarios.POLICY_STACKS, r_scenarios.POLICY_STACKS
    assert len(STACKS) == 18
    for a, b in itertools.product(STACKS, repeat=2):
        assert (p[a] == p[b]) == (r[a] == r[b]), (a, b)
    assert {t.__name__: a for t, a in p_scenarios._TUNED_AXES.items()} == \
        {t.__name__: a for t, a in r_scenarios._TUNED_AXES.items()}


def test_registry_equals_the_reference():
    assert p_scenarios.names() == SCENARIOS and len(SCENARIOS) == 9
    for const in ("SPARSE_RATE_RPS", "SPARSE_DURATION_S", "GPU_SPARSE_RATE_RPS",
                  "GPU_SPARSE_DURATION_S", "SHARDED_RATE_RPS", "SHARDED_DURATION_S",
                  "UNRELIABLE_RATE_RPS", "UNRELIABLE_DURATION_S", "MULTI_TENANT_FNS",
                  "MULTI_TENANT_RPS", "_MT_MODELS", "_MT_TIERS"):
        assert getattr(p_scenarios, const) == getattr(r_scenarios, const), const
    with pytest.raises(KeyError, match="no_such"):
        p_scenarios.get("no_such")
    with pytest.raises(ValueError, match="duplicate"):
        p_scenarios.register(p_scenarios.get("sparse"))


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_fields_equal_the_reference(name):
    p, r = p_scenarios.get(name), r_scenarios.get(name)
    for f in dataclasses.fields(r_scenarios.Scenario):
        if f.name in ("trace", "stream_trace"):
            assert (getattr(p, f.name) is None) == (getattr(r, f.name) is None)
            continue
        _same(_plain(getattr(p, f.name)), _plain(getattr(r, f.name)), f"{name}.{f.name}")


@pytest.mark.parametrize("stack", STACKS)
@pytest.mark.parametrize("name", SCENARIOS)
def test_tune_equals_the_reference(name, stack):
    p_sc, r_sc = p_scenarios.get(name), r_scenarios.get(name)
    p_in, r_in = p_scenarios.POLICY_STACKS[stack], r_scenarios.POLICY_STACKS[stack]
    p_out, r_out = p_sc.tune(p_in), r_sc.tune(r_in)
    assert p_out.to_dict() == r_out.to_dict()
    assert (p_out == p_in) == (r_out == r_in)


def test_tuning_refuses_an_untunable_axis():
    with pytest.raises(TypeError, match="tuning entries"):
        dataclasses.replace(p_scenarios.get("sparse"), name="x",
                            tuning=(p_stack.ShardingConfig(kind="gang", fanout=4),))


# --------------------------------------------------------------------- traces
@pytest.mark.parametrize("name", SCENARIOS)
def test_tiny_trace_equals_the_reference(name):
    p, r = p_scenarios.get(name), r_scenarios.get(name)
    fns = _fleet_names(r)
    got = p.build_trace(fns, scale=p.tiny_scale)
    assert got and _requests(got) == _requests(r.build_trace(fns, scale=r.tiny_scale))
    with pytest.raises(ValueError, match="fleet names"):
        p.build_trace(fns + ["x"], scale=p.tiny_scale)


def test_multi_tenant_full_scale_trace_equals_the_reference():
    p, r = p_scenarios.get("multi_tenant"), r_scenarios.get("multi_tenant")
    fns = _fleet_names(r)
    got = _requests(p.build_trace(fns))
    assert len(got) > 50_000
    assert got == _requests(r.build_trace(fns))
    assert _requests(p.build_stream(fns)) == got
    with pytest.raises(ValueError, match="no streaming"):
        p_scenarios.get("sparse").build_stream(["resnet18"])


# -------------------------------------------------------------------- specs
def _versus(name):
    sc = r_scenarios.get(name)
    return ["baseline"] + ([sc.rival] if sc.rival else [])


@pytest.mark.parametrize("name,versus", [(n, v) for n in SCENARIOS for v in _versus(n)])
def test_experiment_spec_equals_the_reference(name, versus):
    sc = r_scenarios.get(name)
    want = r_stack.ExperimentSpec(name, sc.expected_winner, scale=sc.tiny_scale,
                                  versus=versus).run()
    got = p_stack.ExperimentSpec(name, sc.expected_winner, scale=sc.tiny_scale,
                                 versus=versus).run(_port_platform(name))
    _same(got.to_dict(), want.to_dict(), name)
    assert got.summary_line() == want.summary_line()
    assert got.n == got.n_requests > 0 and got.verdict["versus"] == versus


@pytest.mark.parametrize("path", SPEC_FILES, ids=lambda p: p.stem)
def test_example_spec_file_equals_the_reference(path):
    want = r_stack.ExperimentSpec.from_file(str(path))
    got = p_stack.ExperimentSpec.from_file(str(path))
    assert got.to_dict() == want.to_dict()
    _same(got.run(_port_platform(got.scenario)).to_dict(), want.run().to_dict(), path.stem)


@pytest.mark.parametrize("stack", ["adaptive", {"keepalive": {"kind": "adaptive"}},
                                   p_scenarios.POLICY_STACKS["pool_predictive"]],
                         ids=["name", "dict", "stack"])
def test_spec_round_trips(stack):
    spec = p_stack.ExperimentSpec("flash_crowd", stack, seed=3, scale=0.2,
                                  versus="predictive", tuned=False)
    assert p_stack.ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert p_stack.ExperimentSpec.from_dict(json.loads(json.dumps(spec.to_dict()))) == spec
    assert spec.to_dict() == r_stack.ExperimentSpec.from_dict(spec.to_dict()).to_dict()
    with pytest.raises(TypeError, match="stack must be"):
        p_stack.ExperimentSpec("sparse", 3)
    with pytest.raises(KeyError, match="unknown policy stack"):
        p_stack.ExperimentSpec("sparse", "no_such_stack")


def test_result_to_dict_round_trips_through_json():
    got = p_stack.ExperimentSpec("unreliable_burst", "retry_hedge_degrade", scale=0.1,
                                 versus="retry").run()
    d = json.loads(json.dumps(got.to_dict()))
    assert p_stack.ExperimentSpec.from_dict(d["spec"]) == got.spec
    _same(d, got.to_dict())
    rebuilt = p_stack.ExperimentResult(**{**d, "spec": got.spec})
    assert rebuilt.summary_line() == got.summary_line() and "avail=" in got.summary_line()


def test_untuned_spec_equals_the_reference():
    kw = dict(scenario="diurnal", stack="predictive", scale=0.05, versus="baseline",
              tuned=False)
    got, want = p_stack.ExperimentSpec(**kw).run(), r_stack.ExperimentSpec(**kw).run()
    _same(got.to_dict(), want.to_dict())
    assert got.effective_stack == p_scenarios.POLICY_STACKS["predictive"].to_dict()


# ---------------------------------------------------------------- run_specs
def _grid(module):
    return [module.ExperimentSpec(scenario="sparse", stack=s, scale=0.02)
            for s in module.PolicyStack.grid({"keepalive": ("fixed", "adaptive"),
                                              "scaling": ("lambda", "predictive")})]


def test_run_specs_serial_equals_parallel_and_the_reference():
    serial = p_stack.run_specs(_grid(p_stack))
    assert p_stack.run_specs(_grid(p_stack), jobs=2) == serial
    _same(serial, r_stack.run_specs(_grid(r_stack)))
    assert p_stack.run_specs([s.to_dict() for s in _grid(p_stack)]) == serial


def test_run_specs_on_a_calibration_equals_the_reference():
    names = ["gpu_serverless", "sharded_110b", "bursty"]
    specs = [(n, s) for n in names for s in
             ("baseline", r_scenarios.get(n).expected_winner, "predictive")]
    want = r_stack.run_specs([r_stack.ExperimentSpec(n, s, scale=r_scenarios.get(n).tiny_scale)
                              for n, s in specs])
    mine = [p_stack.ExperimentSpec(n, s, scale=p_scenarios.get(n).tiny_scale)
            for n, s in specs]
    serial = p_stack.run_specs(mine, calibrated=_pinned())
    _same(serial, want)
    assert p_stack.run_specs(mine, jobs=2, calibrated=_pinned()) == serial


def test_run_specs_resolves_the_measured_entries_in_the_parent(monkeypatch):
    """A worker must never ask for the device: the parent resolves the
    scaling estimates' measured entries when it builds the pool."""
    calls = []

    def measured():
        calls.append(1)
        return {}

    monkeypatch.setattr(p_policies, "_measured_models", measured)
    specs = [p_stack.ExperimentSpec("sharded_110b", s, scale=0.02)
             for s in ("sharded_gang", "sharded_8")]
    rows = p_stack.run_specs(specs, jobs=2, calibrated=_pinned())
    assert calls == [1]
    assert rows == p_stack.run_specs(specs, calibrated=_pinned())


def test_a_spawned_worker_takes_the_parent_s_entries(monkeypatch):
    """A threaded parent spawns its workers; each starts from the entries
    the parent handed it, not from a cache of its own, and still runs
    specs."""
    import threading
    entries = {"qwen1.5-110b": {"warm_exec_s": 5.0}}
    stop = threading.Event()
    t = threading.Thread(target=stop.wait, daemon=True)
    t.start()
    try:
        monkeypatch.setattr(p_policies, "_MEASURED_MODELS", entries)
        with p_stack.pool_executor(2) as pool:
            assert pool.submit(p_policies._measured_models).result() == entries
        rows = p_stack.run_specs([p_stack.ExperimentSpec("sparse", scale=0.02)], jobs=2)
        assert rows == p_stack.run_specs([p_stack.ExperimentSpec("sparse", scale=0.02)])
    finally:
        stop.set()
        t.join()


def test_run_specs_surfaces_worker_failure():
    good = p_stack.ExperimentSpec(scenario="sparse", scale=0.02)
    bad = p_stack.ExperimentSpec(scenario="no_such_scenario", scale=0.02)
    with pytest.raises(KeyError, match="no_such_scenario"):
        p_stack.run_specs([good, bad], jobs=2)


def test_scenario_context_is_keyed_on_the_calibration():
    other = _pinned()
    other["models"]["deepseek-7b"]["warm_exec_s"] *= 2
    a = p_stack._scenario_ctx("gpu_serverless", 0.2, _pinned())
    b = p_stack._scenario_ctx("gpu_serverless", 0.2, other)
    assert a is p_stack._scenario_ctx("gpu_serverless", 0.2, _pinned())
    assert b[1][0].handler.base_cpu_seconds == 2 * a[1][0].handler.base_cpu_seconds
    assert len(p_stack._WORKER_CTX) == 2


# ------------------------------------------------- the calibrated= departure
@pytest.mark.parametrize("name", ["gpu_serverless", "sharded_110b"])
def test_fallback_spec_of_a_language_model_raises(name):
    model = p_scenarios.get(name).functions[0].model
    with pytest.raises(KeyError, match=model):
        p_stack.ExperimentSpec(name).run()
    with pytest.raises(KeyError, match=model):
        p_stack.run_specs([p_stack.ExperimentSpec(name, scale=0.02)])


def test_a_calibrated_platform_reads_and_measures_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the calibrated= platform read or measured")

    for fn in ("measure_model", "load_cache", "calibrate", "ensure_measured", "save_cache",
               "host_fingerprint"):
        monkeypatch.setattr(p_cal, fn, refuse)
    plat = p_platform.ServerlessPlatform(seed=0, calibrated=_pinned())
    ref = r_platform.ServerlessPlatform(seed=0, use_fallback_calibration=True)
    for model, mb, provider in (("deepseek-7b", 16384, "modal_gpu"),
                                ("qwen1.5-110b", 1536, "lambda"), ("resnet18", 1024, "lambda")):
        got = plat.deploy_model(model, mb, provider=provider)
        want = ref.deploy_model(model, mb, provider=provider)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError, match="qwen2.5-32b"):
        plat.deploy_model("qwen2.5-32b", 1536)
    with pytest.raises(ValueError, match="conflict"):
        p_platform.ServerlessPlatform(calibrated=_pinned(), use_fallback_calibration=True)


def test_a_calibrated_cnn_takes_its_entry():
    cal = _pinned()
    cal["models"]["resnet18"] = {"kind": "cnn", "warm_exec_s": 0.004, "first_call_s": 0.5}
    plat = p_platform.ServerlessPlatform(seed=0, calibrated=cal, device="cpu")
    assert plat.deploy_model("resnet18", 1024).handler.base_cpu_seconds == 0.004
    assert plat.deploy_model("squeezenet", 1024).handler.base_cpu_seconds == \
        p_cal.PAPER_MODELS["squeezenet"]["fallback_s"]


# ----------------------------------------------------------------- keepalive
@pytest.mark.parametrize("ttl,rate", [(0.0, 0.01), (300.0, 0.0025), (480.0, 0.004),
                                      (600.0, 1.0), (1e4, 1e-5)])
def test_cold_probability_equals_the_reference(ttl, rate):
    got = p_keepalive.cold_probability(ttl, rate)
    assert got == r_keepalive.cold_probability(ttl, rate) and 0.0 <= got <= 1.0


@pytest.mark.parametrize("rate,budget", [(0.01, 10.0), (0.01, 50.0), (0.0025, 300.0),
                                         (2.0, 0.1), (1e-4, 1e6)])
def test_budget_ttl_equals_the_reference(rate, budget):
    assert p_keepalive.budget_ttl(rate, budget) == r_keepalive.budget_ttl(rate, budget)
    assert p_keepalive.budget_ttl(rate, budget) <= p_keepalive.budget_ttl(rate, 2 * budget)


def test_keepalive_reexports_the_cluster_policies():
    assert p_keepalive.FixedTTL is p_policies.FixedTTL
    assert p_keepalive.AdaptiveTTL is p_policies.AdaptiveTTL


def _ramp_spec(function):
    h = function.Handler(name="t", base_cpu_seconds=0.2, bootstrap_cpu_seconds=1.0,
                         package_mb=45.0, peak_memory_mb=100.0)
    return function.FunctionSpec(handler=h, memory_mb=1024)


def test_prewarm_equals_the_reference_and_removes_ramp_colds():
    peak = max(10 + 10 * t for t in range(10))
    schedule = dict(at_s=0.0, count=peak, lead_s=30.0)
    got, sim = p_keepalive.run_with_prewarm(
        _ramp_spec(p_function), p_workload.step_ramp(),
        p_keepalive.PrewarmSchedule(**schedule), seed=0)
    want, ref_sim = r_keepalive.run_with_prewarm(
        _ramp_spec(r_function), r_workload.step_ramp(),
        r_keepalive.PrewarmSchedule(**schedule), seed=0)
    assert [dataclasses.astuple(r) for r in got] == [dataclasses.astuple(r) for r in want]
    assert isinstance(sim, p_simulator.Simulator) and sim.cold_starts == ref_sim.cold_starts
    base = p_simulator.Simulator(_ramp_spec(p_function), seed=0).run(p_workload.step_ramp())
    base_colds = sum(r.cold for r in base)
    assert base_colds > 50 and sum(r.cold for r in got) < base_colds * 0.1
    assert all(r.tag != "prewarm" for r in got)


# ------------------------------------------------------------------- advisor
def _cnn_handler(module, variant):
    return module.ServerlessPlatform(use_fallback_calibration=True, **(
        {"device": "cpu"} if module is p_platform else {})).deploy_paper_model(
            variant, 1024).handler


@pytest.mark.parametrize("variant", CNNS)
def test_advisor_equals_the_reference(variant):
    kw = dict(tiers=p_function.PAPER_TIERS, seed=0)
    got = p_advisor.recommend(_cnn_handler(p_platform, variant), p_workload.warm_burst(n=25),
                              p_sla.SLA("x", p95_s=0.6), **kw)
    want = r_advisor.recommend(_cnn_handler(r_platform, variant), r_workload.warm_burst(n=25),
                               r_sla.SLA("x", p95_s=0.6), **kw)
    assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0]) and got[2] == want[2]
    assert [dataclasses.asdict(r) for r in got[1]] == [dataclasses.asdict(r) for r in want[1]]
    sweep = p_advisor.sweep(_cnn_handler(p_platform, variant), p_workload.poisson(0.05, 2000.0),
                            p_sla.INTERACTIVE, keepalive_s=60.0)
    assert [dataclasses.asdict(r) for r in sweep] == [dataclasses.asdict(r) for r in r_advisor.sweep(
        _cnn_handler(r_platform, variant), r_workload.poisson(0.05, 2000.0), r_sla.INTERACTIVE,
        keepalive_s=60.0)]
    assert len(sweep) == len(p_function.MEMORY_TIERS)


def test_advisor_recommends_the_cheapest_sla_tier():
    """The reference's case: squeezenet over a warm burst meets a 0.6 s p95
    at its cheapest feasible tier, no dearer than the largest."""
    best, reports, ok = p_advisor.recommend(
        _cnn_handler(p_platform, "squeezenet"), p_workload.warm_burst(n=25),
        p_sla.SLA("x", p95_s=0.6), tiers=p_function.PAPER_TIERS, seed=0)
    assert ok
    assert best.total_cost == min(r.total_cost for r in reports if r.feasible and r.sla_ok)
    top = [r for r in reports if r.memory_mb == 1536][0]
    assert best.total_cost <= top.total_cost
    assert not any(r.feasible for r in reports if r.memory_mb < 85)


def test_advisor_falls_back_to_the_lowest_p99():
    best, reports, ok = p_advisor.recommend(
        _cnn_handler(p_platform, "resnext50"), p_workload.warm_burst(n=25),
        p_sla.SLA("x", p95_s=1e-3), tiers=p_function.PAPER_TIERS, seed=0)
    want = r_advisor.recommend(
        _cnn_handler(r_platform, "resnext50"), r_workload.warm_burst(n=25),
        r_sla.SLA("x", p95_s=1e-3), tiers=r_function.PAPER_TIERS, seed=0)
    assert not ok and not want[2]
    assert best.p99_s == min(r.p99_s for r in reports if r.feasible)
    assert dataclasses.asdict(best) == dataclasses.asdict(want[0])
