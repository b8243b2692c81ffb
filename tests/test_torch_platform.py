"""The port's ``ServerlessPlatform`` (``repro_torch.core.platform``) against
the reference's, on the CPU with the paper's fallback figures: the three
experiments of the paper for its three CNNs at three memory tiers, a shared
fleet, the per-axis shim and per-call overrides, the deploy refusals, and
language-model handlers built by both packages from one v2 calibration
dict.  Tolerance 0: both run the same float64 arithmetic on the same seeded
numpy streams.  Also the port's own difference: deploying an unmeasured
registry model measures it once through the port's engine and persists it."""
import dataclasses
import itertools
import math

import pytest

from repro.core import calibration as r_cal
from repro.core import container as r_container
from repro.core import function as r_function
from repro.core import platform as r_platform
from repro.core import stack as r_stack
from repro.core import workload as r_workload
from repro.core.cluster import policies as r_policies
from repro_torch.core import calibration as p_cal
from repro_torch.core import container as p_container
from repro_torch.core import function as p_function
from repro_torch.core import platform as p_platform
from repro_torch.core import stack as p_stack
from repro_torch.core import workload as p_workload
from repro_torch.core.cluster import policies as p_policies

CNNS = ("squeezenet", "resnet18", "resnext50")
TIERS = (512, 1024, 1536)
EXPERIMENTS = ("run_cold_experiment", "run_warm_experiment", "run_scalability_experiment")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Neither package's scaling estimate reads a cache file of this host,
    and container ids start from 0 on both sides."""
    monkeypatch.setattr(r_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(p_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(r_container, "_ids", itertools.count())
    monkeypatch.setattr(p_container, "_ids", itertools.count())


def _platforms(**kw):
    return (r_platform.ServerlessPlatform(use_fallback_calibration=True, **kw),
            p_platform.ServerlessPlatform(use_fallback_calibration=True, device="cpu", **kw))


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


def _same_report(got, want) -> None:
    _same(dataclasses.asdict(got), dataclasses.asdict(want), got.spec_name)


def _rows(recs):
    return [dataclasses.astuple(r) for r in recs]


def test_paper_tiers_equal_the_reference():
    assert p_function.PAPER_TIERS == r_function.PAPER_TIERS
    assert p_function.MEMORY_TIERS == r_function.MEMORY_TIERS
    assert set(p_function.PAPER_TIERS) <= set(p_function.MEMORY_TIERS)


@pytest.mark.parametrize("experiment", EXPERIMENTS)
@pytest.mark.parametrize("memory_mb", TIERS)
@pytest.mark.parametrize("variant", CNNS)
def test_paper_experiments_equal_the_reference(variant, memory_mb, experiment):
    ref, port = _platforms(seed=3)
    want = getattr(ref, experiment)(ref.deploy_paper_model(variant, memory_mb))
    got = getattr(port, experiment)(port.deploy_paper_model(variant, memory_mb))
    _same_report(got, want)
    assert got.summary.n > 0
    if experiment == "run_cold_experiment":
        assert got.cold_starts == 5
    if experiment == "run_warm_experiment" and memory_mb >= 1024:
        # a warm request within the burst's 1 s interval: the priming
        # request took the only cold start
        assert got.warm.n == got.summary.n and got.cold.n == 0 and got.cold_starts == 1


def _fleet(plat, side_workload):
    specs = [plat.deploy_paper_model(v, m) for v, m in zip(CNNS, TIERS)]
    trace = side_workload.multi_function_trace(
        {specs[0].name: 0.5, specs[1].name: 0.2,
         specs[2].name: lambda s: side_workload.flash_crowd(duration_s=600.0, seed=s)},
        duration_s=600.0, seed=9)
    return specs, trace


@pytest.mark.parametrize("overrides", [{}, {"keepalive_s": 60.0}, {"placement": "lru"},
                                       {"keepalive": "adaptive"}, {"max_containers": 3}],
                         ids=["default", "ttl60", "lru", "adaptive", "capped"])
def test_invoke_fleet_equals_the_reference(overrides):
    ref, port = _platforms(seed=1)
    ref_specs, ref_trace = _fleet(ref, r_workload)
    specs, trace = _fleet(port, p_workload)
    ref_recs, ref_sim = ref.invoke_fleet(ref_trace, **overrides)
    recs, sim = port.invoke_fleet(trace, **overrides)
    assert _rows(recs) == _rows(ref_recs) and len(recs) > 0
    assert (sim.cold_starts, sim.evictions) == (ref_sim.cold_starts, ref_sim.evictions)
    for spec, ref_spec in zip(specs, ref_specs):
        mine = [r for r in recs if r.fn == spec.name]
        theirs = [r for r in ref_recs if r.fn == ref_spec.name]
        _same_report(port.report(spec, mine, sim), ref.report(ref_spec, theirs, ref_sim))


SHIMS = [dict(placement="lru"), dict(keepalive="adaptive", keepalive_s=120.0),
         dict(scaling="predictive"), dict(coldstart="snapshot"),
         dict(coldstart="layered", max_containers=4), dict(concurrency=2),
         dict(keepalive_s=30.0)]


@pytest.mark.parametrize("kw", SHIMS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_per_axis_shim_equals_the_reference(kw):
    """The legacy per-axis kwargs build the same stack and the same runs."""
    ref, port = _platforms(seed=2, **kw)
    assert port.stack.to_dict() == ref.stack.to_dict()
    for experiment in ("run_cold_experiment", "run_scalability_experiment"):
        want = getattr(ref, experiment)(ref.deploy_paper_model("resnet18", 1024))
        got = getattr(port, experiment)(port.deploy_paper_model("resnet18", 1024))
        _same_report(got, want)


def test_stack_platform_equals_the_reference():
    def stack(s):
        return s.BASELINE.with_(placement="lru", coldstart="package_cache",
                                keepalive=s.KeepaliveConfig(kind="adaptive", ttl_s=200.0))
    ref = r_platform.ServerlessPlatform(use_fallback_calibration=True, stack=stack(r_stack))
    port = p_platform.ServerlessPlatform(use_fallback_calibration=True, device="cpu",
                                         stack=stack(p_stack))
    for variant in CNNS:
        _same_report(port.run_warm_experiment(port.deploy_paper_model(variant, 1536)),
                     ref.run_warm_experiment(ref.deploy_paper_model(variant, 1536)))


def test_stack_conflicts_with_per_axis_kwargs_as_in_the_reference():
    for mod, pmod, kw in ((r_platform, r_stack, {}), (p_platform, p_stack, {"device": "cpu"})):
        with pytest.raises(ValueError, match="conflict with stack="):
            mod.ServerlessPlatform(use_fallback_calibration=True, stack=pmod.BASELINE,
                                   placement="lru", **kw)
        with pytest.raises(ValueError, match="conflict with stack="):
            mod.ServerlessPlatform(use_fallback_calibration=True, stack=pmod.BASELINE,
                                   keepalive_s=60.0, **kw)


def _refusals(plat, function):
    big = function.Handler(name="big", base_cpu_seconds=1.0, package_mb=600.0)
    return {
        "tier": (ValueError, "tier", lambda: plat.deploy_paper_model("squeezenet", 1000)),
        "oom": (ValueError, "OOM", lambda: plat.deploy_paper_model("resnext50", 384)),
        "package": (ValueError, "512", lambda: plat.deploy(big, 1024)),
        "provider": (KeyError, "unknown provider",
                     lambda: plat.deploy_model("squeezenet", 1024, provider="gcf")),
        "modal_memory": (ValueError, "positive",
                         lambda: plat.deploy_model("squeezenet", 0, provider="modal_gpu")),
    }


@pytest.mark.parametrize("refusal", ["tier", "oom", "package", "provider", "modal_memory"])
def test_deploy_refuses_what_the_reference_refuses(refusal):
    ref, port = _platforms()
    for plat, function in ((ref, r_function), (port, p_function)):
        exc, match, call = _refusals(plat, function)[refusal]
        with pytest.raises(exc, match=match):
            call()
        assert plat.functions == {}


def test_a_big_package_deploys_on_modal_gpu_only():
    ref, port = _platforms()
    for plat, function in ((ref, r_function), (port, p_function)):
        big = function.Handler(name="big", base_cpu_seconds=1.0, package_mb=13800.0,
                               peak_memory_mb=512.0)
        with pytest.raises(ValueError, match="512"):
            plat.deploy(big, 1536)
        assert plat.deploy(big, 16384, provider="modal_gpu").name == "big@16384"


def test_fallback_platform_pins_no_language_model_numbers():
    """The port's one departure: with the fallback calibration a registry
    language model raises, where the reference takes its pinned CPU-host
    figures."""
    ref, port = _platforms()
    assert ref.deploy_model("deepseek-7b", 1536).handler.base_cpu_seconds > 0
    with pytest.raises(KeyError, match="no measured calibration"):
        port.deploy_model("deepseek-7b", 1536)
    assert port.functions == {}


# one measured cache entry of each shape: a small model on lambda, a 7B on a
# GPU-serverless host
CACHE = {"schema_version": 2, "host": {"backend": "cuda"}, "models": {
    "rwkv6-1.6b": {"kind": "llm", "warm_exec_s": 0.0731, "init_s": 0.81, "compile_s": 2.3,
                   "package_mb": 310.5, "tokens_per_s": 402.0, "batch_curve": []},
    "deepseek-7b": {"kind": "llm", "warm_exec_s": 0.1642, "init_s": 3.92, "compile_s": 7.61,
                    "package_mb": 13824.3, "tokens_per_s": 97.0,
                    "batch_curve": [[1, 1.0], [2, 0.58], [4, 0.33]]},
}}
LLM_DEPLOYS = [("rwkv6-1.6b", 1024, "lambda"), ("deepseek-7b", 16384, "modal_gpu"),
               ("rwkv6-1.6b", 4096, "modal_gpu")]


@pytest.mark.parametrize("name,memory_mb,provider", LLM_DEPLOYS)
def test_modern_handlers_from_one_cache_equal_the_reference(name, memory_mb, provider):
    """One v2 calibration dict, handed to both packages' ``modern_handler``:
    equal handlers, and equal reports of the three experiments and of a
    batched warm burst on the provider."""
    ref_h = r_cal.modern_handler(name, calibrated=CACHE)
    h = p_cal.modern_handler(name, calibrated=CACHE)
    assert dataclasses.asdict(h) == dataclasses.asdict(ref_h)
    ref, port = _platforms(seed=4)
    ref_spec = ref.deploy(ref_h, memory_mb, provider=provider)
    spec = port.deploy(h, memory_mb, provider=provider)
    assert spec.name == ref_spec.name
    for experiment in EXPERIMENTS:
        _same_report(getattr(port, experiment)(spec), getattr(ref, experiment)(ref_spec))
    ref_recs, ref_sim = ref.invoke(ref_spec, r_workload.warm_burst(n=40, interval_s=0.05),
                                   batching={"max_batch": 4, "max_wait_s": 0.1})
    recs, sim = port.invoke(spec, p_workload.warm_burst(n=40, interval_s=0.05),
                            batching={"max_batch": 4, "max_wait_s": 0.1})
    assert _rows(recs) == _rows(ref_recs)
    _same(sim.mitigation_cost, ref_sim.mitigation_cost)


def test_a_zero_jitter_cold_response_is_its_breakdown_plus_its_warm_response():
    """The identity ``chip_smoke.py`` checks on the card's cache entry.  On
    ``modal_gpu`` a 7B model's cold start outlasts the paper's 5 s priming
    gap, so its warm burst is all colds, as in the reference; a burst
    primed a minute ahead is served warm."""
    port = p_platform.ServerlessPlatform(use_fallback_calibration=True, device="cpu",
                                         seed=0)
    spec = port.deploy(p_cal.modern_handler("deepseek-7b", calibrated=CACHE), 16384,
                       provider="modal_gpu")
    recs, _ = port.invoke(spec, p_workload.cold_probe(), jitter=0.0)
    burst, _ = port.invoke(spec, p_workload.warm_burst(), jitter=0.0)
    assert all(r.cold for r in burst)
    primed = [p_workload.Request(0, 0.0, "prime")] + [
        p_workload.Request(1 + i, 60.0 + i, "warm") for i in range(5)]
    warm_recs, sim = port.invoke(spec, primed, jitter=0.0)
    assert sim.cold_starts == 1 and not any(r.cold for r in warm_recs)
    assert recs[0].cold and recs[0].response_s == \
        p_container.cold_start_breakdown(spec).total_s + warm_recs[0].response_s


def test_deploy_model_measures_once_and_persists(tmp_path, monkeypatch):
    """On the CPU at the smoke configs: the platform measures the paper's
    CNNs into its cache, ``deploy_model`` of a registry model measures it
    through the engine and writes it there, and a second platform on the
    same path measures nothing."""
    seen, measure = [], p_cal.measure_model

    def counted(name, **kw):
        seen.append(name)
        return measure(name, **kw)

    monkeypatch.setattr(p_cal, "measure_model", counted)
    path = str(tmp_path / "calibration_torch.json")
    first = p_platform.ServerlessPlatform(device="cpu", smoke=True, calibration_path=path)
    spec = first.deploy_model("deepseek-7b", 1536)
    assert seen == [*CNNS, "deepseek-7b"]
    assert p_cal.load_cache(path, device="cpu", smoke=True)["models"].keys() == \
        {*CNNS, "deepseek-7b"}
    second = p_platform.ServerlessPlatform(device="cpu", smoke=True, calibration_path=path)
    again = second.deploy_model("deepseek-7b", 1536)
    assert seen == [*CNNS, "deepseek-7b"]
    assert again == spec and second.functions == {spec.name: spec}
    assert second.deploy_paper_model("squeezenet", 1024).handler == \
        first.deploy_paper_model("squeezenet", 1024).handler
    report = second.run_cold_experiment(again)
    assert report.cold_starts == 5 and report.summary.mean_response_s > 0


def test_platform_defaults_to_the_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; the platform would measure on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        p_platform.ServerlessPlatform(calibration_path=str(tmp_path / "cal.json"))
    assert not (tmp_path / "cal.json").exists()
    assert p_platform.ServerlessPlatform(use_fallback_calibration=True).functions == {}
