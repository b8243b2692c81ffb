"""The port's calibration bridge against the reference's, on the CPU: the
batch-curve helpers, the v2 cache the port writes (smoke configs, CNN at
64 px), the refusal rules of both packages' ``load_cache``, and the handlers
the reference's simulator builds from the port's file."""
import dataclasses
import json

import pytest

from repro.core import calibration as ref_cal
from repro.core import function as ref_function
from repro.serving import handler as ref_handler
from repro_torch.configs import deepseek_7b
from repro_torch.core import calibration as cal
from repro_torch.core import function
from repro_torch.serving import handler

CNN_FIELDS = {"kind", "warm_exec_s", "first_call_s"}
LLM_FIELDS = {"kind", "warm_exec_s", "init_s", "compile_s", "package_mb", "tokens_per_s",
              "batch_curve"}


@pytest.fixture(scope="module")
def port_cache(tmp_path_factory):
    """(path, cache) of one smoke calibration on the CPU."""
    path = str(tmp_path_factory.mktemp("cal") / "calibration_torch.json")
    cache = cal.calibrate(path, models=["squeezenet", "deepseek-7b"], smoke=True,
                          device="cpu")
    return path, cache


def _fields(h) -> dict:
    d = dataclasses.asdict(h)
    d.pop("run")
    return d


# ----------------------------------------------------------------------
# the batch-efficiency curve
# ----------------------------------------------------------------------

CURVES = [
    [(1, 2.0), (2, 1.0), (4, 0.6)],
    [(4, 0.3), (2, 0.5)],                 # no batch-1 point, unsorted
    [(1, 1.0), (2, 1.3), (8, 0.2)],       # a noisy rise is clamped
    [(2, 0.5), (2, 0.4), (16, 0.1)],      # duplicate batch: the last wins
    [],
]


@pytest.mark.parametrize("points", CURVES)
def test_normalize_batch_curve_equals_the_reference(points):
    assert function.normalize_batch_curve(points) == ref_function.normalize_batch_curve(points)


@pytest.mark.parametrize("points", [[(0, 1.0)], [(2, 0.0)], [(1, float("nan"))]])
def test_normalize_batch_curve_refuses_what_the_reference_refuses(points):
    with pytest.raises(ValueError):
        ref_function.normalize_batch_curve(points)
    with pytest.raises(ValueError):
        function.normalize_batch_curve(points)


@pytest.mark.parametrize("points", CURVES)
def test_batch_rel_cost_equals_the_reference(points):
    curve = function.normalize_batch_curve(points)
    for b in range(0, 20):
        assert function.batch_rel_cost(curve, b) == ref_function.batch_rel_cost(curve, b)


def test_handler_has_the_reference_fields():
    assert ([(f.name, f.default) for f in dataclasses.fields(function.Handler)] ==
            [(f.name, f.default) for f in dataclasses.fields(ref_function.Handler)])


# ----------------------------------------------------------------------
# the cache
# ----------------------------------------------------------------------

def test_port_cache_has_the_v2_fields(port_cache):
    path, cache = port_cache
    with open(path) as f:
        assert json.load(f) == cache
    assert cache["schema_version"] == ref_cal.SCHEMA_VERSION == 2
    assert cache["host"] == cal.host_fingerprint("cpu", smoke=True)
    assert cache["host"]["backend"] == "cpu" and cache["host"]["configs"] == "smoke"
    cnn, llm = cache["models"]["squeezenet"], cache["models"]["deepseek-7b"]
    assert set(cnn) == CNN_FIELDS and cnn["kind"] == "cnn"
    assert set(llm) == LLM_FIELDS and llm["kind"] == "llm"
    for key in ("warm_exec_s", "first_call_s"):
        assert cnn[key] > 0
    for key in ("warm_exec_s", "init_s", "compile_s", "package_mb", "tokens_per_s"):
        assert llm[key] > 0
    curve = llm["batch_curve"]
    assert [b for b, _ in curve] == [1, 2, 4] and curve[0][1] == 1.0
    assert all(r1 >= r2 > 0 for (_, r1), (_, r2) in zip(curve, curve[1:]))


def test_reference_load_cache_refuses_the_port_cache_unless_lax(port_cache):
    path, cache = port_cache
    assert ref_cal.load_cache(path, strict=True) is None
    assert ref_cal.load_cache(path, strict=False) == cache


def test_port_load_cache_takes_its_own_and_refuses_another_scale(port_cache):
    path, cache = port_cache
    assert cal.load_cache(path, device="cpu", smoke=True) == cache
    assert cal.load_cache(path, device="cpu", smoke=False) is None
    assert cal.load_cache(path, strict=False) == cache


def test_port_load_cache_refuses_a_reference_cache(tmp_path):
    path = str(tmp_path / "calibration.json")
    ref = ref_cal.new_cache()
    ref["models"]["squeezenet"] = {"kind": "cnn", "warm_exec_s": 0.5, "first_call_s": 1.0}
    ref_cal.save_cache(ref, path)
    assert cal.load_cache(path, device="cpu", smoke=True) is None
    assert cal.load_cache(path, device="cpu") is None


@pytest.mark.parametrize("content", [
    {"schema_version": 1, "models": {}},
    {"models": {}},
    {"schema_version": 2, "models": []},
    "not json {",
])
def test_port_load_cache_refuses_a_wrong_schema_or_a_corrupt_file(tmp_path, content):
    path = tmp_path / "cal.json"
    if isinstance(content, dict):
        content = dict(content, host=cal.host_fingerprint("cpu", smoke=True))
        path.write_text(json.dumps(content))
    else:
        path.write_text(content)
    assert cal.load_cache(str(path), device="cpu", smoke=True) is None
    assert cal.load_cache(str(tmp_path / "missing.json"), device="cpu") is None


def test_calibrate_keeps_what_it_has_and_measures_what_is_missing(port_cache, tmp_path,
                                                                  monkeypatch):
    path, cache = port_cache
    copy = str(tmp_path / "cal.json")
    cal.save_cache(cache, copy)
    calls = []

    def fake(name, **kw):
        calls.append((name, kw))
        return {"kind": "cnn", "warm_exec_s": 0.5, "first_call_s": 1.0}

    monkeypatch.setattr(cal, "measure_model", fake)
    again = cal.calibrate(copy, models=["squeezenet", "resnet18"], smoke=True, device="cpu")
    assert calls == [("resnet18", {"smoke": True, "device": "cpu"})]
    assert again["models"]["squeezenet"] == cache["models"]["squeezenet"]
    assert cal.load_cache(copy, device="cpu", smoke=True) == again
    calls.clear()
    cal.calibrate(copy, force=True, models=["squeezenet"], smoke=True, device="cpu")
    assert [n for n, _ in calls] == ["squeezenet"]


def test_ensure_measured_measures_and_persists_what_is_missing(tmp_path, monkeypatch):
    path = str(tmp_path / "cal.json")
    calls = []

    def fake(name, **kw):
        calls.append(name)
        return {"kind": "cnn", "warm_exec_s": 0.5, "first_call_s": 1.0}

    monkeypatch.setattr(cal, "measure_model", fake)
    cache = cal.ensure_measured(None, "resnet18", path, smoke=True, device="cpu")
    assert calls == ["resnet18"] and cal.load_cache(path, device="cpu", smoke=True) == cache
    assert cal.ensure_measured(cache, "resnet18", path, smoke=True, device="cpu") is cache
    assert calls == ["resnet18"]


def test_default_path_is_the_ports_own():
    assert cal.default_cal_path().endswith("artifacts/calibration_torch.json")
    assert cal.default_cal_path() != ref_cal.default_cal_path()


def test_cli_measures_into_the_given_path(tmp_path, capsys):
    path = tmp_path / "cal.json"
    assert cal.main(["--models", "squeezenet", "--smoke", "--device", "cpu",
                     "--path", str(path)]) == 0
    entry = json.loads(path.read_text())["models"]["squeezenet"]
    assert set(entry) == CNN_FIELDS
    assert "squeezenet" in capsys.readouterr().out


# ----------------------------------------------------------------------
# the handlers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["squeezenet", "resnet18"])   # measured, not measured
@pytest.mark.parametrize("use_fallback", [False, True])
def test_reference_paper_handler_takes_the_port_cache(port_cache, variant, use_fallback):
    _, cache = port_cache
    ours = cal.paper_handler(variant, calibrated=cache, use_fallback=use_fallback)
    ref = ref_cal.paper_handler(variant, calibrated=cache, use_fallback=use_fallback)
    assert _fields(ours) == _fields(ref)
    if variant == "squeezenet" and not use_fallback:
        assert ours.base_cpu_seconds == cache["models"]["squeezenet"]["warm_exec_s"]


def test_reference_modern_handler_takes_the_port_cache(port_cache):
    _, cache = port_cache
    ours = cal.modern_handler("deepseek-7b", calibrated=cache)
    assert _fields(ours) == _fields(ref_cal.modern_handler("deepseek-7b", calibrated=cache))
    entry = cache["models"]["deepseek-7b"]
    assert ours.load_cpu_seconds == entry["init_s"] + entry["compile_s"]
    assert ours.batch_curve == tuple((b, r) for b, r in entry["batch_curve"])


def test_moe_entry_has_a_batch_curve_and_feeds_the_reference_handler(tmp_path):
    """A MoE model is measured as the reference measures dense, moe and vlm:
    the engine, then the continuous server's batch curve."""
    name = "granite-moe-3b-a800m"
    cache = cal.calibrate(str(tmp_path / "cal.json"), models=[name], smoke=True,
                          device="cpu")
    entry = cache["models"][name]
    assert set(entry) == LLM_FIELDS and entry["kind"] == "llm"
    assert [b for b, _ in entry["batch_curve"]] == [1, 2, 4]
    assert entry["batch_curve"][0] == [1, 1.0]
    ours = cal.modern_handler(name, calibrated=cache)
    assert _fields(ours) == _fields(ref_cal.modern_handler(name, calibrated=cache))
    assert ours.batch_curve == tuple((b, r) for b, r in entry["batch_curve"])


def test_declared_peak_memory_equals_the_references():
    assert cal.MODERN_PEAK_MB == {n: m["peak_mb"] for n, m in ref_cal.MODERN_MODELS.items()}


def test_port_modern_handler_needs_a_measured_entry(port_cache):
    _, cache = port_cache
    with pytest.raises(KeyError, match="measure it first"):
        cal.modern_handler("rwkv6-1.6b", calibrated=cache)
    with pytest.raises(KeyError, match="measure it first"):
        cal.modern_handler("deepseek-7b")


def test_llm_handler_equals_the_reference_on_the_same_measurements():
    measured = {"load_s": 1.5, "compile_s": 0.25, "serve_batch_s": 0.03,
                "tokens_per_s": 900.0, "package_mb": 13800.0}
    cfg = deepseek_7b.CONFIG
    ours = handler.llm_handler(cfg, measured)
    ref = ref_handler.llm_handler(cfg, measured)
    assert _fields(ours) == _fields(ref)
    assert ours.package_mb == 510.0


def test_measure_engine_feeds_llm_handler_on_the_cpu():
    m = handler.measure_engine(deepseek_7b.SMOKE, device="cpu")
    assert m["engine"].device.type == "cpu"
    for key in ("load_s", "compile_s", "serve_batch_s", "tokens_per_s", "package_mb"):
        assert m[key] > 0
    h = handler.llm_handler(deepseek_7b.SMOKE, m)
    assert h.base_cpu_seconds == m["serve_batch_s"]
    assert h.load_cpu_seconds == m["load_s"] + m["compile_s"]
