"""The port's sim-to-real replay (``repro_torch.core.replay_real``) against
the reference's (``benchmarks/replay_real.py``), on the CPU.

Three ways: the replayability rules on every (scenario x stack) pair, the
driver with both real sides replaced by one deterministic stub (tolerance
0: the same trace, keep-alive, billing and percentile arithmetic), and the
port's real replay at the smoke config against its own calibration, within
the reference's tolerances, with every evicted container's server let go."""
import json
import math

import pytest

from benchmarks import replay_real as r_replay
from repro.core import calibration as r_cal
from repro.core import scenarios as r_scenarios
from repro.core.cluster import policies as r_policies
from repro_torch.core import calibration as p_cal
from repro_torch.core import replay_real as p_replay
from repro_torch.core import scenarios as p_scenarios
from repro_torch.core.cluster import policies as p_policies

# the reference's pinned report schema (tests/test_replay.py)
REPORT_KEYS = {"schema_version", "scenario", "stack", "scale", "n_requests",
               "model", "provider", "host", "virtual_phases", "sim", "real",
               "metrics", "tolerances", "within_tolerance"}
METRICS = ("cold_rate", "p50_s", "p95_s", "cost_per_1k")
MODEL = "deepseek-7b"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Neither package's scaling estimate reads a cache file of this host."""
    monkeypatch.setattr(r_policies, "_MEASURED_MODELS", {})
    monkeypatch.setattr(p_policies, "_MEASURED_MODELS", {})


def _raised(check, scenario, stack):
    try:
        check(scenario, stack)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------- replayability
@pytest.mark.parametrize("name", r_scenarios.names())
def test_check_replayable_equals_the_reference(name):
    r_sc, p_sc = r_scenarios.get(name), p_scenarios.get(name)
    assert list(p_scenarios.POLICY_STACKS) == list(r_scenarios.POLICY_STACKS)
    assert len(p_scenarios.POLICY_STACKS) == 18
    for stack in r_scenarios.POLICY_STACKS:
        r_stack, p_stack = (r_scenarios.POLICY_STACKS[stack],
                            p_scenarios.POLICY_STACKS[stack])
        for tuned in (False, True):
            want = _raised(r_replay._check_replayable, r_sc,
                           r_sc.tune(r_stack) if tuned else r_stack)
            got = _raised(p_replay._check_replayable, p_sc,
                          p_sc.tune(p_stack) if tuned else p_stack)
            assert got == want, (name, stack, tuned)


def test_replay_rejects_unsupported_stacks_before_any_calibration():
    """The rules fire before the calibration is read: no cache is given,
    and none is loaded or measured."""
    def refuse(*a, **kw):
        raise AssertionError("the calibration was touched")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_cal, "ensure_measured", refuse)
        with pytest.raises(ValueError, match="cannot faithfully execute"):
            p_replay.replay("gpu_serverless", stack_name="batching", device="cpu")
        with pytest.raises(ValueError, match="single-function"):
            p_replay.replay("multi_function", device="cpu")
        with pytest.raises(ValueError, match="paper CNN"):
            p_replay.replay("sparse", device="cpu")


# ------------------------------------------------------- driver parity (stub)
def _stub_container(log: list):
    """A container class standing in for both packages' ``_RealContainer``:
    deterministic construction and serve walls (the first serve of each
    container pays a capture), every call logged."""
    class Stub:
        made = 0

        def __init__(self, cfg, *, slots, max_seq, seed, **device):
            k, Stub.made = Stub.made, Stub.made + 1
            log.append(("init", cfg.name, slots, max_seq, seed))
            self.init_wall_s = 0.4 + 0.013 * k
            self.created_at = 0.0
            self.last_used_at = 0.0
            self.billed_cost = 0.0
            self.served = 0

        def serve(self, rid, prompt, n_new):
            log.append(("serve", rid, tuple(prompt), n_new))
            self.served += 1
            return (0.31 if self.served == 1 else 0.0) + 0.062 + 0.0017 * (rid % 7)

        def release(self):
            log.append(("release",))
    return Stub


@pytest.fixture(scope="module")
def reference_cache(tmp_path_factory):
    """A reference calibration file for this host holding the pinned
    deepseek-7b entry (and the paper CNNs' figures, which the reference's
    platform requires at construction), so that nothing is measured."""
    path = tmp_path_factory.mktemp("cal") / "calibration.json"
    models = {m: {"kind": "cnn", "warm_exec_s": info["fallback_s"], "first_call_s": 1.0}
              for m, info in r_cal.PAPER_MODELS.items()}
    models[MODEL] = dict(r_cal.MODERN_MODELS[MODEL]["fallback"])
    path.write_text(json.dumps({"schema_version": r_cal.SCHEMA_VERSION,
                                "host": r_cal.host_fingerprint(), "models": models}))
    return str(path)


def _pinned() -> dict:
    """The same entry as the port's cache; the reference measured it at the
    smoke configs."""
    return {"schema_version": p_cal.SCHEMA_VERSION, "host": {"configs": "smoke"},
            "models": {MODEL: dict(r_cal.MODERN_MODELS[MODEL]["fallback"])}}


def _same(a, b, where="") -> None:
    """Exact equality of nested values."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("scale", [0.02, 0.1])
@pytest.mark.parametrize("stack", ["adaptive", "baseline"])
def test_driver_equals_the_reference(monkeypatch, reference_cache, stack, scale):
    monkeypatch.setenv("REPRO_CALIBRATION", reference_cache)
    r_log, p_log = [], []
    monkeypatch.setattr(r_replay, "_RealContainer", _stub_container(r_log))
    monkeypatch.setattr(p_replay, "_RealContainer", _stub_container(p_log))
    want = r_replay.replay("gpu_serverless", stack_name=stack, scale=scale)
    got = p_replay.replay("gpu_serverless", stack_name=stack, scale=scale,
                          calibrated=_pinned(), device="cpu")
    assert set(got) == set(want) == REPORT_KEYS
    _same({k: v for k, v in got.items() if k != "host"},
          {k: v for k, v in want.items() if k != "host"})
    # the same containers built and requests served, in the same order; the
    # port lets go of each server it evicts
    assert [e for e in p_log if e[0] != "release"] == r_log
    assert sum(e[0] == "init" for e in p_log) == got["real"]["cold_starts"] >= 1
    assert sum(e[0] == "release" for e in p_log) == got["real"]["cold_starts"]
    assert got["host"] == p_cal.host_fingerprint("cpu", True)


def test_unknown_configs_refused():
    cache = _pinned()
    cache["host"] = {"configs": "the reference's pinned figures"}
    with pytest.raises(ValueError, match="configs"):
        p_replay.replay("gpu_serverless", scale=0.02, calibrated=cache, device="cpu")


# -------------------------------------------------------- the real CPU replay
@pytest.fixture(scope="module")
def smoke_cache(tmp_path_factory):
    """The port's own calibration of deepseek-7b's smoke config on the CPU,
    measured by the replay's load-or-measure route."""
    path = str(tmp_path_factory.mktemp("cal_torch") / "calibration_torch.json")
    cache = p_cal.ensure_measured(None, MODEL, path, smoke=True, device="cpu")
    assert cache["host"] == p_cal.host_fingerprint("cpu", True)
    return path


def test_real_cpu_replay_within_tolerance(smoke_cache, tmp_path, capsys):
    out = tmp_path / "replay_report_torch.json"

    def refuse(*a, **kw):
        raise AssertionError("the cache at --path holds the model; nothing to measure")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_cal, "measure_model", refuse)
        rc = p_replay.main(["--scenario", "gpu_serverless", "--scale", "0.02",
                            "--device", "cpu", "--smoke", "--path", smoke_cache,
                            "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and "within_tolerance=True" in capsys.readouterr().out
    assert set(report) == REPORT_KEYS
    assert report["schema_version"] == 1 and report["stack"] == "adaptive"
    assert report["model"] == MODEL and report["provider"] == "modal_gpu"
    assert report["host"] == p_cal.host_fingerprint("cpu", True)
    assert set(report["metrics"]) == set(METRICS)
    assert report["n_requests"] > 0 and report["real"]["n"] == report["sim"]["n"]
    for name, m in report["metrics"].items():
        assert set(m) == {"sim", "real", "abs_err", "rel_err", "within"}
        for k in ("sim", "real", "abs_err", "rel_err"):
            assert math.isfinite(m[k]), f"{name}.{k} not finite"
    assert report["tolerances"] == r_replay.TOLERANCES == p_replay.TOLERANCES
    assert report["within_tolerance"] is True
    vp = report["virtual_phases"]
    assert vp["provision_s"] == 6.5 and vp["network_overhead_s"] == 0.09


def test_evicted_containers_let_go_of_their_servers(smoke_cache, monkeypatch):
    """A baseline replay with several colds: at each cold no other container
    holds a server, and after the run none does."""
    made = []

    class Watched(p_replay._RealContainer):
        def __init__(self, *a, **kw):
            assert all(c.server is None for c in made), "a retired server is still held"
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(p_replay, "_RealContainer", Watched)
    report = p_replay.replay("gpu_serverless", stack_name="baseline", scale=0.1,
                             path=smoke_cache, device="cpu", smoke=True)
    assert len(made) == report["real"]["cold_starts"] >= 5
    assert all(c.server is None for c in made)
    assert all(c.evicted_at >= c.created_at for c in made)
    assert report["within_tolerance"] is True
