"""The reduction of a profiled stretch, on a hand-made Chrome trace."""
import pytest

from port_bench.trace import reduce_events


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("bench.stretch", "user_annotation", 1000.0, 100.0),
    ev("bench.step", "user_annotation", 1000.0, 40.0),
    ev("bench.admission", "user_annotation", 50_000.0, 10.0),     # outside: ignored
    ev("bench.admission", "user_annotation", 1050.0, 40.0),
    ev("void decode_split<bf16, 8>(...)", "kernel", 1005.0, 10.0),
    ev("void decode_combine<bf16>(...)", "kernel", 1012.0, 5.0),   # overlaps the last
    ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1030.0, 2.0),
    ev("void flash_fwd_mma<128>(...)", "kernel", 1060.0, 20.0),
    ev("void flash_fwd_mma<128>(...)", "kernel", 1095.0, 10.0),    # runs past the stretch's end
    ev("cudaGraphLaunch", "cuda_runtime", 1004.0, 1.0),
]


def test_busy_idle_and_names():
    s = reduce_events(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((12 + 2 + 20 + 5) * 1e-6)
    assert s.seconds_of(("decode_split", "decode_combine")) == pytest.approx(15e-6)
    assert s.seconds_of(("flash_fwd",)) == pytest.approx(25e-6)
    # idle: 1000-1005, 1017-1030 and 1032-1040 in the step; 1040-1050 and
    # 1090-1095 between calls; 1050-1060 and 1080-1090 in the admission
    assert s.idle_by_host["bench.step"] == pytest.approx(26e-6)
    assert s.idle_by_host["bench.loop"] == pytest.approx(15e-6)
    assert s.idle_by_host["bench.admission"] == pytest.approx(20e-6)
    assert s.longest_idle[0] == (pytest.approx(28e-6), "bench.loop")
    b = s.breakdown()
    assert b["device_ops"][0][0].startswith("void flash_fwd_mma")
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) == 3


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(ValueError):
        reduce_events(EVENTS[1:])
