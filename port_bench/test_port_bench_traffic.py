"""The seeded traffic: the same seed gives the same schedule and prompts,
every seed the same requests (the open loop's in another order), and the
open loop's arrivals a Poisson process."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from port_bench import traffic

HERE = Path(__file__).resolve().parent
MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_schedule_and_prompts(name):
    t = mix(name)
    a = traffic.schedule(t, 2 ** 31 + 11, 20.0)
    b = traffic.schedule(t, 2 ** 31 + 11, 20.0)
    assert a == b
    assert traffic.prompts(a[:20], 1000, 2 ** 31 + 11) == traffic.prompts(b[:20], 1000, 2 ** 31 + 11)
    c = traffic.schedule(t, 2 ** 31 + 12, 20.0)
    # the open loop's window is rotated by the seed; a backlog's order is the
    # same for every seed, whose prompts differ
    assert (a != c) == (t["driver"] == "open")
    assert traffic.prompts(a[:20], 1000, 2 ** 31 + 11) != traffic.prompts(a[:20], 1000, 2 ** 31 + 12)


def test_every_backlog_block_holds_the_same_sizes():
    t = mix("docs-backlog")
    block = t["block"]
    for seed in (0, 7, 2 ** 33 + 5):
        items = traffic.schedule(t, seed, 40.0)
        for k in range(0, len(items) // block * block, block):
            got = items[k:k + block]
            assert Counter(i.prompt_len for i in got) == Counter(traffic.lengths(t["prompt"], block).tolist())
            assert Counter(i.n_new for i in got) == Counter(traffic.lengths(t["output"], block).tolist())


def _cycle(items, lead, seconds):
    """The window's requests as a cycle: (prompt, output, gap to the next,
    the last one's gap wrapping round to the first)."""
    win = [i for i in items if i.due >= lead]
    dues = [i.due for i in win] + [win[0].due + seconds]
    return [(i.prompt_len, i.n_new, round(dues[k + 1] - dues[k], 9)) for k, i in enumerate(win)]


def test_every_seed_is_offered_the_same_window_in_another_order():
    t = mix("chat-open")
    runs = [traffic.schedule(t, seed, 50.0) for seed in (0, 7, 2 ** 33 + 5)]
    lead = [[i for i in items if i.due < t["lead_in_s"]] for items in runs]
    assert lead[0] == lead[1] == lead[2]
    cycles = [_cycle(items, t["lead_in_s"], 50.0) for items in runs]
    assert cycles[0] != cycles[1]
    # one rotation of the other: the same requests with the same gaps, but
    # for the one gap the rotation splits or joins
    n = len(cycles[0])
    assert all(len(c) == n for c in cycles)
    for c in cycles[1:]:
        doubled = cycles[0] + cycles[0]
        best = max(sum(a == b for a, b in zip(doubled[k:k + n], c)) for k in range(n))
        assert best >= n - 2
        assert sorted(x[:2] for x in c) == sorted(x[:2] for x in cycles[0])


@pytest.mark.parametrize("name", MIXES)
def test_sizes_stay_inside_the_mix_and_the_cache(name):
    t = mix(name)
    for i in traffic.schedule(t, 3, 50.0):
        assert t["prompt"]["min"] <= i.prompt_len <= t["prompt"]["max"]
        assert i.prompt_len + i.n_new < t["max_seq"] - 1


def test_open_loop_rate_and_horizon():
    t = mix("chat-open")
    items = traffic.schedule(t, 5, 50.0)
    dues = np.array([i.due for i in items])
    assert np.all(np.diff(dues) >= 0) and dues[0] >= 0 and dues[-1] < t["lead_in_s"] + 50.0
    horizon = t["lead_in_s"] + 50.0
    assert abs(len(items) - t["rate_rps"] * horizon) < 4 * (t["rate_rps"] * horizon) ** 0.5
    long_lead = {**t, "lead_in_s": 60.0}   # unrotated: one draw, scaled by the rate
    base = [i for i in traffic.schedule(long_lead, 5, 1.0) if i.due < 60.0]
    double = traffic.schedule(long_lead, 5, 1.0, rate=2 * t["rate_rps"])
    assert [i.due / 2 for i in base[:50]] == pytest.approx([i.due for i in double[:50]], rel=1e-12)
    assert [(i.prompt_len, i.n_new) for i in base] == [(i.prompt_len, i.n_new) for i in double[:len(base)]]


def test_open_loop_arrivals_are_poisson_not_smoothed():
    rng = np.random.default_rng(11)
    gaps = np.diff([0.0] + traffic.poisson(4.0, 2000.0, rng))
    assert gaps.mean() == pytest.approx(0.25, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.06)   # exponential gaps
    # counts over 8 s windows swing as a Poisson count does (variance = mean)
    counts = np.histogram(np.cumsum(gaps), bins=np.arange(0.0, 2000.0, 8.0))[0]
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.25)


def test_the_poisson_copy_draws_what_the_programs_generator_draws():
    from repro_torch.core.workload import poisson
    for seed in (0, 3, 2 ** 40 + 1):
        ours = traffic.poisson(3.5, 60.0, np.random.default_rng(seed))
        assert ours == [r.arrival_s for r in poisson(3.5, 60.0, seed)]


def test_backlog_all_due_at_start():
    t = mix("docs-backlog")
    items = traffic.schedule(t, 3, 50.0)
    assert len(items) == t["requests"] and all(i.due == 0.0 for i in items)


def test_prompt_ids_cover_the_vocabulary_range():
    items = traffic.schedule(mix("chat-open"), 9, 10.0)
    ids = np.concatenate([np.array(p) for p in traffic.prompts(items, 102400, 9)])
    assert ids.min() >= 0 and ids.max() < 102400 and ids.max() > 90000


def test_buckets_reach_the_programs_buckets():
    from repro_torch.serving.engine import bucket_len
    for name, want in (("chat-open", [32, 64, 128, 256, 512]), ("docs-backlog", [512, 1024, 2048])):
        t = mix(name)
        assert traffic.buckets(t, traffic.schedule(t, 3, 50.0), bucket_len) == want
