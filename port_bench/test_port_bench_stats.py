"""The end-to-end arithmetic on hand-made timestamps, with a request still
open at the window's close and one that never got its first token."""
import pytest

from port_bench import stats
from port_bench.loop import Record, Span, Window


def window():
    recs = [
        Record(0, due=9.0, prompt_len=10, n_new=3, submitted=9.0, first=9.5, last=9.9, tokens=3),   # before the window
        Record(1, due=10.0, prompt_len=10, n_new=5, submitted=10.0, first=10.2, last=10.6, tokens=5),
        Record(2, due=11.0, prompt_len=20, n_new=4, submitted=11.1, first=11.5, last=11.8, tokens=4),
        Record(3, due=12.0, prompt_len=30, n_new=9, submitted=12.0, first=12.4, last=13.0, tokens=4),  # open at the close
        Record(4, due=13.5, prompt_len=40, n_new=6, submitted=13.5),                                    # never admitted
    ]
    win = Window(10.0, 14.0, recs)
    win.spans = [
        Span("admission", 9.4, 9.5, 1, lengths=(10,), tokens=1),              # before: not counted
        Span("admission", 10.1, 10.2, 1, lengths=(10,), tokens=1),
        Span("step", 10.2, 10.6, 2, keys=30, tokens=6),
        Span("admission", 11.3, 11.5, 1, lengths=(20,), tokens=1),
        Span("admission", 12.3, 12.4, 1, lengths=(30,), tokens=1),
        Span("step", 12.4, 13.0, 2, keys=70, tokens=5),
        Span("step", 13.9, 14.2, 1, keys=34, tokens=1),                      # returns after the close
    ]
    return win


def test_ttft_counts_due_requests_and_the_age_of_one_never_served():
    got = stats.ttft(window())
    assert got == pytest.approx([0.2, 0.5, 0.4, 0.5])


def test_tpot_counts_an_open_request_up_to_the_close():
    got = stats.tpot(window())
    assert got == pytest.approx([0.4 / 4, 0.3 / 3, (14.0 - 12.4) / 3])


def test_tokens_per_s_counts_prompts_and_tokens_inside_the_window():
    assert stats.tokens_per_s(window()) == pytest.approx((10 + 1 + 6 + 20 + 1 + 30 + 1 + 5) / 4.0)


def test_percentile_interpolates_and_is_none_on_nothing():
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)
    assert stats.percentile([], 95) is None


def test_spread_is_the_quartiles_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx((5.25 - 1.75) / 3.5)


def test_lateness_of_requests_due_in_the_window():
    assert window().lateness() == pytest.approx([0.0, 0.1, 0.0, 0.0])
