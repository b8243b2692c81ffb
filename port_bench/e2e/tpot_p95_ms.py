"""95th percentile of (last token - first token) / (output tokens - 1) over
the requests due in the window (ms)."""
from port_bench import stats


def read(run):
    p = stats.percentile(stats.tpot(run.window), 95)
    return None if p is None else 1e3 * p
