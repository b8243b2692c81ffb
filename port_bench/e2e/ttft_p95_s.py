"""95th percentile of the time from a request falling due to its first token
on the host, over every request due in the window (s)."""
from port_bench import stats


def read(run):
    return stats.percentile(stats.ttft(run.window), 95)
