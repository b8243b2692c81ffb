"""Prompt tokens admitted plus tokens served inside the window, over its
seconds; padding not counted (tokens/s)."""
from port_bench import stats


def read(run):
    return stats.tokens_per_s(run.window)
