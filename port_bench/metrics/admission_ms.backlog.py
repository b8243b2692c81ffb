"""Mean host milliseconds of a ``prefill_pending()`` call that admitted, in the
backlog cell (long prompts at four slots).  Moves ``tokens_per_s``."""
from port_bench import readers


def read(run):
    return readers.mean_ms(run, "admission")
