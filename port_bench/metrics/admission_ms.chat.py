"""Mean host milliseconds of a ``prefill_pending()`` call that admitted, in the
chat cell: the slot-padded bucketed admission prefill, the scatter into the
slots and the first tokens' copy to the host.  Moves ``ttft_p95_s``."""
from port_bench import readers


def read(run):
    return readers.mean_ms(run, "admission")
