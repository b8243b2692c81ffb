"""Mean host milliseconds of a ``step()`` call in the chat cell: one decode
step of every slot and its tokens' copy to the host.  Moves ``tpot_p95_ms``."""
from port_bench import readers


def read(run):
    return readers.mean_ms(run, "step")
