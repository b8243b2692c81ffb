"""The decode steps' share of the bf16 peak: the useful operations of the
window's steps (active rows only, each attending its valid positions, and
the unembedding of its token) over the steps' host seconds at 989 TFLOP/s
(%).  Moves ``tpot_p95_ms``."""
from port_bench import readers


def read(run):
    return readers.mfu_of_steps(run)
