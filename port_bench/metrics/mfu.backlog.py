"""The whole window's share of the bf16 peak: the useful operations of every
prompt admitted (at its true length) and every token decoded, over the
window's seconds at 989 TFLOP/s (%).  Moves ``tokens_per_s``."""
from port_bench import readers


def read(run):
    return readers.mfu_of_window(run)
