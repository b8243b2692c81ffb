"""K2 (``csrc/flash_decode.cu``) against its roofline in the profiled stretch
of the chat cell: the least time the decode attention of the active rows needs
(their valid keys and values read once at 3.35 TB/s, or the operations at
989 TFLOP/s, whichever is longer) over the device time of K2's kernels (%).
Moves ``tpot_p95_ms``."""
from port_bench import readers, work

KERNELS = ("decode_split", "decode_combine")


def read(run):
    def least(s):
        return work.least_seconds(*work.decode_attention(run.dims, s.rows, s.keys), run.peak)
    return readers.roofline(run, "step", least, KERNELS)
