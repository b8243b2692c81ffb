"""K1 (``csrc/flash_attention.cu``) against its roofline in the profiled
stretch of the backlog cell: the least time causal attention over each
admitted prompt at its true length needs (operations at 989 TFLOP/s or bytes
at 3.35 TB/s, whichever is longer, each admission on its own) over the device
time of K1's kernels (%).  Moves ``tokens_per_s``."""
from port_bench import readers, work

KERNELS = ("flash_fwd",)     # flash_fwd (float32) and flash_fwd_mma (bf16)


def read(run):
    def least(s):
        return work.least_seconds(*work.prefill_attention(run.dims, s.lengths), run.peak)
    return readers.roofline(run, "admission", least, KERNELS)
