"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``src/repro_torch``: it builds the
cell's model and ``ContinuousServer`` from the seed, warms up every shape the
cell's traffic uses (set-up, ``setup_s``), serves the traffic for
``--seconds``, checks the served tokens against the plain reference, and
prints ``{"correct", "attempted", "failed", "metrics", "device", ...}`` as the
last line of standard output; with ``--trace 1`` the per-layer metrics of a
profiled stretch, else the end-to-end metrics.  It exits non-zero, printing
no result, without enough CUDA devices, or when JAX or the JAX package is
loaded.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The top-level names of JAX's or the JAX package's among ``names``
    (the modules loaded in this process), whole names compared."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch
    from port_bench import cell as cell_mod
    cell_mod.say(f"import torch {time.perf_counter() - STARTED:.3f} s")

    cell = cell_mod.load_cell(args.workload)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[port_bench] {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the port; fails where the checkout lacks it)
    t = time.perf_counter()
    torch.zeros(1, device="cuda:0")
    torch.cuda.synchronize()
    cell_mod.say(f"CUDA context {time.perf_counter() - t:.3f} s")
    line = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"[port_bench] loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
