"""The readings a cell's correctness limit is set from, on the card at the
cell's own size: for each seed, the program's widest logit gap over a window's
sample, and the control's (the reference in fp8, ``reference/<family>.py``)
on the same prompts and served tokens.

    python3 port_bench/tools/limits.py --workload <cell> --seconds 20 --seeds <n> ...

One JSON line a seed.  The lower reading is the largest program gap over the
seeds; the upper the smallest control gap.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from port_bench import cell as cell_mod  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = cell_mod.load_cell(args.workload)
    dev = "cuda:0"
    for seed in args.seeds:
        t = time.perf_counter()
        items = cell_mod.schedule(cell, seed, args.seconds)
        weights, server = cell_mod.build(cell, seed, dev, items)
        win, prompts = cell_mod.serve(cell, server, seed, items, args.seconds)
        served = cell_mod.served_tokens(server, win)
        del server, weights
        cell_mod.free(dev)
        res = cell_mod.judge(cell, win, prompts, served, seed, dev, control=True)
        cell_mod.free(dev)
        print(json.dumps({"seed": seed, "widest_gap": res["widest_gap"],
                          "control_gap": res["control_gap"], "requests": res["requests"],
                          "tokens": res["tokens"], "short_answers": res["short_answers"],
                          "per_request": res["per_request"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
