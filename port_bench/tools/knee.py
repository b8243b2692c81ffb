"""The sweep that found a cell's knee: one server, a window at each of
several offered rates, and whether completions kept pace.

    python3 port_bench/tools/knee.py --workload deepseek-7b.chat-open \
        --seed <n> --seconds 30 --rates 3 4 5 6

For each rate it prints one JSON line: the rate offered in the window, the
rate completed in it, the requests waiting at the close, the time to first
token's median and 95th percentile and the time per output token's 95th.
Between rates the queue is dropped and the slots drained.  The knee is the
highest rate whose completions keep pace with its arrivals and whose queue at
the close holds no more than the slot count.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2]),
                str(Path(__file__).resolve().parents[2] / "src")]

from port_bench import cell as cell_mod, stats  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    cell = cell_mod.load_cell(args.workload)
    items = {rate: cell_mod.schedule(cell, args.seed, args.seconds, rate) for rate in args.rates}
    _, server = cell_mod.build(cell, args.seed, "cuda:0", sum(items.values(), []))
    for rate in args.rates:
        server.out.clear()
        win, _ = cell_mod.serve(cell, server, args.seed, items[rate], args.seconds)
        due = stats.due_in_window(win)
        waiting = sum(1 for r in win.records if r.submitted is not None
                      and (r.first is None or r.first > win.end))
        done = sum(1 for r in due if r.finished and r.last <= win.end)
        ttft = stats.ttft(win)
        admissions = [s for s in win.spans if s.kind == "admission" and s.rows]
        print(json.dumps({
            "rate": rate, "offered_rps": len(due) / win.seconds,
            "completed_rps": done / win.seconds, "waiting_at_close": waiting,
            "ttft_p50_s": stats.percentile(ttft, 50), "ttft_p95_s": stats.percentile(ttft, 95),
            "tpot_p95_ms": 1e3 * stats.percentile(stats.tpot(win), 95),
            "tokens_per_s": stats.tokens_per_s(win),
            "admitted_per_round": sum(s.rows for s in admissions) / max(len(admissions), 1),
            "late_max_s": max(win.lateness(), default=0.0)}), flush=True)
        server.queue.clear()
        while server.n_active():
            server.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
