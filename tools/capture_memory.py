#!/usr/bin/env python3
"""What servers built, captured and dropped in turn leave on the card.

    python3 tools/capture_memory.py [--servers 40] [--arch deepseek-7b]

Builds ``--servers`` continuous servers of the arch's smoke config one after
another, each seeding its own weights, draining four requests (which
captures its admission prefill and its decode step) and dropped, as the
colds of ``repro_torch.core.replay_real`` are, and prints the card's
allocated memory after each, nothing freed in between.  Twice: with each
capture's warm-up on the device's one warm-up stream
(``serving/graphs.py::warm_up_stream``, the tree's), then on a new
``torch.cuda.Stream`` a capture, as the port did before.  cuBLAS keeps a
workspace for every stream it has run on; torch hands out new streams from
a pool of 32 a device and priority, round robin, so whether the second
mode's growth stops there shows after 32 streams.  Then it frees cuBLAS's
workspaces and prints what that freed.  Prints the card's name and power
limit, a line per mode and a JSON summary last; exits 1 if the first
mode's memory after its last server exceeds that after its first by more
than 64 MiB.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

GROWTH_BYTES = 64 * 2**20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--servers", type=int, default=40)
    ap.add_argument("--arch", default="deepseek-7b")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("capture_memory: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get
    from repro_torch.serving import graphs
    from repro_torch.serving.continuous import ContinuousServer, Request

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = get(args.arch).smoke
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 40))).tolist(), 5)
            for i in range(4)]

    def run(mode: str) -> list:
        after = []
        for seed in range(args.servers):
            srv = ContinuousServer(cfg, slots=2, max_seq=64, seed=seed, device=dev)
            for rid, prompt, n in reqs:
                srv.submit(Request(rid=rid, prompt=prompt, n_new=n))
            srv.run()
            del srv
            torch.cuda.synchronize()
            after.append(torch.cuda.memory_allocated(dev))
        held = after[-1]
        torch._C._cuda_clearCublasWorkspaces()
        freed = held - torch.cuda.memory_allocated(dev)
        mib = [a / 2**20 for a in after]
        print(f"[{mode}] allocated MiB after each of {args.servers} servers: "
              + " ".join(f"{m:.1f}" for m in mib)
              + f"; last - first {mib[-1] - mib[0]:.1f} MiB; the clear of cuBLAS's "
              f"workspaces then freed {freed / 2**20:.1f} MiB ({card})", flush=True)
        return after, freed

    kept, kept_freed = run("one warm-up stream")
    with mock.patch.object(graphs, "warm_up_stream", lambda device: torch.cuda.Stream(device)):
        fresh, fresh_freed = run("a new stream a capture")
    steps = [b - a for a, b in zip(fresh, fresh[1:])]
    grew = [i + 2 for i, d in enumerate(steps) if d > 0]
    summary = {"card": card, "arch": cfg.name, "servers": args.servers,
               "kept_growth_mib": (kept[-1] - kept[0]) / 2**20,
               "kept_cleared_mib": kept_freed / 2**20,
               "fresh_growth_mib": (fresh[-1] - fresh[0]) / 2**20,
               "fresh_cleared_mib": fresh_freed / 2**20,
               "fresh_last_server_that_grew": grew[-1] if grew else None}
    print(json.dumps(summary))
    return 0 if kept[-1] - kept[0] <= GROWTH_BYTES else 1


if __name__ == "__main__":
    sys.exit(main())
