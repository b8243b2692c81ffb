#!/usr/bin/env python3
"""Repeat a full-width engine's replayed greedy decoding on the card and
compare every run with the first, bit for bit.

    python3 tools/replay_determinism.py [--rounds 10] [--runs 8] [--src src]
        [--smoke --device cpu]

Each round seeds a new mistral-nemo-12b engine (the one whose check failed
once in a full run) as ``chip_smoke.py``'s engine phase does
(seed 0, bf16, ``max_cache`` 256; batch 4, prompt 100 in bucket 128, 32 new
tokens): first the uncaptured prefill and greedy tokens (the steps run
eagerly on the card), then the replayed prefill and the decode step's
capture, in the order of ``chip_smoke.py``'s ``prefill_check`` and first
``generate``, then ``--runs`` calls of ``generate``, each a replay of the
captured prefill and decode graphs.  Every run is compared with the
round's first run: its tokens, the replayed prefill's logits, the logits of
each decode step and the KV cache after the run; and its tokens with the
uncaptured path's.  The decode step's logits are recorded by the captured
step itself: ``api.decode_step`` is wrapped, while the step is captured, by
a copy of its logits into a static buffer at a row that the step advances
on the device.

``--src`` imports the port from another checkout's ``src`` (a parent
commit's, unpacked with ``git archive``), so that two trees are compared
with one script.  ``--smoke --device cpu`` runs the arch's smoke config on
the CPU, where the steps run eagerly (a check of the script itself).
Prints a line per round and a JSON summary last; exits 1 if any run
differs.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ARCH, N_NEW = "mistral-nemo-12b", 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("replay_determinism: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get
    from repro_torch.models import api
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import InferenceEngine

    card = "cpu" if dev.type == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; port from {args.src}", flush=True)
    spec = get(ARCH)
    cfg = spec.smoke if args.smoke else spec.config
    prompts = torch.randint(0, cfg.vocab_size, (4, 100),
                            generator=torch.Generator().manual_seed(2))
    decode_step = api.decode_step
    differ = {"tokens": 0, "uncaptured tokens": 0, "prefill logits": 0, "step logits": 0,
              "cache": 0}
    first_diffs = []
    for rnd in range(args.rounds):
        t0 = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        eng = InferenceEngine(cfg, seed=0, max_cache=256, device=dev)
        step_logits = torch.zeros((N_NEW, 4, cfg.vocab_size), dtype=cfg.cdt, device=dev)
        row = torch.zeros((1,), dtype=torch.long, device=dev)

        def recorded(*a, **kw):
            logits, cache = decode_step(*a, **kw)
            step_logits.index_copy_(0, row, logits[None].to(step_logits.dtype))
            row.add_(1)
            return logits, cache

        with mock.patch.object(graphs.CapturedStep, "capture", lambda self: None):
            plain = InferenceEngine(cfg, params=eng.params, max_cache=eng.max_cache,
                                    device=dev)
            want = plain.generate(prompts, N_NEW).tokens
            del plain
        runs = []
        eng._prefill(*eng._prompt(prompts, N_NEW))
        with mock.patch.object(api, "decode_step", recorded):
            eng._decoder(4, 0.0)
            for _ in range(args.runs):
                row.zero_()
                res = eng.generate(prompts, N_NEW)
                graph = eng._prefills[(4, 128)]
                runs.append({"tokens": res.tokens,
                             "prefill logits": graph.logits.clone(),
                             "step logits": step_logits[:N_NEW - 1].clone(),
                             "cache": {k: t.clone() for k, t in eng._cache.items()}})
        base = runs[0]
        bad = []
        for i, run in enumerate(runs):
            if not torch.equal(run["tokens"], want):
                differ["uncaptured tokens"] += 1
                bad.append(f"run {i} tokens != uncaptured")
            if i == 0:
                continue
            for key in ("tokens", "prefill logits", "step logits"):
                if not torch.equal(run[key], base[key]):
                    differ[key] += 1
                    bad.append(f"run {i} {key}")
                    if key == "step logits":
                        steps = (run[key] != base[key]).flatten(1).any(1).nonzero().flatten()
                        bad[-1] += f" (first differing step {int(steps[0])})"
            if any(not torch.equal(run["cache"][k], base["cache"][k]) for k in base["cache"]):
                differ["cache"] += 1
                bad.append(f"run {i} cache")
        if bad and not first_diffs:
            first_diffs = [f"round {rnd}: " + "; ".join(bad)]
        recorded_steps = int((base["step logits"] != 0).flatten(1).any(1).sum())
        if recorded_steps != N_NEW - 1:
            raise SystemExit(f"{recorded_steps} decode steps' logits recorded, not {N_NEW - 1}")
        print(f"[det] {ARCH} round {rnd}: {args.runs} replayed greedy runs of "
              f"{recorded_steps} recorded steps, "
              f"{'all bit-equal to the first and to the uncaptured tokens' if not bad else bad} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del eng, runs, base, step_logits
    compared = args.rounds * (args.runs - 1)
    print(json.dumps({"arch": ARCH, "src": args.src, "card": card,
                      "rounds": args.rounds, "runs_per_round": args.runs,
                      "runs_compared_with_the_first": compared,
                      "runs_compared_with_uncaptured": args.rounds * args.runs,
                      "differing": differ, "first": first_diffs}))
    return 1 if any(differ.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
