"""Serving launcher: batched generation over a request trace, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-7b \
        --requests 8 [--smoke] [--device cpu] [--serverless]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
        --requests 8 [--smoke] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \
        --requests 8 [--smoke] [--device cpu]

``--arch`` takes every language model of the registry, the reference's
ten (recurrentgemma-9b, whisper-tiny and llava-next-mistral-7b too; the
last two get the reference's zero frame or patch embeddings); at full width
qwen2.5-32b fits one 80 GB card only alone, and qwen3-moe-235b-a22b and
qwen1.5-110b fit none (their sharded paths are not ported).

The counterpart of ``repro.launch.serve``.  ``--serverless`` then runs the
paper's question on the measured engine, as the reference's flag does: the
serving engine dropped (two copies of qwen2.5-32b's weights do not fit one
card), a fresh engine measured (``measure_engine`` at ``--max-batch``,
``--prompt`` and ``--n-new``), wrapped as a 1536 MB function (``llm_handler``), and a
zero-jitter single-function simulation of ``warm_burst(n=10)``
(``core/simulator.py``'s ``Simulator``, seed 0) prints the cold and the warm response time and
their ratio.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    from repro_torch.configs.registry import ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--n-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-wait-ms", type=float, default=20.0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serverless", action="store_true",
                    help="also run the measured engine through the simulated platform")
    args = ap.parse_args(argv)

    from repro_torch.serving.batcher import Batcher, PendingRequest
    from repro_torch.serving.engine import InferenceEngine

    spec = ARCHS[args.arch]
    cfg = spec.smoke if args.smoke else spec.config
    eng = InferenceEngine(cfg, max_cache=args.prompt + args.n_new + 8,
                          device=args.device)
    compile_s = eng.warmup(args.max_batch, args.prompt)
    print(f"[serve] {cfg.name} on {eng.device}: load={eng.load_s:.2f}s "
          f"warmup={compile_s:.2f}s")

    batcher = Batcher(max_batch=args.max_batch,
                      max_wait_s=args.max_wait_ms / 1e3)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        batcher.submit(PendingRequest(
            rid=rid,
            tokens=rng.integers(0, cfg.vocab_size, size=args.prompt).tolist(),
            arrival_s=time.perf_counter() - t0, n_new=args.n_new))
    lat, outs = {}, {}
    while batcher.queue:
        batch = batcher.form_batch(time.perf_counter() - t0, force=True)
        res = eng.generate(batch.tokens, batch.n_new,
                           temperature=args.temperature)
        done = time.perf_counter() - t0
        # the engine decodes the batch max; settle each request at its own
        # budget so a 2-token ask batched with a 64-token ask gets 2 tokens
        for i, rid in enumerate(batch.rids):
            lat[rid] = done
            outs[rid] = res.tokens[i, :batch.n_new_each[i]].numpy()
        print(f"[serve]   batch={len(batch.rids)} prefill="
              f"{res.prefill_s*1e3:.1f}ms decode={res.decode_s*1e3:.1f}ms "
              f"({res.tokens_per_s:.0f} tok/s)")
    toks_out = sum(len(v) for v in outs.values())
    print(f"[serve] {len(lat)} requests served ({toks_out} tokens); p50="
          f"{np.percentile(list(lat.values()), 50):.3f}s "
          f"max={max(lat.values()):.3f}s")

    if args.serverless:
        from repro_torch.core.function import FunctionSpec
        from repro_torch.core.simulator import Simulator
        from repro_torch.core.workload import warm_burst
        from repro_torch.serving.handler import llm_handler, measure_engine
        del eng     # the fresh engine below is measured alone on the card
        m = measure_engine(cfg, batch=args.max_batch, prompt=args.prompt,
                           n_new=args.n_new, device=args.device)
        fspec = FunctionSpec(handler=llm_handler(cfg, measured=m), memory_mb=1536)
        sim = Simulator(fspec, seed=0, jitter=0.0)
        recs = sim.run(warm_burst(n=10))
        cold = [r for r in recs if r.cold][0]
        warm = [r for r in recs if not r.cold][0]
        print(f"[serve] serverless: cold={cold.response_s:.2f}s "
              f"warm={warm.response_s:.3f}s "
              f"(bimodality x{cold.response_s/warm.response_s:.1f})")
    return outs


if __name__ == "__main__":
    main()
