"""Training launcher, the port's counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --smoke \
        --steps 20 --device cpu

Runs on the card unless ``--device cpu``.  ``--data-par`` and
``--model-par`` above 1 need the sharded paths, which the port has not yet
(ROADMAP.md Queue 1, slice F): they exit with an error.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.data_par * args.model_par > 1:
        ap.error(f"--data-par {args.data_par} --model-par {args.model_par}: data and model "
                 "parallelism need the sharded paths, which the port has not yet "
                 "(ROADMAP.md Queue 1, slice F)")

    import torch

    from repro_torch.configs.registry import get
    from repro_torch.train.loop import train

    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    n_dev = torch.cuda.device_count() if args.device.startswith("cuda") else 1
    print(f"[train] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} device={args.device} devices={n_dev}")
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                num_micro=args.micro, ckpt_path=args.ckpt, device=args.device)
    print(f"[train] {rep.params_m:.1f}M params; loss "
          f"{rep.initial_loss:.4f} -> {rep.final_loss:.4f} "
          f"({rep.steps} steps, {rep.wall_s:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
