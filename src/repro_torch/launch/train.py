"""Training launcher, the port's counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b --smoke \\
        --steps 20 --device cpu

Runs on the card unless ``--device cpu``.  With ``--data-par N
--model-par M`` above 1 it starts ``N * M`` ranks itself (processes of this
host, ``launch/mesh.py::spawn``), each building the ``(N, M)`` mesh and
training on its shards (``train/loop.py::train(mesh=)``): NCCL with a card a
rank when there are enough cards, gloo otherwise (``--device cpu``, or
ranks sharing a card).  Rank 0 prints.
"""
from __future__ import annotations

import argparse
import sys


def _report(rep) -> None:
    print(f"[train] {rep.params_m:.1f}M params; loss "
          f"{rep.initial_loss:.4f} -> {rep.final_loss:.4f} "
          f"({rep.steps} steps, {rep.wall_s:.1f}s)")
    print(f"[train] losses {' '.join(repr(x) for x in rep.losses)}")


def _rank(rank: int, args) -> None:
    """One rank of a ``--data-par``/``--model-par`` run."""
    from repro_torch.configs.registry import get
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.loop import train

    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    mesh = make_local_mesh(args.data_par, args.model_par, device=args.device)
    if rank == 0:
        print(f"[train] mesh data={args.data_par} model={args.model_par}: {mesh.backend}, "
              f"rank 0 on {mesh.device}", flush=True)
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                num_micro=args.micro, ckpt_path=args.ckpt, mesh=mesh, verbose=rank == 0)
    if rank == 0:
        _report(rep)


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

    import torch

    from repro_torch.configs.registry import get
    from repro_torch.train.loop import train

    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    world = args.data_par * args.model_par
    n_dev = torch.cuda.device_count() if args.device.startswith("cuda") else 1
    print(f"[train] {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} device={args.device} devices={n_dev} ranks={world}",
          flush=True)
    if world > 1:
        from repro_torch.launch.mesh import spawn
        spawn(_rank, world, (args,), device=args.device, timeout_s=24 * 3600)
        return 0
    rep = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                num_micro=args.micro, ckpt_path=args.ckpt, device=args.device)
    _report(rep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
