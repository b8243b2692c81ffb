"""Training driver: data -> train step -> metrics/checkpoints, as the
reference's ``repro/train/loop.py``, on the card unless the caller passes
``device="cpu"``.  The reference jits its step; here the step runs as a
``TrainGraph`` per batch shape (``serving/graphs.py``): captured into a CUDA
graph on the card and replayed, eager through the same buffers on the
CPU.  With a ``mesh`` (every rank of it calls ``train``) the params are cut
by the rules (``launch/sharding.py::param_pspecs``) and each batch by
``batch_pspec``, and the sharded step (``launch/steps.py``) runs
uncaptured; a checkpoint is gathered and written by rank 0."""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch import resolve_device, synchronize
from repro_torch.launch import sharding
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api, convert
from repro_torch.models.common import ModelConfig, count_params
from repro_torch.serving.graphs import TrainGraph
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import LMBatches, modal_extras
from repro_torch.train.optimizer import AdamW, cosine_schedule


@dataclasses.dataclass
class TrainReport:
    steps: int
    losses: list
    final_loss: float
    initial_loss: float
    wall_s: float
    params_m: float


def batch_on(batch: dict, cfg: ModelConfig, device) -> dict:
    """A numpy batch of ``LMBatches`` (and ``modal_extras``) as tensors on
    ``device``: tokens and labels as int64, the stub embeddings in the
    compute dtype, as the reference casts them."""
    return {k: torch.from_numpy(v).to(device=device,
                                      dtype=torch.long if v.dtype.kind == "i" else cfg.cdt)
            for k, v in batch.items()}


def train(cfg: ModelConfig, *, steps: int = 100, batch: int = 8, seq: int = 64,
          lr: float = 3e-4, seed: int = 0, mesh=None, log_every: int = 10,
          ckpt_path: str = "", num_micro: int = 1, verbose: bool = True,
          device="cuda") -> TrainReport:
    """``steps`` AdamW steps (cosine schedule, warm-up a tenth of them) of
    seeded weights (``api.init_params``, torch's draws) on ``LMBatches``;
    a checkpoint of the params, in the reference's layout and format, every
    ``steps // 2`` steps when ``ckpt_path`` is given.  Each batch is copied
    into the static buffers of its shape's ``TrainGraph``, which steps.
    With ``mesh`` the device is the mesh's, and each step is the sharded
    step on this rank's shards and rows."""
    pspecs = None
    if mesh is not None:
        device = mesh.device
    dev = resolve_device(device)
    opt = AdamW(learning_rate=cosine_schedule(lr, warmup=max(steps // 10, 1), total=steps))
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    if mesh is not None:
        pspecs = sharding.param_pspecs(api.abstract_params(cfg), cfg, mesh)
        params = sharding.shard_tree(params, pspecs, mesh)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, num_micro=num_micro, mesh=mesh, param_pspecs=pspecs)
    data = LMBatches(cfg.vocab_size, batch, seq, seed=seed)

    graphs: dict[tuple, TrainGraph] = {}
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        b = batch_on({**data(i), **modal_extras(cfg, batch, seed=seed, step=i)}, cfg, dev)
        if mesh is not None:
            _, _, m = step_fn(params, opt_state, sharding.shard_batch(b, mesh))
        else:
            key = tuple((k, tuple(v.shape)) for k, v in b.items())
            if key not in graphs:
                graphs[key] = TrainGraph(step_fn, params, opt_state, b, dev)
            m = graphs[key].run(b)
        loss = float(m["loss"])
        losses.append(loss)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"  step {i:4d} loss {loss:.4f} gnorm {float(m['grad_norm']):.3f}")
        if ckpt_path and (i + 1) % max(steps // 2, 1) == 0:
            ckpt_lib.save(ckpt_path, {"params": convert.to_reference(params, cfg)},
                          step=i + 1, mesh=mesh,
                          pspecs=pspecs and {"params": convert.to_reference(pspecs, cfg)})
    synchronize(dev)
    wall = time.perf_counter() - t0
    return TrainReport(steps=steps, losses=losses, final_loss=losses[-1],
                       initial_loss=losses[0], wall_s=wall,
                       params_m=count_params(params) / 1e6)
