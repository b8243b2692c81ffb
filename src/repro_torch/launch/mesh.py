"""Local device meshes: the port's counterpart of ``repro/launch/mesh.py``.

A mesh here is the reference's ``("data", "model")`` grid laid over the
ranks of a ``torch.distributed`` process group, one rank per grid point,
row-major: rank = d * model + m.  Each rank builds the same ``Mesh``
(``make_local_mesh``) and holds plain local shards of the tensors the rules
in ``launch/sharding.py`` cut; model code reaches the other ranks only
through the counted collectives of ``repro_torch/shardctx.py``, on the
process group of one axis or of both.

The backend follows from the layout and is never chosen by catching an
error (``backend_for``): NCCL with one rank per card when there are at
least as many cards as ranks; gloo on the CPU, and gloo when ranks share a
card (gloo copies CUDA tensors through host memory for its collectives).

``spawn`` starts the ranks of one mesh as processes on this host
(``torch.multiprocessing``, a ``FileStore`` in a temporary directory), joins
them within a time limit and kills them all when one fails.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device

# NVIDIA H100 SXM5, per card (the port's counterparts of the reference's TPU
# v5e constants)
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense BF16 tensor cores (H100 data sheet)
HBM_BW = 3.35e12               # bytes/s, HBM3 (H100 data sheet)
NVLINK_BW = 450e9              # bytes/s per direction, NVLink 4 (900 GB/s total, data sheet)

DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass
class Mesh:
    """The mesh as one rank sees it.  ``axis_names`` and ``shape`` (axis ->
    size) are what the reference's rules read from a ``jax.sharding.Mesh``;
    ``coords`` is this rank's index on each axis; ``device`` the device its
    tensors live on; ``device_mesh`` the ``torch.distributed`` DeviceMesh
    whose per-axis process groups the collectives use."""

    axis_names: tuple
    shape: dict
    rank: int
    coords: dict
    device: torch.device
    backend: str
    device_mesh: object = None
    groups: dict = dataclasses.field(default_factory=dict)

    def axes(self, axes) -> tuple:
        """``axes`` (None, a name, or names) as a tuple in mesh order."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in names)

    def size(self, axes) -> int:
        return axis_size(self, self.axes(axes))

    def index(self, axes) -> int:
        """This rank's index in the group of ``axes`` (row-major over them,
        the order a dim cut over several axes takes)."""
        i = 0
        for a in self.axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, axes):
        """The process group of this rank and the ranks that differ from it
        only on ``axes``."""
        return self.groups[self.axes(axes)]


def backend_for(world: int, device) -> tuple[str, torch.device]:
    """(backend, this rank's device kind) for ``world`` ranks on ``device``:
    NCCL when there are at least ``world`` cards, else gloo (the CPU, or
    ranks sharing cards).  Raises when the card is asked for and there is
    none."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", dev
    return ("nccl" if torch.cuda.device_count() >= world else "gloo"), dev


def rank_device(rank: int, device) -> torch.device:
    """The card of ``rank`` (rank modulo the cards present), or the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_process_group(rank: int, world: int, store_path: str, *, device="cuda",
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the default process group of ``world`` ranks through a
    ``FileStore`` at ``store_path``.  -> the backend.  Nothing falls back:
    a failure to set up the group raises."""
    backend, dev = backend_for(world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(rank, dev))
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda") -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the default process
    group, built on every rank: its DeviceMesh, the process group of each
    axis, and that of both (the gradient norm's sums over a leaf cut on
    both).  The group must hold exactly the mesh's ranks; its backend is
    the one ``init_process_group`` chose."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh: no process group; start the ranks with "
                           "repro_torch.launch.mesh.spawn or init_process_group")
    from torch.distributed.device_mesh import init_device_mesh
    names, dims = ("data", "model"), (data, model)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model != world:
        raise ValueError(f"a {dims} mesh needs {data * model} ranks, the group has {world}")
    backend = dist.get_backend()
    dev = rank_device(rank, resolve_device(device))
    # the DeviceMesh only groups ranks here: with gloo it is a CPU mesh even
    # when the ranks' tensors are on a card
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", dims, mesh_dim_names=names)
    groups = {(n,): dm.get_group(n) for n in names}
    groups[names] = dist.group.WORLD
    return Mesh(names, dict(zip(names, dims)), rank, dict(zip(names, dm.get_coordinate())),
                dev, backend, dm, groups)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def model_axis(mesh) -> str | None:
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _entry(rank, fn, world, store, device, timeout_s, args):
    init_process_group(rank, world, store, device=device, timeout_s=timeout_s)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, args: tuple = (), *, device="cuda", timeout_s: float = 900,
          pg_timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, *args)`` in ``world`` new processes, each a rank of
    one process group (joined through a ``FileStore`` in a temporary
    directory) on ``device``.  Waits at most ``timeout_s`` for all of them;
    on a rank's failure or the time limit, kills every rank and raises.
    ``fn`` must be importable by name (a module's top-level function)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_entry, args=(fn, world, os.path.join(tmp, "store"),
                                               str(device), pg_timeout_s, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(min(5.0, deadline - time.monotonic()), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks did not finish in {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
