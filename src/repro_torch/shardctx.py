"""The ambient mesh, and the counted collectives that model code runs on it.

The counterpart of the reference's ``repro/shardctx.py``.  The reference
installs a mesh and lets GSPMD insert the collectives; here every rank
holds plain local shards (``launch/sharding.py`` cuts them), the entry
points install the rank's ``launch.mesh.Mesh`` with ``use_mesh``, and the
model code calls the collectives below where Megatron-style tensor
parallelism needs them:

* ``copy_to(x, axes)``: identity forward, all-reduce of the gradient
  backward, where a replicated activation enters rank-specific work;
* ``reduce_from(x, axes)``: all-reduce forward, identity backward, where
  row-parallel partial sums (float32 accumulators) become whole;
* ``gather_from(x, axes, dim)``: all-gather forward, the rank's slice of
  the gradient backward, where a sharded activation becomes whole;
* ``scatter_to(x, axes, dim)``: the rank's slice forward, all-gather of the
  gradient backward, where a whole activation (computed alike on every
  rank, from replicated weights) feeds rank-specific work;
* ``gather_shards(x, axes, dim)``: all-gather forward, reduce-scatter of
  the gradient backward (FSDP's weights, and columns that the rules cut
  inside a head, gathered into whole heads that each rank uses for its own
  part of the output);
* ``combine_softmax(o, lse, axes)``: the attention outputs of the ranks'
  chunks of a sequence-sharded KV cache, each under its row log-sum-exp,
  combined into the output over the whole sequence (decode only).

Without a mesh, or on an axis of size 1, each is the identity.  Every
collective records ``(kind, count, bytes per rank)`` in ``COUNTS``, the
bytes being what one rank's link moves in a ring, as the reference's
``core/distributed.py::plan_shards`` counts them: an all-reduce of S bytes
``2 * S * (N-1)/N``, an all-gather to a whole of S bytes ``S * (N-1)/N``, a
reduce-scatter of S bytes ``S * (N-1)/N``.

Sequence parallelism (the reference's ``seq_parallel`` flag beside the
mesh, ``use_mesh(mesh, seq_parallel=True)``) is Megatron's: where
``seq_cut`` holds (a mesh, a "model" axis over 1, and a whole length
that divides it: the reference's rule for pinning the sequence to
"model") the residual stream between blocks is a rank's chunk of the
positions, (B, S/M, d), and the norms run on the rank's tokens.  A block
gathers its normed input along the sequence where tensor parallelism has
``copy_to`` (``seq_gather``: the gradient reduce-scattered back) and
reduce-scatters its row-parallel float32 partial sums where tensor
parallelism all-reduces them (``seq_reduce_scatter``: the gradient
all-gathered back).  Between the two every tensor that all model ranks
hold alike carries a rank's share of its gradient, which the gather's
reduce-scatter sums: so inside such a block ``copy_to``, ``gather_from``
and ``scatter_to`` take ``partial=True``, and a weight whole on every
model rank gets a partial gradient too, which the train step sums over
"model" (``launch/steps.py``).  A whole activation that enters the
stream (the vlm family's merged embeddings, whisper's frames) is cut to
the rank's chunk by ``seq_scatter``.

``constrain_batch`` keeps the reference's call sites: there it pins the
batch dim of an activation to the data axes, and with sequence
parallelism its sequence dim to "model", leaving the collectives to
GSPMD.  Here the entry points split the batch before the model runs and
the model code cuts the sequence with the collectives above, so it is
the identity on local tensors.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist

_CTX = {"mesh": None, "seq_parallel": False, "seq_cuts": {}}

# kind -> [count, bytes per rank]
COUNTS: dict[str, list] = {}


def set_mesh(mesh, *, seq_parallel: bool = False) -> None:
    _CTX["mesh"] = mesh
    _CTX["seq_parallel"] = seq_parallel


def get_mesh():
    return _CTX["mesh"]


def seq_parallel() -> bool:
    """Whether the ambient mesh asks for sequence parallelism."""
    return bool(_CTX["seq_parallel"]) and _CTX["mesh"] is not None


@contextmanager
def use_mesh(mesh, *, seq_parallel: bool = False):
    prev = (_CTX["mesh"], _CTX["seq_parallel"])
    set_mesh(mesh, seq_parallel=seq_parallel)
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["seq_parallel"] = prev


def get_seq_cuts() -> dict:
    """{cache leaf name: the axes that cut its sequence dim} of the ambient
    cache layout (``launch.sharding.use_cache_layout``)."""
    return _CTX["seq_cuts"]


@contextmanager
def use_seq_cuts(cuts: dict):
    prev = _CTX["seq_cuts"]
    _CTX["seq_cuts"] = cuts
    try:
        yield
    finally:
        _CTX["seq_cuts"] = prev


def constrain_batch(x, *, batch_dim: int = 0, seq_dim: int | None = None):
    """The reference pins ``x``'s batch dim over the data axes here (and
    its sequence over "model" under sequence parallelism); the port's entry
    points split the batch before the model runs and its model code cuts
    the sequence itself (``seq_cut``), so this is the identity."""
    return x


def seq_cut(x, seq_dim: int = 1) -> bool:
    """Whether sequence parallelism cuts the whole sequence dim ``seq_dim``
    of ``x`` over "model": the ambient mesh asks for it, has a "model" axis
    over 1, and the length divides that axis (the reference's rule; else
    the layout is tensor parallelism's, unchanged).  A decode step's length
    of 1 never divides it."""
    mesh = _CTX["mesh"]
    if not seq_parallel() or "model" not in mesh.axis_names:
        return False
    m = mesh.shape["model"]
    return m > 1 and x.dim() > seq_dim and x.shape[seq_dim] % m == 0


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> dict:
    """{kind: (count, bytes per rank)} since the last ``reset_counts``."""
    return {k: (int(n), float(b)) for k, (n, b) in COUNTS.items()}


def _record(kind: str, nbytes: float) -> None:
    entry = COUNTS.setdefault(kind, [0, 0.0])
    entry[0] += 1
    entry[1] += nbytes


def size(axes) -> int:
    """The number of ranks over ``axes`` of the ambient mesh (1 without)."""
    mesh = _CTX["mesh"]
    return 1 if mesh is None else mesh.size(axes)


def index(axes) -> int:
    """This rank's index over ``axes`` of the ambient mesh (0 without)."""
    mesh = _CTX["mesh"]
    return 0 if mesh is None else mesh.index(axes)


def local_slice(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's equal chunk of ``x`` along ``dim`` over ``axes``."""
    n = size(axes)
    if n == 1:
        return x
    return x.chunk(n, dim)[index(axes)]


# ----------------------------------------------------------------------
# the collectives (no autograd): sums over the group of ``axes``
# ----------------------------------------------------------------------

def all_reduce(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, a new tensor."""
    n = size(axes)
    if n == 1:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, group=_CTX["mesh"].group(axes))
    _record("all-reduce", 2.0 * y.numel() * y.element_size() * (n - 1) / n)
    return y


def all_gather(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = size(axes)
    if n == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=_CTX["mesh"].group(axes))
    _record("all-gather", float(n * x.numel() * x.element_size()) * (n - 1) / n)
    return torch.cat(parts, dim)


def reduce_scatter(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over the ranks of
    ``axes``.  NCCL has the collective; gloo has none for CUDA tensors, so
    with gloo it is an all-reduce and this rank's slice (which moves the
    all-reduce's bytes; the count records the reduce-scatter's ring
    bytes, the layout's own)."""
    n = size(axes)
    if n == 1:
        return x
    mesh = _CTX["mesh"]
    x = x.detach().contiguous()
    _record("reduce-scatter", float(x.numel() * x.element_size()) * (n - 1) / n)
    if mesh.backend == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n, *moved.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=mesh.group(axes))
        return out.movedim(0, dim).contiguous()
    y = x.clone()
    dist.all_reduce(y, group=mesh.group(axes))
    return y.chunk(n, dim)[mesh.index(axes)].contiguous()


# ----------------------------------------------------------------------
# the autograd pairs of tensor and fully sharded data parallelism
# ----------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.axes), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.axes, ctx.dim).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim = axes, dim
        return local_slice(x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.axes, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.dtype = axes, dim, x.dtype
        return all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        # summed over the data ranks in float32, as the gradient accumulators
        return reduce_scatter(g.float(), ctx.axes, ctx.dim).to(ctx.dtype), None, None


class _SeqGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_gather(x, "model", 1)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, "model", 1)


class _SeqReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = x.dtype
        return reduce_scatter(x, "model", 1).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, "model", 1).to(ctx.dtype), None


def copy_to(x: torch.Tensor, axes="model", *, partial: bool = False) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``axes`` backward.
    With ``partial`` (inside a sequence-parallel block, whose gather at
    its entry sums the ranks' shares) the identity both ways."""
    return x if partial or size(axes) == 1 else _CopyTo.apply(x, axes)


def reduce_from(x: torch.Tensor, axes="model") -> torch.Tensor:
    """All-reduce (sum) over ``axes`` forward; the gradient as it is backward."""
    return x if size(axes) == 1 else _ReduceFrom.apply(x, axes)


def gather_from(x: torch.Tensor, axes="model", dim: int = -1, *,
                partial: bool = False) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes`` forward; the rank's slice of the
    gradient backward, or with ``partial`` (a gradient that is each rank's
    share of the sum) its sum reduce-scattered (``gather_shards``)."""
    if partial:
        return gather_shards(x, axes, dim)
    return x if size(axes) == 1 else _GatherFrom.apply(x, axes, dim % x.dim())


def scatter_to(x: torch.Tensor, axes="model", dim: int = -1, *,
               partial: bool = False) -> torch.Tensor:
    """The rank's slice along ``dim`` over ``axes`` forward; the gradient
    all-gathered backward, or with ``partial`` left as this rank's share
    (zeros outside its slice: a plain slice)."""
    if partial:
        return local_slice(x, axes, dim)
    return x if size(axes) == 1 else _ScatterTo.apply(x, axes, dim % x.dim())


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """A rank's chunk of the sequence (dim 1) all-gathered over "model" into
    the whole; the gradient, each rank's share of the sum, reduce-scattered
    back in its own dtype (as ``copy_to`` all-reduces it).  A
    sequence-parallel block's input."""
    return x if size("model") == 1 else _SeqGather.apply(x)


def seq_reduce_scatter(x: torch.Tensor, dtype) -> torch.Tensor:
    """Float32 partial sums (B, S, ...) over "model" -> this rank's chunk of
    the sequence of their sum, cast to ``dtype``; the gradient (of that
    dtype) all-gathered back.  A sequence-parallel block's row-parallel
    output."""
    return x.to(dtype) if size("model") == 1 else _SeqReduceScatter.apply(x, dtype)


def seq_scatter(x: torch.Tensor) -> torch.Tensor:
    """A whole activation (B, S, ...), alike on every model rank, cut to
    this rank's chunk of the sequence; the gradient all-gathered back (the
    whole gradient on every rank, as the activation's producer expects)."""
    return scatter_to(x, "model", 1)


def seq_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of the sequence of a whole (B, S, ...) that the
    model ranks computed alike inside a sequence-parallel block; the
    gradient left as this rank's share (``scatter_to(partial=True)``)."""
    return local_slice(x, "model", 1)


def gather_shards(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes`` forward; the gradient
    reduce-scattered (summed) over them backward."""
    return x if size(axes) == 1 else _GatherShards.apply(x, axes, dim % x.dim())


def _softmax_weights(lses: torch.Tensor) -> tuple:
    """(each chunk's weight exp(lse - max), their sum) of the chunks' row
    log-sum-exps ``lses`` (n, B, H): weight 0 for a chunk without a valid
    position, 1 for every chunk of a row that has none anywhere."""
    top = lses.amax(0)
    none = torch.isneginf(top)
    top = torch.where(none, 0.0, top)
    w = torch.where(none, 1.0, torch.exp(lses - top))
    return w, w.sum(0)


def combine_softmax(o: torch.Tensor, lse: torch.Tensor, axes) -> torch.Tensor:
    """The attention output over a sequence cut over ``axes`` from each
    rank's output over its chunk: ``o`` (B,1,H,hd), normalised over the
    chunk, and ``lse`` (B,H) float32, its rows' log-sum-exp (-inf where the
    chunk holds no valid position).  In float32: the ranks' ``lse`` are
    all-gathered, each ``o`` weighted by exp(lse - max) and the weighted sum
    all-reduced and divided by the weights' sum.  A chunk without a valid
    position weighs 0; a row with none in any chunk gets the mean of the
    chunks' outputs, which with equal chunks is what one device gives, the
    mean of V over the whole cache.  No autograd: decode only."""
    n = size(axes)
    if n == 1:
        return o
    w, total = _softmax_weights(all_gather(lse[None], axes, 0))
    acc = all_reduce(o.float() * w[index(axes)][:, None, :, None], axes)
    return (acc / total[:, None, :, None]).to(o.dtype)


def merge_softmax(outs: list, lses: list) -> torch.Tensor:
    """``combine_softmax`` of the chunks' outputs and log-sum-exps held on
    one device (the chunks in rank order), with the same arithmetic: the
    single-device oracle of a sequence-sharded decode."""
    w, total = _softmax_weights(torch.stack(lses))
    acc = outs[0].float() * w[0][:, None, :, None]
    for i in range(1, len(outs)):
        acc = acc + outs[i].float() * w[i][:, None, :, None]
    return (acc / total[:, None, :, None]).to(outs[0].dtype)
