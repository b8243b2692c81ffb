"""Steps captured once into a CUDA graph and replayed: the port's
counterpart of the reference's jits.  ``DecodeGraph`` is the jitted decode
(``jax.jit`` of a scanned step with the cache donated,
``repro/serving/engine.py`` and ``continuous.py``), ``PrefillGraph`` the
prefill jitted per prompt shape (``engine.py:59``, ``continuous.py:92``),
``ForwardGraph`` the jitted CNN forward that the calibration times
(``repro/core/calibration.py:210``), and ``TrainGraph`` the jitted train
step (``repro/train/loop.py:37``).

Each wraps a step that reads and writes only tensors whose addresses never
change: its own static buffers, the caller's (the server's ``active`` mask;
a train step's params, moments and step count), and the cache, which every
family updates in place.  On the card the step is warmed up once on the
device's warm-up stream (which builds the kernels' libraries and runs their
one-time set-up calls, and lets cuDNN and cuBLAS pick their algorithms,
outside the capture), captured into a ``torch.cuda.CUDAGraph`` and then replayed: one
host call a step in place of every launch of every layer.  On the CPU no
graph exists, as no kernel does, and ``replay`` runs the same step eagerly
through the same buffers.  A capture that fails raises; nothing falls back
to the eager path.  A copy into a static buffer is made outside the graph,
before the replay.

The kernel wrappers count their launches at the call, which under capture
reaches no card.  So the capture's increase of each count is taken back and
recorded, and every replay adds it: the counts go on counting the kernels
that reached the card.

A step whose ``telemetry`` is set (``serving/telemetry.py``; the continuous
server sets it on its graphs) records a ``graph.capture`` span around its
warm-up and capture, which ends in a synchronize, and times each replay on
the device with an event pair (``replay.<kind>``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash, flash_bwd
from repro_torch.kernels.decode import flash_decode
from repro_torch.kernels.optim import adamw
from repro_torch.kernels.rwkv import wkv, wkv_bwd
from repro_torch.serving.telemetry import NULL, span

# steps whose tokens the block holds before its row index wraps to 0; the
# continuous server's chunks are at most this long
BLOCK = 64
# the kernel wrappers' launch counts: K1, K2, K3, K1-bwd, K3-bwd, K4, K5
COUNTED = (flash, flash_decode, wkv, flash_bwd, wkv_bwd, adamw.SUMSQ, adamw.UPDATE)


# the side stream of every capture's warm-up, one per device, made at the
# first capture and kept, as ``torch.cuda.graph`` keeps one capture stream:
# cuBLAS keeps a workspace for every stream it has run on, so a new stream
# per capture would leave one workspace behind each time
_WARM_UP: dict[int, torch.cuda.Stream] = {}


def warm_up_stream(device) -> torch.cuda.Stream:
    """The warm-up stream of the CUDA ``device``."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _WARM_UP:
        _WARM_UP[index] = torch.cuda.Stream(index)
    return _WARM_UP[index]


class CapturedStep:
    """A step over static buffers, and its graph on the card.  A subclass
    gives ``step``, and ``carry``: the buffers whose changes by the
    capture's warm-up step are undone.  ``kind`` names its replays' device
    time, ``label`` its capture span."""

    kind = "step"

    def __init__(self, device, *, generator=None, pool=None):
        """``generator``: the CUDA generator a sampling step draws from,
        registered with the graph so that each replay draws anew.
        ``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
        graphs that never replay concurrently with this one."""
        self.device = torch.device(device)
        self.generator = generator
        self.pool = pool
        self.graph = None
        self.added = {}   # kernel launch count (COUNTED) -> launches one replay adds
        self.replays = 0  # replays since construction (eager steps on the CPU)
        self.telemetry = None
        self.label = self.kind

    def step(self) -> None:
        raise NotImplementedError

    def carry(self) -> tuple:
        return ()

    def capture(self) -> None:
        """On the card, once: warm up on the warm-up stream, then capture one
        step (a no-op on the CPU, and once captured).  The warm-up's changes
        to ``carry`` are undone; its writes to the cache are the caller's
        to order (``DecodeGraph.carry``, ``PrefillGraph``)."""
        if self.graph is not None or self.device.type != "cuda":
            return
        tel = self.telemetry
        with span(tel, "graph.capture", detail=self.label, sync=True):
            keep = self.carry()
            saved = [t.clone() for t in keep]
            self.warm_up()
            for t, s in zip(keep, saved):
                t.copy_(s)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            self.record(graph, torch.cuda.graph(graph, pool=self.pool))

    def warm_up(self) -> None:
        """One step, eagerly, on the device's warm-up stream
        (``warm_up_stream``), which the current stream then waits for."""
        side = warm_up_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)

    def record(self, graph, capturing) -> None:
        """Capture ``step`` into ``graph`` under the context ``capturing``;
        the launch counts' increase during capture becomes each replay's."""
        before = {m: m.launches for m in COUNTED}
        with capturing:
            self.step()
        for m, n in before.items():
            self.added[m] = m.launches - n
            m.launches = n
        self.graph = graph

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def replay(self) -> None:
        """One step: the graph once captured, else ``step`` (on the CPU,
        where there is no graph)."""
        self.replays += 1
        tel = self.telemetry
        with (NULL if tel is None else tel.timed(f"replay.{self.kind}")):
            if self.graph is None:
                self.step()
                return
            self.graph.replay()
        for m, n in self.added.items():
            m.launches += n


class DecodeGraph(CapturedStep):
    """The static buffers of one decode step at a batch of ``batch`` rows:
    the last tokens and positions (B,), and a block of ``BLOCK`` rows where
    each step writes its sampled tokens at a row index that lives on the
    device and advances inside the step."""

    kind = "decode"

    def __init__(self, batch: int, device: torch.device, advance, *, generator=None):
        """``advance(tok, pos) -> (sampled, next_tok, next_pos)``: the
        family's decode step from the last tokens and positions (B,) to the
        sampled tokens and the carry of the next step, on the device and
        without a host sync."""
        super().__init__(device, generator=generator)
        self.tok = torch.zeros((batch,), dtype=torch.long, device=device)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=device)
        self.block = torch.zeros((BLOCK, batch), dtype=torch.long, device=device)
        self.row = torch.zeros((1,), dtype=torch.long, device=device)
        self.advance = advance

    def step(self) -> None:
        """One step, uncaptured: the tokens sampled go to the block's row
        ``row``, and the carry advances in place."""
        sampled, tok, pos = self.advance(self.tok, self.pos)
        self.block.index_copy_(0, self.row, sampled[None])
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        torch.remainder(self.row + 1, BLOCK, out=self.row)

    def carry(self) -> tuple:
        """The capture's warm-up step also runs on the cache: a KV cache
        gets the keys and values at the carry's positions, which the first
        replay writes again before it reads them; a recurrent state is
        advanced, so the engine captures before its prefill resets the
        state."""
        return self.tok, self.pos, self.row

    def start(self, tok: torch.Tensor, pos) -> None:
        """Set the carry: the last tokens (B,) and their positions (an int
        for every row, or (B,)), and the block's row to 0."""
        self.tok.copy_(tok)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))
        self.row.zero_()

    def run(self, n: int) -> torch.Tensor:
        """``n`` <= BLOCK steps from the block's row 0; -> their sampled
        tokens (n, B), on the device."""
        if not 0 < n <= BLOCK:
            raise ValueError(f"run: {n} steps; 1 to {BLOCK} at a time")
        self.row.zero_()
        for _ in range(n):
            self.replay()
        return self.block[:n]


class PrefillGraph(CapturedStep):
    """One prefill of a (batch, length) prompt: the static prompt and the
    position of each row's last real token (B,), on the device, and the
    static logits there (B, V).  The family's prefill writes the caller's
    cache in place: its warm-up and every replay reset the cache and fill it
    from the prompt, so a replay is exact whatever ran on the cache before."""

    kind = "prefill"

    def __init__(self, batch: int, length: int, vocab: int, dtype, device, prefill,
                 *, pool=None):
        """``prefill(tokens, last) -> logits``: the family's prefill of the
        prompt (B, S) into the cache, returning the logits at ``last`` (B,),
        without a host sync."""
        super().__init__(device, pool=pool)
        self.tokens = torch.zeros((batch, length), dtype=torch.long, device=device)
        self.last = torch.full((batch,), length - 1, dtype=torch.long, device=device)
        self.logits = torch.zeros((batch, vocab), dtype=dtype, device=device)
        self.prefill = prefill

    def step(self) -> None:
        self.logits.copy_(self.prefill(self.tokens, self.last))

    def run(self, tokens: torch.Tensor, last=None) -> torch.Tensor:
        """Copy the prompt (B, S) and each row's last position (None: S - 1
        in every row; an int for every row; or (B,)) into the buffers, then
        replay.  -> the static logits (B, V), valid until the next run."""
        self.tokens.copy_(tokens)
        if isinstance(last, torch.Tensor):
            self.last.copy_(last)
        else:
            self.last.fill_(self.tokens.shape[1] - 1 if last is None else int(last))
        self.replay()
        return self.logits


class ForwardGraph(CapturedStep):
    """One CNN forward at a fixed batch: the static images (N, 3, H, W) and
    logits (N, classes), float32, on the device."""

    def __init__(self, shape: tuple, classes: int, device, forward):
        """``forward(images) -> logits``."""
        super().__init__(device)
        self.images = torch.zeros(shape, dtype=torch.float32, device=device)
        self.logits = torch.zeros((shape[0], classes), dtype=torch.float32, device=device)
        self.forward = forward

    def step(self) -> None:
        self.logits.copy_(self.forward(self.images))

    def run(self, images: torch.Tensor) -> torch.Tensor:
        """Copy ``images`` into the buffer and replay.  -> the static
        logits, valid until the next run."""
        self.images.copy_(images)
        self.replay()
        return self.logits


class TrainGraph(CapturedStep):
    """One train step at a fixed batch shape, the port's counterpart of the
    reference's ``jax.jit(make_train_step(...))``: the static batch (each
    key's shape and dtype fixed by the first batch) and the step's metrics
    (0-d tensors).  The params, the optimizer's moments and its step count
    are the caller's, updated in place by every step, so the graph reads
    and writes them where they lie.

    The capture's warm-up is a real step whose results stand: the first
    step, run eagerly on the warm-up stream.  The capture then runs nothing, and
    every later step is a replay.  So nothing is carried back (a copy of
    the params and moments would take as much memory again), and ``run``
    returns the warm-up's metrics at its first call.  Between the warm-up
    and the capture the allocator's cached blocks are released, so that
    the graph's private pool can take that memory."""

    def __init__(self, step_fn, params, opt_state, batch: dict, device):
        """``step_fn(params, opt_state, batch) -> (params, opt_state,
        metrics)``: ``launch/steps.py::make_train_step``'s step, which
        updates ``params`` and ``opt_state`` in place and syncs nothing with
        the host."""
        super().__init__(device)
        self.step_fn = step_fn
        self.params, self.opt_state = params, opt_state
        self.batch = {k: torch.zeros_like(v, device=self.device) for k, v in batch.items()}
        self.metrics: dict = {}

    def step(self) -> None:
        _, _, metrics = self.step_fn(self.params, self.opt_state, self.batch)
        if not self.metrics:      # the first step runs eagerly: the buffers are made
            self.metrics = {k: torch.zeros_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self.metrics[k].copy_(v)

    def capture(self) -> None:
        """On the card, once: the warm-up step (which stands), the cached
        blocks released, then the capture."""
        if self.graph is not None or self.device.type != "cuda":
            return
        self.warm_up()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        self.record(graph, torch.cuda.graph(graph, pool=self.pool))

    def run(self, batch: dict) -> dict:
        """Copy ``batch`` into the static buffers, then one step: on the card
        the capture's warm-up at the first call, a replay after it; on the
        CPU (or uncaptured) the step itself.  -> the static metrics, valid
        until the next run."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if self.graph is None and self.device.type == "cuda":
            self.capture()
            if self.graph is not None:
                return self.metrics
        self.replay()
        return self.metrics
