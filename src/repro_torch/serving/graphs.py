"""One decode step, captured once into a CUDA graph and replayed: the port's
counterpart of the reference's jitted decode (``jax.jit`` of a scanned step
with the cache donated, ``repro/serving/engine.py`` and ``continuous.py``).

A ``DecodeGraph`` wraps a step function that reads and writes only tensors
whose addresses never change: its own static carry (last tokens,
positions), the caller's (the server's ``active`` mask), the cache, which
every family updates in place, and a block of ``BLOCK`` rows where each step
writes its sampled tokens at a row index that lives on the device and
advances inside the step.  On the card the step is warmed up once on a side stream (which
builds the kernels' libraries and runs their one-time set-up calls outside
the capture), captured into a ``torch.cuda.CUDAGraph`` and then replayed:
one host call a step in place of every launch of every layer.  On the CPU no
graph exists, as no kernel does, and ``replay`` runs the same step eagerly
through the same buffers.  A capture that fails raises; nothing falls back
to the eager loop.

The kernel wrappers count their launches at the call, which under capture
reaches no card.  So the capture's increase of each count is taken back and
recorded, and every replay adds it: the counts go on counting the kernels
that reached the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import flash
from repro_torch.kernels.decode import flash_decode
from repro_torch.kernels.rwkv import wkv

# steps whose tokens the block holds before its row index wraps to 0; the
# continuous server's chunks are at most this long
BLOCK = 64
COUNTED = (flash, flash_decode, wkv)   # the kernel wrappers' launch counts


class DecodeGraph:
    """The static buffers of one decode step at a batch of ``batch`` rows,
    the step over them, and its graph on the card."""

    def __init__(self, batch: int, device: torch.device, advance, *, generator=None):
        """``advance(tok, pos) -> (sampled, next_tok, next_pos)``: the
        family's decode step from the last tokens and positions (B,) to the
        sampled tokens and the carry of the next step, on the device and
        without a host sync.  ``generator``: the CUDA generator a sampling
        step draws from, registered with the graph so that each replay
        draws anew."""
        self.tok = torch.zeros((batch,), dtype=torch.long, device=device)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=device)
        self.block = torch.zeros((BLOCK, batch), dtype=torch.long, device=device)
        self.row = torch.zeros((1,), dtype=torch.long, device=device)
        self.advance = advance
        self.generator = generator
        self.graph = None
        self.added = {}   # kernel wrapper module -> launches one replay adds

    def step(self) -> None:
        """One step, uncaptured: the tokens sampled go to the block's row
        ``row``, and the carry advances in place."""
        sampled, tok, pos = self.advance(self.tok, self.pos)
        self.block.index_copy_(0, self.row, sampled[None])
        self.tok.copy_(tok)
        self.pos.copy_(pos)
        torch.remainder(self.row + 1, BLOCK, out=self.row)

    def capture(self) -> None:
        """On the card, once: warm up on a side stream, then capture one
        step (a no-op on the CPU, and once captured).  The warm-up's changes
        to the carry are undone.  Its step also runs on the cache: a KV
        cache gets the keys and values at the carry's positions, which the
        first replay writes again before it reads them; a recurrent state is
        advanced, so the engine captures before its prefill resets the
        state."""
        device = self.tok.device
        if self.graph is not None or device.type != "cuda":
            return
        keep = (self.tok, self.pos, self.row)
        saved = [t.clone() for t in keep]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(device).wait_stream(side)
        for t, s in zip(keep, saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        self.record(graph, torch.cuda.graph(graph))

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

    def start(self, tok: torch.Tensor, pos) -> None:
        """Set the carry: the last tokens (B,) and their positions (an int
        for every row, or (B,)), and the block's row to 0."""
        self.tok.copy_(tok)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos)
        else:
            self.pos.fill_(int(pos))
        self.row.zero_()

    def replay(self) -> None:
        """One decode step: the graph once captured, else ``step`` (on the
        CPU, where there is no graph)."""
        if self.graph is None:
            self.step()
            return
        self.graph.replay()
        for m, n in self.added.items():
            m.launches += n

    def run(self, n: int) -> torch.Tensor:
        """``n`` <= BLOCK steps from the block's row 0; -> their sampled
        tokens (n, B), on the device."""
        if not 0 < n <= BLOCK:
            raise ValueError(f"run: {n} steps; 1 to {BLOCK} at a time")
        self.row.zero_()
        for _ in range(n):
            self.replay()
        return self.block[:n]
