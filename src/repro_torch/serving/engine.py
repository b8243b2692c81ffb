"""InferenceEngine: the model-serving runtime, on the card.

Wraps every language-model family of the port (dense, moe, ssm: RWKV-6,
hybrid: RecurrentGemma, audio: Whisper, vlm: LLaVA-NeXT) behind a prefill
and a decode step, each captured once into a CUDA graph and replayed
(``serving/graphs.py``; on the CPU the same steps run eagerly).  Dense prompt
lengths are bucketed to powers of two, so the number of distinct prefill
shapes, and of prefill graphs, grows with the number of buckets, not of
prompt lengths; MoE prompts keep their exact length, since pad tokens would
change the experts' routing and capacity, and so do the other families'
(pad tokens would advance a recurrent state, and the reference keeps the
audio and vlm prompts exact too): they take a graph per (batch, length), as
the reference jits its prefill per exact shape
(``compile_stats`` counts the shapes, as the reference counts its jit
caches, and the graphs).  A prompt
and its last positions are copied into the prefill graph's static buffers
outside the graph, then the graph is replayed.  The audio and vlm families'
stubbed frontends get the reference's zero frame or patch embeddings, held
in static device buffers beside the cache, which their prefill graphs read.
The family's cache (a KV cache of ``max_cache`` positions, or the recurrent
state) is preallocated, reused while the batch size holds and updated in
place (the counterpart of the reference's donated cache).  The decode step
is keyed on the batch (so on the cache) and the temperature; it carries the positions on the device, as
the reference's scan carries them traced.  ``generate`` replays it
``n_new - 1`` times and syncs with the host once, at the end;
``generate_stream`` replays the same step with a sync per token, for
per-token latency.

With a ``mesh`` (``launch/mesh.py``) every rank of the mesh builds the
engine and calls ``generate`` or ``generate_stream`` with the same prompt:
the params are cut by ``launch/sharding.py::param_pspecs`` and the cache by
``cache_pspecs`` into the rank's local shards, the prompt's rows by
``batch_pspec``, and the model's collectives run on the ambient mesh
(``repro_torch.shardctx``) and cache layout (``sharding.use_cache_layout``:
where the rules cut the cache's sequence, over "model" for kv heads that do
not divide it or over "data" for a batch that does not divide the data
axes, a rank holds its chunk of the positions).  The steps run uncaptured there (gloo's
collectives cannot be captured into a CUDA graph), through the same static
buffers, and the sampled tokens are gathered over the data axes, so every
rank returns the whole batch's tokens.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, shardctx, synchronize
from repro_torch.launch import sharding
from repro_torch.launch.mesh import data_axes
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, count_params, leaf_paths, tensor_leaves
from repro_torch.serving.graphs import BLOCK, DecodeGraph, PrefillGraph
from repro_torch.serving.sampler import sample_token


def bucket_len(n: int) -> int:
    """Smallest power of two >= n — the prompt-length bucket."""
    return max(1, 1 << (int(n) - 1).bit_length())


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor           # (B, n_new) int64, on the host
    prefill_s: float
    decode_s: float
    tokens_per_s: float
    token_walls: Optional[list] = None   # per-token decode walls (stream path)


def _check_shards(shards: dict, abstract: dict, pspecs: dict, mesh) -> None:
    """Raise unless ``shards`` holds, at the key path of every leaf of the
    whole tree ``abstract`` and at no other, a tensor of its local shape
    under its spec, on the mesh's device."""
    n = 0
    for keys, whole, spec in zip(leaf_paths(abstract), tensor_leaves(abstract),
                                 sharding.spec_leaves(pspecs)):
        name, t = "/".join(map(str, keys)), shards
        try:
            for k in keys:
                t = t[k]
        except (KeyError, IndexError, TypeError):
            raise ValueError(f"shard {name}: missing") from None
        shape = sharding.local_shape(tuple(whole.shape), spec, mesh)
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or t.device != mesh.device:
            got = (tuple(t.shape), t.device) if isinstance(t, torch.Tensor) else type(t).__name__
            raise ValueError(f"shard {name}: {got}, the rank holds {shape} on {mesh.device}")
        n += 1
    extra = sum(1 for _ in tensor_leaves(shards)) - n
    if extra:
        raise ValueError(f"shards: {extra} leaves more than the model has")


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, *, seed: int = 0, max_cache: int = 256,
                 params: dict | None = None, device="cuda", mesh=None,
                 shards: dict | None = None):
        """``params`` (from ``repro_torch.models.convert.from_reference``, or
        another engine's) replaces the seeded random draw.  With ``mesh``
        the params (drawn, or given whole) are cut into this rank's shards
        on the mesh's device, and ``device`` is the mesh's; or ``shards``
        are this rank's shards already (``train.checkpoint.restore(mesh=,
        pspecs=)``, for weights no rank can hold whole), each leaf checked
        against ``sharding.local_shape`` of its spec and kept as it is."""
        self.cfg = cfg
        self.max_cache = max_cache
        self.mesh = mesh
        if mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        if shards is not None:
            if mesh is None or params is not None:
                raise ValueError("shards are a mesh rank's, given instead of params")
            params = shards
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = api.init_params(cfg, gen, self.device)
        if mesh is not None:
            abstract = api.abstract_params(cfg)
            self.pspecs = sharding.param_pspecs(abstract, cfg, mesh)
            if shards is None:
                params = sharding.shard_tree(params, self.pspecs, mesh)
            else:
                _check_shards(params, abstract, self.pspecs, mesh)
        self.params = params
        synchronize(self.device)
        self.load_s = time.perf_counter() - t0
        # the family's cache at batch ``_batch``, reused while the batch holds,
        # and the audio or vlm family's zero frontend embeddings at that batch
        self._cache, self._batch, self._modal = None, 0, {}
        # under a mesh: the ranks the current request's rows are cut over
        # (and the cache's), the rows' spec, and the whole cache of the
        # request's batch (meta) with its specs
        self._rows_cut, self._cache_cut, self._row_spec = 1, 1, (None,)
        self._layout = None
        # decode steps over that cache, by (batch, temperature)
        self._graphs: dict[tuple, DecodeGraph] = {}
        self._captures = 0
        # prefills into that cache, by (batch, padded or exact length), and
        # the memory pool they share (they never replay concurrently)
        self._prefills: dict[tuple, PrefillGraph] = {}
        self._prefill_captures = 0
        self._pool = None
        # sampling draws from this generator, reseeded per request; each
        # sampling graph registers it
        self._gen = torch.Generator(device=self.device)
        self._shapes = {"prefill": set(), "decode": set(), "decode_scan": set()}
        self.compiled = False
        self.compile_s = 0.0

    # ------------------------------------------------------------------
    def _cache_for(self, batch: int) -> dict:
        """The preallocated cache at ``batch`` rows, and the modal buffers."""
        if self._cache is None or (self._batch, self._cache_cut) != (batch, self._rows_cut):
            self._cache = None   # free the old one, and the graphs captured on it
            self._graphs.clear()
            self._prefills.clear()
            self._cache = self._new_cache(batch)
            self._batch, self._modal = batch, self._add_modal(batch)
            self._cache_cut = self._rows_cut
            if self.device.type == "cuda":
                self._pool = torch.cuda.graph_pool_handle()
        return self._cache

    def _new_cache(self, batch: int) -> dict:
        """A zeroed cache of ``batch`` rows; with a mesh, this rank's shard
        of the cache of the whole batch, whose rows are this rank's
        (``batch`` is the rank's count of them)."""
        if self.mesh is None:
            return api.init_cache(self.cfg, batch, self.max_cache, device=self.device)
        return sharding.local_zeros(*self._layout, self.mesh)

    @contextlib.contextmanager
    def _on_mesh(self, batch: int):
        """The ambient mesh for a request of ``batch`` rows (nothing
        without a mesh), and whether ``batch_pspec`` cuts its rows."""
        if self.mesh is None:
            yield
            return
        spec = sharding.batch_pspec((batch,), self.mesh)
        self._rows_cut = self.mesh.size(spec[0]) if spec[0] is not None else 1
        self._row_spec = spec
        abs_cache = api.init_cache(self.cfg, batch, self.max_cache, device="meta")
        self._layout = (abs_cache, sharding.cache_pspecs(abs_cache, self.cfg, self.mesh,
                                                         batch=batch))
        # the reference's engine has no sequence parallelism, nor has this one
        with shardctx.use_mesh(self.mesh, seq_parallel=False), \
                sharding.use_cache_layout(*self._layout):
            yield

    def _local_rows(self, tokens):
        """This rank's rows of the prompt (all of them without a mesh)."""
        if self.mesh is None:
            return tokens
        return sharding.shard(torch.as_tensor(tokens), self._row_spec + (None,), self.mesh)

    def _all_rows(self, toks: torch.Tensor, dim: int) -> torch.Tensor:
        """The sampled tokens of every rank's rows, along ``dim``."""
        if self.mesh is None or self._rows_cut == 1:
            return toks
        return shardctx.all_gather(toks, data_axes(self.mesh), dim)

    def _add_modal(self, batch: int) -> dict:
        """The stubbed frontend's inputs, zeros as the reference's
        ``_add_modal`` makes them: frame embeddings for audio, patch
        embeddings for vlm, none for the other families."""
        cfg = self.cfg
        stubs = {"audio": ("frame_embeds", cfg.encoder_seq),
                 "vlm": ("patch_embeds", cfg.num_image_tokens)}
        if cfg.family not in stubs:
            return {}
        key, n = stubs[cfg.family]
        return {key: torch.zeros((batch, n, cfg.d_model), dtype=cfg.cdt, device=self.device)}

    def _decoder(self, batch: int, temperature: float) -> DecodeGraph:
        """The decode step at ``batch`` rows and ``temperature`` over the
        cache, captured at its first use and replayed while the cache lives.
        Callers take it before the prefill: its capture runs one step on the
        cache, which the prefill then resets."""
        cache = self._cache_for(batch)
        key = (batch, float(temperature))
        if key not in self._graphs:
            # the step holds what it reads, not the engine: no cycle keeps a
            # dropped engine's weights and graphs alive
            params, cfg = self.params, self.cfg
            gen = self._gen if temperature > 0 else None

            def advance(tok, pos):
                logits, _ = api.decode_step(params, cache, tok, pos, cfg)
                nxt = sample_token(logits, temperature, gen)
                return nxt, nxt, pos + 1

            step = DecodeGraph(batch, self.device, advance, generator=gen)
            if self.mesh is None:
                step.capture()
            self._graphs[key] = step
            self._captures += step.captured
        return self._graphs[key]

    def _prefiller(self, batch: int, length: int) -> PrefillGraph:
        """The prefill of a (batch, length) prompt into the cache, captured
        at its first use and replayed while the cache lives: ``length`` is
        a dense prompt's bucket, whose last real positions the replay
        reads, or another family's exact length, whose last position it
        reads.  Its capture writes the cache, which its replay then
        writes again: so callers take the decode step first
        (``_decoder``)."""
        cache = self._cache_for(batch)
        key = (batch, length)
        if key not in self._prefills:
            params, cfg, cache_len = self.params, self.cfg, self.max_cache
            dense, modal = cfg.family == "dense", self._modal

            def prefill(tokens, last):
                logits, _ = api.prefill(params, {"tokens": tokens, **modal}, cfg, cache_len,
                                        last_pos=last if dense else None, cache=cache)
                return logits

            graph = PrefillGraph(batch, length, cfg.vocab_size, cfg.cdt, self.device,
                                 prefill, pool=self._pool)
            if self.mesh is None:
                graph.capture()
            self._prefills[key] = graph
            self._prefill_captures += graph.captured
        return self._prefills[key]

    def _prefill(self, tokens, last_pos, cache_len: int):
        """The prompt (B, S), on the host or the device, through its prefill
        graph; ``last_pos`` is the position whose logits are the last
        token's (None: S - 1; an int, or (B,), for every row).  -> (the
        graph's static logits (B, V), the cache)."""
        b, s = tokens.shape
        self._shapes["prefill"].add((b, s, cache_len, last_pos is None))
        return self._prefiller(b, s).run(tokens, last_pos), self._cache

    def _prompt(self, tokens, n_new: int):
        """The prompt, right-padded to its bucket, where it was given (the
        host, as a rule: the prefill copies it into its graph's buffer), the
        position whose logits are the last token's (None: the last), and
        the cache length."""
        tokens = torch.as_tensor(tokens).long()
        s = tokens.shape[1]
        s_pad, cache_len = self._prefill_shapes(s, n_new)
        if s_pad > s:
            tokens = F.pad(tokens, (0, s_pad - s))
        return tokens, (s - 1 if s_pad > s else None), cache_len

    # ------------------------------------------------------------------
    def warmup(self, batch: int, prompt_len: int):
        """Run both steps once, capturing the greedy decode step and the
        prompt's prefill (and building the kernels on first use on the
        card) — the modern 'cold start', as the reference's warmup compiles
        its prefill and decode."""
        t0 = time.perf_counter()
        with self._on_mesh(batch):
            tokens = self._local_rows(torch.zeros((batch, prompt_len), dtype=torch.long))
            b = tokens.shape[0]
            step = self._decoder(b, 0.0)
            self._prefill(tokens, None, self.max_cache)
            self._shapes["decode"].add(b)
            step.start(tokens[:, -1], prompt_len)
            step.replay()
        synchronize(self.device)
        self.compile_s = time.perf_counter() - t0
        self.compiled = True
        return self.compile_s

    def _prefill_shapes(self, s: int, n_new: int) -> tuple:
        """(padded_prompt_len, cache_len) — the shape policy.

        dense: prompts pad to a power-of-two bucket and the cache is always
        ``max_cache``, so shapes vary per bucket, not per (s, n_new).
        moe: the exact prompt (pad tokens would shift the experts' routing)
        and the fixed cache.
        The rest (ssm, hybrid, audio, vlm): exact prompt lengths (pad tokens
        would advance a recurrent state) and the reference's cache length,
        which its prefill jit is keyed on; the port's cache keeps
        ``max_cache`` positions (a recurrent state ignores it), and a decode
        step masks the positions past its own."""
        if self.cfg.family == "dense":
            return min(bucket_len(s), self.max_cache), self.max_cache
        if self.cfg.family == "moe":
            return s, self.max_cache
        return s, min(self.max_cache, s + n_new)

    # ------------------------------------------------------------------
    def generate(self, tokens, n_new: int, *, temperature: float = 0.0,
                 seed: int = 0) -> GenerateResult:
        """tokens: (B, S) prompt (tensor, array or nested list).  Greedy or
        temperature decoding of n_new tokens: ``n_new - 1`` replays of the
        decode step, one host sync for the decode."""
        tokens, last_pos, cache_len = self._prompt(tokens, n_new)
        with self._on_mesh(tokens.shape[0]):
            return self._generate(self._local_rows(tokens), last_pos, cache_len, n_new,
                                  temperature, seed)

    def _generate(self, tokens, last_pos, cache_len, n_new, temperature, seed):
        b = tokens.shape[0]
        s = tokens.shape[1] if last_pos is None else last_pos + 1
        step = self._decoder(b, temperature) if n_new > 1 else None
        t0 = time.perf_counter()
        logits, _ = self._prefill(tokens, last_pos, cache_len)
        synchronize(self.device)
        prefill_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        toks = torch.empty((n_new, b), dtype=torch.long, device=self.device)
        toks[0] = sample_token(logits, temperature, self._gen.manual_seed(seed))
        if step is not None:
            self._shapes["decode_scan"].add((b, n_new - 1, float(temperature)))
            step.start(toks[0], s)
            for i in range(1, n_new, BLOCK):
                n = min(BLOCK, n_new - i)
                toks[i:i + n] = step.run(n)
        toks = self._all_rows(toks, 1).T.cpu()      # the single host sync
        b = toks.shape[0]
        decode_s = time.perf_counter() - t0
        tps = (b * max(n_new - 1, 1)) / max(decode_s, 1e-9)
        return GenerateResult(tokens=toks, prefill_s=prefill_s,
                              decode_s=decode_s, tokens_per_s=tps)

    def generate_stream(self, tokens, n_new: int, *, temperature: float = 0.0,
                        seed: int = 0) -> GenerateResult:
        """Per-token decoding: the same decode step replayed, with one host
        sync per token, for per-token latency.  Emits the same tokens as
        ``generate``."""
        tokens, last_pos, cache_len = self._prompt(tokens, n_new)
        with self._on_mesh(tokens.shape[0]):
            return self._generate_stream(self._local_rows(tokens), last_pos, cache_len,
                                         n_new, temperature, seed)

    def _generate_stream(self, tokens, last_pos, cache_len, n_new, temperature, seed):
        b = tokens.shape[0]
        s = tokens.shape[1] if last_pos is None else last_pos + 1
        step = self._decoder(b, temperature) if n_new > 1 else None
        t0 = time.perf_counter()
        logits, _ = self._prefill(tokens, last_pos, cache_len)
        synchronize(self.device)
        prefill_s = time.perf_counter() - t0

        self._shapes["decode"].add(b)
        tok = sample_token(logits, temperature, self._gen.manual_seed(seed))
        out, walls = [tok.cpu()], []
        t0 = prev = time.perf_counter()
        if step is not None:
            step.start(tok, s)
        for _ in range(n_new - 1):
            step.replay()
            out.append(step.tok.to("cpu", copy=True))   # per-token latency
            now = time.perf_counter()
            walls.append(now - prev)
            prev = now
        decode_s = time.perf_counter() - t0
        toks = torch.stack(out, dim=1)
        if self._rows_cut > 1:
            toks = self._all_rows(toks.to(self.device), 0).cpu()
        b = toks.shape[0]
        tps = (b * max(n_new - 1, 1)) / max(decode_s, 1e-9)
        return GenerateResult(tokens=toks, prefill_s=prefill_s,
                              decode_s=decode_s, tokens_per_s=tps,
                              token_walls=walls)

    # ------------------------------------------------------------------
    def compile_stats(self) -> dict:
        """Distinct prefill shapes, per-token decode batches and fused
        decode lengths seen — the counterparts of the reference's jit-cache
        sizes, which its bucketing tests assert on — and the decode steps
        (``graphs``) and prefills (``prefill_graphs``) captured into CUDA
        graphs (0 on the CPU)."""
        return {**{k: len(v) for k, v in self._shapes.items()}, "graphs": self._captures,
                "prefill_graphs": self._prefill_captures}

    def stats(self) -> dict:
        return {"arch": self.cfg.name, "params": count_params(self.params),
                "load_s": self.load_s, "compile_s": self.compile_s}
