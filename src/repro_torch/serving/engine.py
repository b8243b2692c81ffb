"""InferenceEngine: the model-serving runtime, on the card.

Wraps the ported families (dense, and ssm: RWKV-6) behind a prefill and an
eager decode loop.  Dense prompt lengths are bucketed to powers of two, so the
number of distinct prefill shapes grows with the number of buckets, not of
prompt lengths; recurrent (ssm) prompts keep their exact length, since pad
tokens would advance the state (``compile_stats`` counts the shapes, as the
reference counts its jit caches).  The family's cache (a KV cache of
``max_cache`` positions, or the recurrent state) is preallocated, reused while
the batch size holds and updated in place (the counterpart of the
reference's donated cache).  Decode samples on the device and syncs with the
host once, at the end; ``generate_stream`` is the per-token loop with a sync
per token, for per-token latency.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import resolve_device, synchronize
from repro_torch.models import api
from repro_torch.models.common import ModelConfig, count_params
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


class InferenceEngine:
    def __init__(self, cfg: ModelConfig, *, seed: int = 0, max_cache: int = 256,
                 params: dict | None = None, device="cuda"):
        """``params`` (from ``repro_torch.models.convert.from_reference``, or
        another engine's) replaces the seeded random draw."""
        self.cfg = cfg
        self.max_cache = max_cache
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = api.init_params(cfg, gen, self.device)
        self.params = params
        synchronize(self.device)
        self.load_s = time.perf_counter() - t0
        self._cache = None   # the family's cache at batch B, reused while B holds
        self._shapes = {"prefill": set(), "decode": set(), "decode_scan": set()}
        self.compiled = False
        self.compile_s = 0.0

    # ------------------------------------------------------------------
    def _cache_for(self, batch: int) -> dict:
        """The preallocated cache (every family keeps the batch on axis 1)."""
        if self._cache is None or next(iter(self._cache.values())).shape[1] != batch:
            self._cache = None   # free the old one before allocating
            self._cache = api.init_cache(self.cfg, batch, self.max_cache,
                                         device=self.device)
        return self._cache

    def _prefill(self, tokens, last_pos, cache_len: int):
        b, s = tokens.shape
        self._shapes["prefill"].add((b, s, cache_len, last_pos is None))
        return api.prefill(self.params, {"tokens": tokens}, self.cfg, cache_len,
                           last_pos=last_pos, cache=self._cache_for(b))

    def _decode(self, cache, token, pos: int):
        return api.decode_step(self.params, cache, token, pos, self.cfg)

    def _prompt(self, tokens, n_new: int):
        """The prompt on the device, right-padded to its bucket, the
        position whose logits are the last token's (None: the last), and
        the cache length."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        s = tokens.shape[1]
        s_pad, cache_len = self._prefill_shapes(s, n_new)
        if s_pad > s:
            tokens = F.pad(tokens, (0, s_pad - s))
        return tokens, (s - 1 if s_pad > s else None), cache_len

    # ------------------------------------------------------------------
    def warmup(self, batch: int, prompt_len: int):
        """Run both steps once (builds the kernels on first use on the card)
        — the modern 'cold start'."""
        t0 = time.perf_counter()
        tokens = torch.zeros((batch, prompt_len), dtype=torch.long, device=self.device)
        _, cache = self._prefill(tokens, None, self.max_cache)
        self._shapes["decode"].add(batch)
        self._decode(cache, torch.zeros((batch,), dtype=torch.long, device=self.device),
                     prompt_len)
        synchronize(self.device)
        self.compile_s = time.perf_counter() - t0
        self.compiled = True
        return self.compile_s

    def _prefill_shapes(self, s: int, n_new: int) -> tuple:
        """(padded_prompt_len, cache_len) — the shape policy.

        dense: prompts pad to a power-of-two bucket and the cache is always
        ``max_cache``, so shapes vary per bucket, not per (s, n_new).
        ssm: exact prompt lengths (pad tokens would advance the recurrent
        state) and the reference's cache length, which the O(1) state
        ignores but the reference's prefill jit is keyed on."""
        if self.cfg.family == "dense":
            return min(bucket_len(s), self.max_cache), self.max_cache
        return s, min(self.max_cache, s + n_new)

    # ------------------------------------------------------------------
    def generate(self, tokens, n_new: int, *, temperature: float = 0.0,
                 seed: int = 0) -> GenerateResult:
        """tokens: (B, S) prompt (tensor, array or nested list).  Greedy or
        temperature decoding of n_new tokens; one host sync for the decode."""
        tokens, last_pos, cache_len = self._prompt(tokens, n_new)
        b = tokens.shape[0]
        s = tokens.shape[1] if last_pos is None else last_pos + 1
        t0 = time.perf_counter()
        logits, cache = self._prefill(tokens, last_pos, cache_len)
        synchronize(self.device)
        prefill_s = time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        t0 = time.perf_counter()
        toks = torch.empty((b, n_new), dtype=torch.long, device=self.device)
        tok = sample_token(logits, temperature, gen)
        toks[:, 0] = tok
        if n_new > 1:
            self._shapes["decode_scan"].add((b, n_new - 1, float(temperature)))
        for i in range(n_new - 1):
            logits, cache = self._decode(cache, tok, s + i)
            tok = sample_token(logits, temperature, gen)
            toks[:, i + 1] = tok
        toks = toks.cpu()      # the single host sync
        decode_s = time.perf_counter() - t0
        tps = (b * max(n_new - 1, 1)) / max(decode_s, 1e-9)
        return GenerateResult(tokens=toks, prefill_s=prefill_s,
                              decode_s=decode_s, tokens_per_s=tps)

    def generate_stream(self, tokens, n_new: int, *, temperature: float = 0.0,
                        seed: int = 0) -> GenerateResult:
        """Per-token decoding: one host sync per token, for per-token
        latency.  Emits the same tokens as ``generate``."""
        tokens, last_pos, cache_len = self._prompt(tokens, n_new)
        b = tokens.shape[0]
        s = tokens.shape[1] if last_pos is None else last_pos + 1
        t0 = time.perf_counter()
        logits, cache = self._prefill(tokens, last_pos, cache_len)
        synchronize(self.device)
        prefill_s = time.perf_counter() - t0

        gen = torch.Generator(device=self.device).manual_seed(seed)
        self._shapes["decode"].add(b)
        tok = sample_token(logits, temperature, gen)
        out, walls = [tok.cpu()], []
        t0 = prev = time.perf_counter()
        for i in range(n_new - 1):
            logits, cache = self._decode(cache, tok, s + i)
            tok = sample_token(logits, temperature, gen)
            out.append(tok.cpu())                     # per-token latency
            now = time.perf_counter()
            walls.append(now - prev)
            prev = now
        decode_s = time.perf_counter() - t0
        tps = (b * max(n_new - 1, 1)) / max(decode_s, 1e-9)
        return GenerateResult(tokens=torch.stack(out, dim=1), prefill_s=prefill_s,
                              decode_s=decode_s, tokens_per_s=tps,
                              token_walls=walls)

    # ------------------------------------------------------------------
    def compile_stats(self) -> dict:
        """Distinct prefill shapes, per-token decode batches and fused
        decode lengths seen — the counterparts of the reference's jit-cache
        sizes, which its bucketing tests assert on."""
        return {k: len(v) for k, v in self._shapes.items()}

    def stats(self) -> dict:
        return {"arch": self.cfg.name, "params": count_params(self.params),
                "load_s": self.load_s, "compile_s": self.compile_s}
