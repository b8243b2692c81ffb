"""Deterministic synthetic data pipelines (LM token streams + image batches):
the reference's ``repro/train/data.py``, numpy arrays bit for bit.

A seeded, stateless pipeline: batch ``i`` is a pure function of (seed, i) so
training runs are reproducible and resumable from any step without
checkpointing the pipeline.  The LM stream is a Zipf-ish token distribution
with a simple Markov structure so cross-entropy has learnable signal.
"""
from __future__ import annotations

import numpy as np


class LMBatches:
    def __init__(self, vocab_size: int, batch: int, seq: int, *, seed: int = 0,
                 alpha: float = 1.2):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-alpha)
        self.probs = p / p.sum()

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        base = rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                          p=self.probs)
        # Markov-ish structure: with prob .5 next token = f(prev) (learnable)
        mask = rng.random((self.batch, self.seq)) < 0.5
        nxt = (base[:, :-1] * 31 + 7) % self.vocab
        base[:, 1:] = np.where(mask, nxt, base[:, 1:])
        return {"tokens": base[:, :-1].astype(np.int32),
                "labels": base[:, 1:].astype(np.int32)}


class ImageBatches:
    def __init__(self, batch: int, size: int = 224, *, seed: int = 0):
        self.batch, self.size, self.seed = batch, size, seed

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        x = rng.standard_normal((self.batch, self.size, self.size, 3))
        y = rng.integers(0, 1000, size=(self.batch,))
        return {"images": x.astype(np.float32), "labels": y.astype(np.int32)}


def modal_extras(cfg, batch: int, *, seed: int = 0, step: int = 0) -> dict:
    """Stub frontend embeddings for audio/vlm training batches."""
    rng = np.random.default_rng((seed, step, 99))
    out = {}
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
    return out
