"""The one generator that every traffic file (``traffic/<name>.json``) feeds.

Kinds (``driver``):

* ``open``: requests fall due at the arrival times of a Poisson process at
  ``rate_rps``, from the lead-in's start up to the window's end, each with a
  prompt and an output length drawn from its clipped lognormal.  Times and
  lengths are one draw from the file's ``order_seed``, the same for every
  run; the seed rotates the window's part of it by a time offset, modulo the
  window's length.  So every seed is offered the same requests, with the
  same bursts and lulls between them, from another point of the draw: a
  Poisson process on a circle stays one under rotation.  (A tail such as a
  95th percentile of the time to first token swings by half between seeds
  that draw the arrivals anew.)
* ``backlog``: ``requests`` requests, all due at the lead-in's start, in
  blocks of ``block``.  Every block holds the same lengths, the block's
  stratified quantiles (u = (j + 0.5) / block) of the clipped lognormals,
  each block permuted once from the file's ``order_seed``.  The order is the
  same for every run: a window serves a prefix of the backlog, so an order
  drawn from the seed would change the work it serves (by about 2 % in
  tokens a second between seeds).

The prompts' token ids are drawn from the seed, and the weights too
(``families/``): every seed is another input on the same sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass(frozen=True)
class Item:
    rid: int
    due: float        # seconds from the lead-in's start
    prompt_len: int
    n_new: int


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, stream])


def _clip(spec: dict, raw: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def lengths(spec: dict, block: int) -> np.ndarray:
    """One backlog block's lengths: the clipped lognormal's stratified
    quantiles."""
    u = (np.arange(block) + 0.5) / block
    z = np.array([NormalDist().inv_cdf(x) for x in u])
    return _clip(spec, spec["median"] * np.exp(spec["sigma"] * z))


def drawn_lengths(spec: dict, n: int, rng) -> np.ndarray:
    """``n`` lengths drawn from the clipped lognormal, in chunks of 256 so
    that a longer schedule keeps a shorter one's lengths."""
    z = np.concatenate([rng.standard_normal(256) for _ in range(-(-n // 256))] or [[]])
    return _clip(spec, spec["median"] * np.exp(spec["sigma"] * z[:n]))


def poisson(rate_rps: float, duration_s: float, rng) -> list:
    """Arrival times in [0, ``duration_s``) of a Poisson process at
    ``rate_rps``: the loop of ``repro_torch.core.workload.poisson``'s
    scalar reference, on ``rng``."""
    t, times = 0.0, []
    while True:
        t += rng.exponential(1.0 / rate_rps)
        if t >= duration_s:
            return times
        times.append(float(t))


def _backlog(traffic: dict) -> list[Item]:
    block = traffic["block"]
    prompt_set = lengths(traffic["prompt"], block)
    output_set = lengths(traffic["output"], block)
    rng = _rng(traffic["order_seed"], 0)
    items = []
    while len(items) < traffic["requests"]:
        for p, o in zip(rng.permutation(prompt_set), rng.permutation(output_set)):
            items.append(Item(len(items), 0.0, int(p), int(o)))
    return items[:traffic["requests"]]


def schedule(traffic: dict, seed: int, seconds: float, rate: float | None = None) -> list[Item]:
    """The requests of one run: lead-in plus ``seconds`` of window.
    ``rate`` replaces the file's rate (the knee sweep's)."""
    kind = traffic["driver"]
    if kind == "backlog":
        return _backlog(traffic)
    if kind != "open":
        raise ValueError(f"unknown traffic driver {kind!r}")
    lead = traffic["lead_in_s"]
    order = traffic["order_seed"]
    times = poisson(rate or traffic["rate_rps"], lead + seconds, _rng(order, 0))
    prompt = drawn_lengths(traffic["prompt"], len(times), _rng(order, 1))
    output = drawn_lengths(traffic["output"], len(times), _rng(order, 2))
    offset = float(_rng(seed, 0).uniform(0.0, seconds))
    due = [t if t < lead else lead + (t - lead + offset) % seconds for t in times]
    order_by_due = sorted(range(len(times)), key=lambda j: due[j])
    return [Item(i, due[j], int(prompt[j]), int(output[j])) for i, j in enumerate(order_by_due)]


def prompts(items: list[Item], vocab: int, seed: int) -> list[list[int]]:
    """Each request's prompt: token ids uniform over the vocabulary."""
    rng = _rng(seed, 1)
    return [rng.integers(0, vocab, size=it.prompt_len).tolist() for it in items]


def buckets(traffic: dict, items: list[Item], bucket_of) -> list[int]:
    """The admission buckets the requests' prompt lengths reach, given the
    program's bucket of a length (clipped to the cache)."""
    return sorted({min(bucket_of(it.prompt_len), traffic["max_seq"]) for it in items})
