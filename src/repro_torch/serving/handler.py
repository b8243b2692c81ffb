"""Bridge: the port's serving engine as a serverless function Handler.

The counterpart of ``repro.serving.handler``: the paper's cold/warm/cost
analysis applied to modern serving on the card.  The cold phases map to

    provision  -> sandbox / host provisioning     (the simulator's)
    bootstrap  -> torch + CUDA runtime import     (the simulator's constant)
    load       -> weight init + warm-up (kernel builds, first launches),
                  measured per engine

and the warm service time is the measured per-batch generate latency.
"""
from __future__ import annotations

import torch

from repro_torch.core.function import Handler
from repro_torch.models.common import ModelConfig, param_bytes
from repro_torch.serving.engine import InferenceEngine


def measure_engine(cfg: ModelConfig, *, batch: int = 2, prompt: int = 16,
                   n_new: int = 8, seed: int = 0, device="cuda") -> dict:
    """Real measurements of one engine on ``device`` (the card unless the
    caller asks for the CPU)."""
    eng = InferenceEngine(cfg, seed=seed, max_cache=prompt + n_new + 8, device=device)
    compile_s = eng.warmup(batch, prompt)
    res = eng.generate(torch.zeros((batch, prompt), dtype=torch.long), n_new)
    return {
        "load_s": eng.load_s,
        "compile_s": compile_s,
        "serve_batch_s": res.prefill_s + res.decode_s,
        "tokens_per_s": res.tokens_per_s,
        "package_mb": param_bytes(eng.params) / 1e6,
        "engine": eng,
    }


def llm_handler(cfg: ModelConfig, measured: dict | None = None,
                **measure_kw) -> Handler:
    """Ad-hoc handler from a one-off ``measure_engine`` pass.

    For registry models prefer ``repro_torch.core.calibration.modern_handler``,
    which reads the versioned per-model calibration cache (schema v2) and
    carries the measured ``ContinuousServer`` batch-efficiency curve.
    """
    m = measured or measure_engine(cfg, **measure_kw)
    return Handler(
        name=f"serve-{cfg.name}",
        base_cpu_seconds=float(m["serve_batch_s"]),
        # the framework import; weight init + warm-up are LOAD-phase work
        # so the staged cold-start model prices them per tier
        bootstrap_cpu_seconds=1.0,
        package_mb=min(float(m["package_mb"]), 510.0),
        peak_memory_mb=128.0,
        load_cpu_seconds=float(m["load_s"]) + float(m["compile_s"]),
    )
