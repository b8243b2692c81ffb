"""Small cells for the CPU tests: the port's smoke shapes, float32, with a
short traffic mix, run through the same code as the benchmark's cells."""
from __future__ import annotations

import copy

from .cell import Cell, load_cell

DEEPSEEK = {"family": "dense", "hidden_size": 128, "intermediate_size": 256,
            "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 4,
            "head_dim": 32, "vocab_size": 512, "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
            "hidden_act": "silu", "tie_word_embeddings": False, "attention_bias": False,
            "torch_dtype": "float32"}
MISTRAL = {**DEEPSEEK, "num_key_value_heads": 2, "rope_theta": 1e6}

OPEN = {"driver": "open", "slots": 4, "max_seq": 128, "lead_in_s": 0.3, "rate_rps": 25.0, "order_seed": 1,
        "prompt": {"median": 20, "sigma": 0.8, "min": 4, "max": 60},
        "output": {"median": 8, "sigma": 0.6, "min": 2, "max": 16},
        "trace": {"start_s": 0.2, "min_s": 0.2, "min_admissions": 1},
        "check": {"served_tokens": 60, "max_requests": 8}}
BACKLOG = {**OPEN, "driver": "backlog", "requests": 48, "block": 8}

# for the control's test: deeper and wider
WIDE = {**DEEPSEEK, "hidden_size": 512, "intermediate_size": 1408, "num_hidden_layers": 8,
        "num_attention_heads": 8, "num_key_value_heads": 8, "head_dim": 64, "vocab_size": 8192}
WIDE_GQA = {**WIDE, "num_key_value_heads": 2, "rope_theta": 1e6}


def cell(name: str, config: dict, traffic: dict) -> Cell:
    """The benchmark's cell ``name`` (its metrics and limits) at a small
    size: ``config`` and ``traffic`` in place of its files."""
    c = load_cell(name)
    c.config, c.traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    return c
