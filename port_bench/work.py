"""The work a dense decoder's requests need, counted from the published sizes.

These counts are the benchmark's own and are frozen with it: they count what
the requests need (each prompt at its true length, each decode row at its
true position), not the shapes a program pads them to, so a roofline share
reads the same work whatever computes it and no change to the program can
lift a share above 100 %.  A matrix product of an (m, k) by a (k, n) operand
is 2 m k n operations.  Attention of one query over ``n`` keys is
4 H hd n operations a layer (scores and the weighted sum of values); a causal
prompt of ``n`` positions attends n (n + 1) / 2 (query, key) pairs.  Bytes
count each input read once and each output written once, in the served
dtype.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


@dataclass(frozen=True)
class Dims:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    elt: int = 2          # bytes of the served dtype

    @classmethod
    def of(cls, config: dict) -> "Dims":
        """From a configuration file's published keys."""
        heads = config["num_attention_heads"]
        head_dim = config.get("head_dim") or config["hidden_size"] // heads
        elt = {"bfloat16": 2, "float16": 2, "float32": 4}[config["torch_dtype"]]
        return cls(config["num_hidden_layers"], config["hidden_size"], heads,
                   config["num_key_value_heads"], head_dim, config["intermediate_size"],
                   config["vocab_size"], elt)


def matmul_params(m: Dims) -> int:
    """Weights of the layers' matrix products: q, k, v, o and the gated
    MLP's three (the norms' scales and the embedding tables not counted)."""
    attn = m.d_model * m.heads * m.head_dim * 2 + m.d_model * m.kv_heads * m.head_dim * 2
    return m.layers * (attn + 3 * m.d_model * m.d_ff)


def kv_bytes_per_token(m: Dims) -> int:
    """Keys and values of one position, over every layer."""
    return 2 * m.layers * m.kv_heads * m.head_dim * m.elt


def token_flops(m: Dims) -> int:
    """The layers' products for one token, attention's scores not counted."""
    return 2 * matmul_params(m)


def head_flops(m: Dims) -> int:
    """The unembedding of one position into the vocabulary."""
    return 2 * m.d_model * m.vocab


def attention_flops(m: Dims, pairs: int) -> int:
    """Attention over ``pairs`` (query, key) pairs, every layer."""
    return 4 * m.heads * m.head_dim * m.layers * pairs


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prompt_flops(m: Dims, n: int) -> int:
    """A prompt of ``n`` tokens admitted: every position through the layers,
    causal attention, and the unembedding of its last position (the first
    served token)."""
    return n * token_flops(m) + attention_flops(m, causal_pairs(n)) + head_flops(m)


def decode_flops(m: Dims, rows: int, keys: int) -> int:
    """One decode step of ``rows`` sequences whose new tokens attend ``keys``
    positions in all (each row its position + 1)."""
    return rows * (token_flops(m) + head_flops(m)) + attention_flops(m, keys)


def decode_attention(m: Dims, rows: int, keys: int) -> tuple[int, int]:
    """(operations, bytes) of a decode step's attention, every layer: the
    valid keys and values of each row read, its query read and its output
    written."""
    flops = attention_flops(m, keys)
    nbytes = m.layers * m.elt * (2 * m.kv_heads * m.head_dim * keys
                                 + 2 * rows * m.heads * m.head_dim)
    return flops, nbytes


def prefill_attention(m: Dims, lengths) -> tuple[int, int]:
    """(operations, bytes) of causal attention over prompts of ``lengths``,
    every layer: q, k and v read and the output written at each prompt's
    true length."""
    flops = attention_flops(m, sum(causal_pairs(n) for n in lengths))
    per_position = 2 * m.heads * m.head_dim + 2 * m.kv_heads * m.head_dim
    return flops, m.layers * m.elt * per_position * sum(lengths)


def peaks(device_kind: str) -> dict | None:
    """The published peaks of the card named ``device_kind`` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card the table
    lacks."""
    table = json.loads(PEAKS.read_text())
    for key, row in table.items():
        if key in device_kind:
            return row
    return None


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    """The least time a call could take: its operations at the bf16 peak or
    its bytes at the memory's rate, whichever is longer."""
    return max(flops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])
