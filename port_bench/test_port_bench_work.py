"""The counts of operations and bytes against hand-worked numbers."""
import json
from pathlib import Path

import pytest

from port_bench import work

HERE = Path(__file__).resolve().parent


def dims(name):
    return work.Dims.of(json.loads((HERE / "configs" / f"{name}.json").read_text()))


@pytest.mark.parametrize("name,params,kv", [
    # 30 x (4 x 4096^2 + 3 x 4096 x 11008)
    ("deepseek-7b", 6_071_255_040, 491_520),
    # 40 x (2 x 5120 x 4096 + 2 x 5120 x 1024 + 3 x 5120 x 14336)
    ("mistral-nemo-12b", 10_905_190_400, 163_840),
])
def test_parameters_and_cache_bytes(name, params, kv):
    m = dims(name)
    assert work.matmul_params(m) == params
    assert work.kv_bytes_per_token(m) == kv
    assert work.token_flops(m) == 2 * params


def test_prompt_and_decode_operations_of_deepseek():
    m = dims("deepseek-7b")
    n = 160
    attn = 4 * 32 * 128 * 30 * (160 * 161 // 2)
    assert work.prompt_flops(m, n) == 160 * 2 * 6_071_255_040 + attn + 2 * 4096 * 102400
    # two rows at positions 99 and 199: 100 + 200 keys
    assert work.decode_flops(m, 2, 300) == 2 * (2 * 6_071_255_040 + 2 * 4096 * 102400) + 4 * 32 * 128 * 30 * 300


def test_decode_attention_reads_the_valid_cache_once():
    m = dims("mistral-nemo-12b")
    flops, nbytes = work.decode_attention(m, 4, 4000)
    assert flops == 4 * 32 * 128 * 40 * 4000
    # k and v of 4000 positions, 8 kv heads; q and o of 4 rows, 32 heads; bf16
    assert nbytes == 40 * 2 * (2 * 8 * 128 * 4000 + 2 * 4 * 32 * 128)
    assert work.least_seconds(flops, nbytes, work.peaks("NVIDIA H100 80GB HBM3")) == pytest.approx(nbytes / 3.35e12)


def test_prefill_attention_at_true_lengths():
    m = dims("mistral-nemo-12b")
    flops, nbytes = work.prefill_attention(m, [1024, 300])
    assert flops == 4 * 32 * 128 * 40 * (1024 * 1025 // 2 + 300 * 301 // 2)
    assert nbytes == 40 * 2 * (2 * 32 * 128 + 2 * 8 * 128) * 1324
    # a 1024-token prompt's attention is bound by its operations
    assert work.least_seconds(flops, nbytes, work.peaks("NVIDIA H100 PCIe")) == pytest.approx(flops / 989e12)


def test_peaks_of_an_unknown_card_are_none():
    assert work.peaks("cpu") is None
