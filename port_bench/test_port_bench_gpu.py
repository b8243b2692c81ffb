"""The harness on the card at the smoke shapes, in the served dtype: the
port's kernels (K1, K2) and captured graphs under a short window, held to
the cells' limits.  Marked ``gpu``; skips without a card."""
import time

import pytest
import torch

from port_bench import cell as cell_mod, smoke


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("name,config,traffic", [
    ("deepseek-7b.chat-open", smoke.DEEPSEEK, smoke.OPEN),
    # the card drains the CPU tests' 48 requests within the lead-in: a backlog
    # has to outlast the window
    ("mistral-nemo-12b.docs-backlog", smoke.MISTRAL, {**smoke.BACKLOG, "requests": 4000})],
    ids=["chat", "backlog"])
def test_a_smoke_cell_on_the_card_is_correct(card, name, config, traffic):
    c = smoke.cell(name, {**config, "torch_dtype": "bfloat16"}, traffic)
    line = cell_mod.run_cell(c, 2 ** 31 + 9, 2.0, True, card, time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert line["checks"]["requests_compared"]["value"] >= 3
