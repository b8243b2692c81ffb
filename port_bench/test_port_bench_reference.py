"""The reference against the port on the CPU at the smoke shapes: its logits
against the port's own prefill, and the whole harness (traffic, window,
sample, check) on the port's ContinuousServer."""
import time

import pytest
import torch

from port_bench import cell as cell_mod, smoke
from port_bench.families import dense
from port_bench.reference.dense import Reference

CELLS = [("deepseek-7b.chat-open", smoke.DEEPSEEK, smoke.OPEN),
         ("mistral-nemo-12b.docs-backlog", smoke.MISTRAL, smoke.BACKLOG)]


@pytest.mark.parametrize("config", [smoke.DEEPSEEK, smoke.MISTRAL], ids=["deepseek", "mistral"])
def test_reference_logits_equal_the_ports_prefill(config):
    from repro_torch.models import transformer
    w = dense.make_weights(config, 2 ** 31 + 3, "cpu")
    cfg = dense.program_config(config, "smoke")
    seqs = [[5, 17, 300, 2, 9, 44, 101], list(range(40, 80))]
    ref = Reference(config, w).logits(seqs, [0, 0])
    for s, r in zip(seqs, ref):
        logits, _ = transformer.forward(dense.program_params(w), torch.tensor([s]), cfg)
        assert torch.allclose(logits[0].float(), r, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name,config,traffic", CELLS, ids=["chat", "backlog"])
def test_harness_on_the_ports_server_is_correct(name, config, traffic):
    c = smoke.cell(name, config, traffic)
    line = cell_mod.run_cell(c, 2 ** 31 + 77, 1.5, False, "cpu", time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["checks"]["widest_logit_gap"]["value"] <= 1e-4
    assert line["checks"]["requests_compared"]["value"] >= 3
    assert set(line["metrics"]) == set(c.end_to_end)
    assert list(line)[-1] == "checks"


def test_traced_run_reports_the_host_span_metrics():
    c = smoke.cell(*CELLS[0])
    line = cell_mod.run_cell(c, 5, 1.5, True, "cpu", time.perf_counter())
    assert line["correct"]
    # on the CPU no kernel runs: the device's metrics find nothing to read
    assert {"admission_ms.chat", "decode_step_ms.chat"} <= set(line["metrics"])
    assert not {"k2_roofline.chat", "mfu.chat"} & set(line["metrics"])
    assert line["device"]["window_s"] > 0
