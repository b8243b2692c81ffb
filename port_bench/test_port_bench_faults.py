"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at the
smoke shapes, with each fault a served cell can have planted in the port's
``ContinuousServer``.  (One card: there is no exchange between chips.)"""
import time

import numpy as np
import pytest

from port_bench import cell as cell_mod, smoke
from repro_torch.serving import continuous

ORIGINAL = continuous.ContinuousServer._run_chunk


def unchanged(self, n):
    """The step returns its state unchanged: each slot's last token again."""
    ORIGINAL(self, n)
    return np.tile(self.last_tok, (n, 1))


def half_left_out(self, n):
    """The step leaves half of the batch out: every second active slot keeps
    its last token."""
    toks = ORIGINAL(self, n).copy()
    out = np.flatnonzero(self.active)[1::2]
    toks[:, out] = self.last_tok[out]
    return toks


def altered(self, n):
    """A token altered where it is produced: every third step's tokens."""
    toks = ORIGINAL(self, n).copy()
    if self.steps % 3 == 0:
        toks = (toks + 1) % self.cfg.vocab_size
    return toks


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name,config,traffic", [
    ("deepseek-7b.chat-open", smoke.DEEPSEEK, smoke.OPEN),
    ("mistral-nemo-12b.docs-backlog", smoke.MISTRAL, smoke.BACKLOG)], ids=["chat", "backlog"])
def test_a_broken_step_is_not_correct(monkeypatch, fault, name, config, traffic):
    monkeypatch.setattr(continuous.ContinuousServer, "_run_chunk", fault)
    c = smoke.cell(name, config, traffic)
    line = cell_mod.run_cell(c, 2 ** 31 + 5, 1.5, False, "cpu", time.perf_counter())
    assert not line["correct"]
    assert line["checks"]["widest_logit_gap"]["value"] > c.limits["widest_logit_gap"]
