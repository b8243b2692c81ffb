"""The control comes out not correct: the reference computed in fp8, the
precision below the configurations' bf16, put in the program's place.  Its
readings at the cells' own sizes on the card are in PERF.md; here, at a size
a test run holds (eight layers of width 512), at each position of seeded
prompts the token the control puts first is read against the float32
reference's best, and the widest gap has to break each cell's limit, as the
program's tokens there have to keep to it."""
import numpy as np
import pytest

from port_bench import cell as cell_mod, smoke
from port_bench.families import dense
from port_bench.reference.dense import Reference

CELLS = [("deepseek-7b.chat-open", smoke.WIDE), ("mistral-nemo-12b.docs-backlog", smoke.WIDE_GQA)]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,config", CELLS, ids=["chat", "backlog"])
def test_the_fp8_control_fails_the_cells_limit(name, config, seed):
    limit = cell_mod.load_cell(name).limits["widest_logit_gap"]
    w = dense.make_weights(config, seed, "cpu")
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, config["vocab_size"], 64).tolist() for _ in range(8)]
    ref = Reference(config, w).logits(seqs, [16] * 8)
    ctl = Reference(config, w, "fp8").logits(seqs, [16] * 8)
    gap = max(float((r.max(-1).values - r.gather(1, c.argmax(-1)[:, None])[:, 0]).max())
              for r, c in zip(ref, ctl))
    assert gap > limit
