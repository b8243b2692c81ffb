"""Whether what the timed path served is correct.

After the window, a sample of the requests it finished, drawn from the seed
and holding the longest of them, is run once through the plain reference
over each prompt and its served tokens.  Each served token's logit is read
against the reference's best at its position; the widest gap over the sample
is held to the cell's limit (``limits/<cell>.json``), and every sampled
request has to have been served all the tokens it asked for.
"""
from __future__ import annotations

import numpy as np
import torch


def sample(records, served: dict, seed: int, tokens: int, most: int) -> list:
    """Finished requests: the longest (prompt plus served), then others in
    the seed's order until ``tokens`` served tokens or ``most`` requests."""
    done = [r for r in records if r.finished and r.rid in served]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + r.n_new, -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed % 2 ** 64, 3])
    picked, n = [longest], longest.n_new
    for j in rng.permutation(len(rest)):
        if n >= tokens or len(picked) >= most:
            break
        picked.append(rest[j])
        n += rest[j].n_new
    return picked


def gaps(reference, prompts: dict, served: dict, picked: list, control=None) -> dict:
    """-> {"widest_gap", "per_request", "tokens", "requests",
    "short_answers"}: the widest
    gap by which a served token's logit lies below the reference's best, over
    the picked requests.  With ``control`` (a lower-precision reference) also
    ``control_gap``: the widest gap of the tokens the control puts first at
    the same positions."""
    seqs = [list(prompts[r.rid]) + list(served[r.rid][:-1]) for r in picked]
    starts = [len(prompts[r.rid]) - 1 for r in picked]
    ref = reference.logits(seqs, starts)
    ctl = control.logits(seqs, starts) if control is not None else None
    per, per_ctl, n = [], [], 0
    for j, r in enumerate(picked):
        tok = torch.as_tensor(served[r.rid], device=ref[j].device)
        best = ref[j].max(dim=-1).values
        per.append(float((best - ref[j].gather(1, tok[:, None])[:, 0]).max()))
        n += len(tok)
        if ctl is not None:
            pick = ctl[j].argmax(dim=-1)
            per_ctl.append(float((best - ref[j].gather(1, pick[:, None])[:, 0]).max()))
    out = {"widest_gap": max(per, default=0.0), "per_request": per, "tokens": n,
           "requests": len(picked),
           "short_answers": sum(len(served[r.rid]) != r.n_new for r in picked)}
    if ctl is not None:
        out["control_gap"] = max(per_ctl, default=0.0)
    return out


def verdict(result: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}): the widest gap at most its
    limit, no short answer, and at least one request compared."""
    checks = {
        "widest_logit_gap": {"value": result.get("widest_gap"), "limit": limits["widest_logit_gap"]},
        "short_answers": {"value": result.get("short_answers"), "limit": 0},
        "requests_compared": {"value": result.get("requests", 0), "limit": 1},
    }
    ok = (result.get("requests", 0) >= 1 and result["short_answers"] == 0
          and result["widest_gap"] <= limits["widest_logit_gap"])
    return ok, checks
