"""Three-term roofline of the dry-run's records, against one NVIDIA H100.

    compute term    = FLOPs a rank / PEAK_FLOPS_BF16
    memory term     = bytes a rank / HBM_BW
    collective term = collective bytes a rank / NVLINK_BW

The port's counterpart of ``repro/analysis/roofline.py``.  The numerators
are one rank's, counted while its step ran on meta tensors
(``analysis/count.py``: the aten ops' FLOPs and bytes plus each kernel's
own; ``shardctx``'s collective bytes, a rank's ring bytes), so each term
is a rank's seconds.  The constants are the data sheet's
(``launch/mesh.py``): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s of
NVLink 4 a direction.  A 16-wide model axis spans two 8-card NVLink nodes
on H100 systems, so part of its ring crosses the slower network between
nodes, and ``collective_s`` at the NVLink rate is a lower bound; so is the
compute term of float32 work, taken at the bf16 peak.

``model_flops`` is the reference's: 6 N D for a train step (2 N forward,
4 N backward), 2 N D for a prefill, 2 N B for a decode step, N the active
parameters, D the global tokens.  ``useful_flops_ratio`` holds it against
the counted FLOPs of every rank.
"""
from __future__ import annotations

import json
import os

from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.models.common import ModelConfig


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    n_active = cfg.param_count(active_only=True)
    if kind == "train":
        tokens = batch * seq
        return 6.0 * n_active * tokens            # 2*N fwd + 4*N bwd
    if kind == "prefill":
        tokens = batch * seq
        return 2.0 * n_active * tokens
    if kind == "decode":
        return 2.0 * n_active * batch             # one token per sequence
    return 0.0


def roofline_terms(cfg, meta: dict, counted: dict, collective_bytes: float, *,
                   batch: int | None = None, seq: int | None = None) -> dict:
    """``counted``: a rank's ``flops`` and ``bytes`` (``count.count_step``);
    ``collective_bytes``: the bytes its links move in the step; ``batch``
    and ``seq``: the run's, where they are not the shape's."""
    chips = meta.get("n_devices", 1)
    flops_per_chip = float(counted.get("flops", 0.0))
    terms = {"compute_s": flops_per_chip / PEAK_FLOPS_BF16,
             "memory_s": float(counted.get("bytes", 0.0)) / HBM_BW,
             "collective_s": float(collective_bytes) / NVLINK_BW}
    dom = max(terms, key=terms.get)
    shp = SHAPES.get(meta.get("shape", ""))
    mf = 0.0
    if shp is not None and cfg.family != "cnn":
        mf = model_flops(cfg, meta.get("kind", shp.kind), batch or shp.global_batch,
                         seq or shp.seq_len)
    hlo_flops_global = flops_per_chip * chips
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "model_flops": mf,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (mf / hlo_flops_global) if hlo_flops_global else 0.0,
        "bound_time_s": max(terms.values()),
    }


def load_records(out_dir: str = "artifacts/dryrun_torch") -> list:
    recs = []
    if not os.path.isdir(out_dir):
        return recs
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                recs.append(json.load(f))
    return recs


def table(recs: list) -> str:
    """A markdown roofline table of the records."""
    hdr = ("| arch | shape | mesh | compute_s | memory_s | collective_s | "
           "dominant | useful_FLOPs | bytes/chip |")
    rows = [hdr, "|" + "---|" * 9]
    for r in recs:
        t = r.get("roofline", {})
        mem = r.get("memory", {}).get("total_bytes_per_device", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | {'x'.join(map(str, r['mesh']))} "
            f"| {t.get('compute_s', 0):.3e} | {t.get('memory_s', 0):.3e} "
            f"| {t.get('collective_s', 0):.3e} | {t.get('dominant', '?')} "
            f"| {t.get('useful_flops_ratio', 0):.2f} | {mem / 1e9:.2f}GB |")
    return "\n".join(rows)
