"""Markdown tables of the dry-run's records (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.analysis.report [--out artifacts/dryrun_torch]

The port's counterpart of ``repro/analysis/report.py``.  A rank fits when
its step's memory (``total_bytes_per_device``) is under the 80 GB of an
H100 80GB HBM3.  The records of ``dryrun --seq-parallel`` (tagged
``"seq_parallel": true``) get grids of their own, and ``seq_parallel_md``
sets each beside the flag-less record of its pair.
"""
from __future__ import annotations

import argparse

from repro_torch.analysis.roofline import load_records
from repro_torch.configs.base import SHAPES

HBM_GB = 80
TERM = {"compute": "c", "memory": "m", "collective": "l"}


def _key(r):
    return (r["arch"], r["shape"])


def _records(out_dir: str, seq_parallel: bool) -> list:
    """The records of runs with (or without) sequence parallelism."""
    return [r for r in load_records(out_dir) if bool(r.get("seq_parallel")) == seq_parallel]


def _hbm_gb(r) -> float:
    return r.get("memory", {}).get("total_bytes_per_device", 0) / 1e9


def roofline_md(out_dir: str, *, multi_pod: bool = False, seq_parallel: bool = False) -> str:
    recs = [r for r in _records(out_dir, seq_parallel)
            if bool(r.get("multi_pod")) == multi_pod]
    hdr = ("| arch | shape | compute_s | memory_s | collective_s | dominant "
           f"| useful | HBM GB/chip | fits {HBM_GB} GB |")
    rows = [hdr, "|" + "---|" * 9]
    for r in sorted(recs, key=_key):
        t = r["roofline"]
        mem = _hbm_gb(r)
        rows.append(f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} "
                    f"| {t['memory_s']:.3e} | {t['collective_s']:.3e} "
                    f"| **{t['dominant']}** | {t['useful_flops_ratio']:.2f} "
                    f"| {mem:.1f} | {'yes' if mem < HBM_GB else 'NO'} |")
    return "\n".join(rows)


def meshes_md(out_dir: str, *, seq_parallel: bool = False) -> str:
    """Both meshes' roofline in one grid, a row an arch and a column a
    shape: each cell the bound in seconds, its dominant term's initial
    (c, m, l: compute, memory, collective link) and the HBM GB a rank, on
    (16, 16), then after the slash on (2, 16, 16); of the runs with (or
    without) sequence parallelism."""
    by = {}
    for r in _records(out_dir, seq_parallel):
        by.setdefault(r["arch"], {}).setdefault(r["shape"], {})[bool(r.get("multi_pod"))] = r
    shapes = sorted({shape for row in by.values() for shape in row},
                    key=lambda k: list(SHAPES).index(k) if k in SHAPES else len(SHAPES))

    def cell(r) -> str:
        if r is None:
            return "-"
        t = r["roofline"]
        return f"{t['bound_time_s']:.3g} {TERM[t['dominant']]} {_hbm_gb(r):.1f}"

    rows = ["| arch | " + " | ".join(shapes) + " |", "|" + "---|" * (len(shapes) + 1)]
    for arch in sorted(by):
        rows.append(f"| {arch} | " + " | ".join(
            " / ".join(cell(by[arch].get(shape, {}).get(m)) for m in (False, True))
            if shape in by[arch] else "-" for shape in shapes) + " |")
    return "\n".join(rows)


def seq_parallel_md(out_dir: str) -> str:
    """Each pair's sequence-parallel record beside its flag-less one, a row
    an arch and a column a shape: each cell the HBM GB a rank and
    ``collective_s`` in ms, flag-less → with the flag, and the dominant
    term's initial (an arrow where it moved), on (16, 16), then after the
    slash on (2, 16, 16)."""
    recs = {(*_key(r), bool(r.get("multi_pod")), bool(r.get("seq_parallel"))): r
            for r in load_records(out_dir)}
    pairs = sorted({k[:2] for k in recs if k[3] and k[:3] + (False,) in recs})
    shapes = sorted({shape for _, shape in pairs},
                    key=lambda k: list(SHAPES).index(k) if k in SHAPES else len(SHAPES))

    def moved(a, b, fmt) -> str:
        return fmt(a) if a == b else f"{fmt(a)}→{fmt(b)}"

    def cell(arch, shape, multi) -> str:
        b, c = recs.get((arch, shape, multi, False)), recs.get((arch, shape, multi, True))
        if b is None or c is None:
            return "-"
        t, u = b["roofline"], c["roofline"]
        return (f"{moved(_hbm_gb(b), _hbm_gb(c), lambda v: f'{v:.1f}')} GB "
                f"{moved(t['collective_s'] * 1e3, u['collective_s'] * 1e3, lambda v: f'{v:.3g}')}"
                f" ms {moved(t['dominant'], u['dominant'], TERM.get)}")

    rows = ["| arch | " + " | ".join(shapes) + " |", "|" + "---|" * (len(shapes) + 1)]
    for arch in sorted({arch for arch, _ in pairs}):
        rows.append(f"| {arch} | " + " | ".join(
            " / ".join(cell(arch, shape, m) for m in (False, True)) for shape in shapes) + " |")
    return "\n".join(rows)


def dryrun_md(out_dir: str, *, seq_parallel: bool = False) -> str:
    recs = _records(out_dir, seq_parallel)
    single = [r for r in recs if not r.get("multi_pod")]
    multi = [r for r in recs if r.get("multi_pod")]
    lines = [f"* single-pod (16,16)=256 ranks: **{len(single)}** pairs run on meta tensors",
             f"* multi-pod (2,16,16)=512 ranks: **{len(multi)}** pairs run on meta tensors"]
    worst = sorted(single, key=lambda r: -r.get("lower_s", 0))[:3]
    lines.append("* slowest steps (single-pod): " + ", ".join(
        f"{r['arch']}x{r['shape']} {r['lower_s']:.1f}s" for r in worst))
    total_coll = sum(n for r in single for n in r["collectives"]["counts"].values())
    lines.append(f"* collectives counted (single-pod, a rank): {total_coll}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    print("## Dry-run summary\n")
    print(dryrun_md(args.out))
    print("\n## Roofline, single pod (16, 16)\n")
    print(roofline_md(args.out, multi_pod=False))
    print("\n## Roofline, multi-pod (2, 16, 16)\n")
    print(roofline_md(args.out, multi_pod=True))
    print("\n## Both meshes\n")
    print(meshes_md(args.out))
    if _records(args.out, True):
        print("\n## Sequence parallelism (--seq-parallel)\n")
        print(dryrun_md(args.out, seq_parallel=True))
        print("\n## Both meshes, sequence parallelism\n")
        print(meshes_md(args.out, seq_parallel=True))
        print("\n## Sequence parallelism beside the flag-less runs\n")
        print(seq_parallel_md(args.out))


if __name__ == "__main__":
    main()
