#!/usr/bin/env python3
"""Time K5 (``adamw_update`` of ``src/repro_torch/csrc/adamw.cu``) against its
traffic probe, on one NVIDIA GPU.

    python3 tools/k5_probe.py [--cu PATH ...]

For each source (the tree's ``adamw.cu``, then each ``--cu``, such as a
parent checkout's with the same leaf table and C interface) it builds, into
``build/k5_probe/``, the kernel as it is and two variants made by editing
the text of ``adamw1``, the update of one element:
  probe        the arithmetic taken out: p, mu and nu stored as loaded (kept
               opaque to the compiler), so the time is what the kernel's
               loads, stores, tiles and launches alone take;
  no shortcut  where the source has them, ``div_rn``/``sqrt_rn`` replaced by
               the plain ``__fdiv_rn``/``__fsqrt_rn`` (a zero operand then
               takes the divisions' slow path).
Each is timed by CUDA events (10 calls after 2, in turns, then in reverse)
at deepseek-7b's 20-layer training leaves, seeded as ``chip_smoke.py``
phase 6, on three sets of data: random; the embedding rows that a step's
2048 tokens leave untouched zero (gradient and moments); every gradient and
moment zero.  Each time is printed with its rate (22 bytes a param) and its
multiple of the bound (those bytes at 3.35 TB/s), with ptxas's registers and
spills, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.optim import adamw  # noqa: E402

OUT = ROOT / "build" / "k5_probe"
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
HBM_BYTES_PER_S = 3.35e12


def adamw1_body(src: str) -> tuple[int, int]:
    """The span of ``adamw1``'s body, braces included."""
    open_ = src.index("{", src.index("void adamw1("))
    return open_, src.index("\n}\n", open_) + 2


def variants(src: str) -> dict[str, str]:
    a, b = adamw1_body(src)
    out = {"as is": src,
           "probe": src[:a] + '{\n  asm volatile("" : "+f"(p), "+f"(mu), "+f"(nu) : "f"(g), '
                    '"f"(scale), "f"(lr), "f"(b1c), "f"(b2c));\n}' + src[b:]}
    body = re.sub(r"(?<!__f)sqrt_rn\(", "__fsqrt_rn(", re.sub(r"(?<!__f)div_rn\(", "__fdiv_rn(",
                                                              src[a:b]))
    if body != src[a:b]:
        out["no shortcut"] = src[:a] + body + src[b:]
    return out


def build_all(sources: dict[str, str]) -> dict[str, object]:
    """{name: source text} -> {name: the library's repro_adamw_update}, one
    nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu = OUT / f"v{i}.cu"
        cu.write_text(text)
        cmd = [build.nvcc(), *build.FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), cu)
    like = adamw._kernel("repro_adamw_update")
    fns = {}
    for name, (proc, cu) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, l in enumerate(lines) if "Compiling entry" in l and "adamw_update" in l)
        print(f"[ptxas] {name}: " + "; ".join(l.split(":", 1)[-1].strip()
                                               for l in lines[at + 1:at + 4]
                                               if "spill" in l or "registers" in l), flush=True)
        fn = getattr(ctypes.CDLL(str(cu.with_suffix(".so"))), "repro_adamw_update")
        fn.argtypes, fn.restype = like.argtypes, like.restype
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cu", nargs="*", default=[], help="other adamw.cu sources to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k5_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sources = {}
    for tag, path in [("tree", build.CSRC / "adamw.cu")] + [(p, Path(p)) for p in args.cu]:
        for v, text in variants(path.read_text()).items():
            sources[f"{tag}, {v}"] = text
    fns = build_all(sources)

    from repro_torch.configs.registry import get
    from repro_torch.models import api
    from repro_torch.models.common import tensor_leaves

    dev = torch.device("cuda")
    cfg = get("deepseek-7b").config.replace(num_layers=20)
    gen = torch.Generator(device=dev).manual_seed(23)
    params = list(tensor_leaves(api.init_params(cfg, gen, dev)))
    grads = [torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * 1e-3 for p in params]
    mu = [torch.randn(p.shape, generator=gen, device=dev) * 1e-3 for p in params]
    nu = [torch.randn(p.shape, generator=gen, device=dev).square_().mul_(1e-6) for p in params]
    scalars = torch.tensor([0.7, 3e-4, 0.271, 0.142625], device=dev)
    nbytes = sum(p.numel() * (2 * p.element_size() + g.element_size() + 16)
                 for p, g in zip(params, grads))
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[leaves] {cfg.name}, {cfg.num_layers} layers: {len(params)} leaves, "
          f"{sum(p.numel() for p in params) / 1e9:.3f} B params, {nbytes / 1e9:.1f} GB moved, "
          f"bound {bound_ms:.3f} ms", flush=True)

    def ms(fn, iters=10, warm=2):
        adamw._fns["repro_adamw_update"] = fn
        for _ in range(warm):
            adamw.adamw_update(params, grads, mu, nu, scalars, **HYPER)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            adamw.adamw_update(params, grads, mu, nu, scalars, **HYPER)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def times(data: str) -> None:
        got = {name: [] for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                got[name].append(ms(fns[name]))
        for name, t in got.items():
            print(f"[time] {data}: {name}: " + " / ".join(f"{x:.3f}" for x in t) + " ms; "
                  f"{nbytes / min(t) / 1e9:.3f} TB/s, {min(t) / bound_ms:.3f} x the bound",
                  flush=True)

    times("random")
    rows = params[0].shape[0]
    touched = torch.zeros(rows, dtype=torch.bool, device=dev)
    touched[torch.randint(0, rows, (2048,), generator=gen, device=dev)] = True
    for t in (grads[0], mu[0], nu[0]):
        t[~touched] = 0
    times(f"embedding rows untouched by 2048 tokens zero ({int((~touched).sum())} of {rows})")
    for t in grads + mu + nu:
        t.zero_()
    times("every gradient and moment zero")
    return 0


if __name__ == "__main__":
    sys.exit(main())
