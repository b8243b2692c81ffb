"""Calibration: measure the port's real serving to parameterize the
serverless simulator.

The counterpart of ``repro.core.calibration``.  The paper's CNN payloads
(``repro_torch.models.cnn``) are timed by forward passes, as the paper times
MXNet predictions inside Lambda; the registry language models by the port's
``InferenceEngine`` and ``ContinuousServer``.  On the card every model is
measured at its full config (the reference measures its language models at
their smoke configs, which fit a CPU host); ``smoke=True`` measures the smoke
configs instead (CNNs at 64 px), as the CPU tests do.

Cache schema (v2), the reference's, so that ``repro.core.calibration``'s
``paper_handler`` and ``modern_handler`` take this file through
``calibrated=``::

    {"schema_version": 2,
     "host": {"node": ..., "machine": ..., "system": ..., "python": ...,
              "torch": ..., "cuda": ..., "device": ..., "backend": ...,
              "configs": "full" | "smoke"},
     "models": {
       "<cnn>": {"kind": "cnn",
                 "warm_exec_s":  median replayed forward seconds, batch 1,
                 "first_call_s": the first forward's seconds: its warm-up
                                 (on the card cuDNN's set-up and the first
                                 loads of its kernels), its CUDA-graph
                                 capture and its first replay},
       "<llm>": {"kind": "llm",
                 "warm_exec_s": steady generate (prefill+decode) seconds,
                 "init_s":      param init wall seconds,
                 "compile_s":   warm-up wall: kernel builds, first launches and
                                the decode step's and the prefill's
                                CUDA-graph captures,
                 "package_mb":  parameter bytes / 1e6,
                 "tokens_per_s": steady decode throughput,
                 "batch_curve": [[batch, rel_per_request_cost], ...]
                                measured from ContinuousServer}}}

The fingerprint names torch, CUDA and the device where the reference's names
JAX, and records whether the configs were full or smoke, so each package's
strict ``load_cache`` refuses the other's file and a smoke measurement never
stands in for a full one: the simulator is never fed a mix of hosts without
being told (``repro.core.calibration.load_cache(path, strict=False)`` reads
this file).  The cache is ``artifacts/calibration_torch.json`` at the repo
root (never the reference's file), or the path the caller gives.

CLI::

    python -m repro_torch.core.calibration --models squeezenet deepseek-7b \
        [--force] [--path FILE] [--smoke --device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import platform as _platform
import time

import torch

from repro_torch import resolve_device, synchronize
from repro_torch.core.function import Handler, normalize_batch_curve
from repro_torch.models import cnn
from repro_torch.models.common import ModelConfig, param_bytes
from repro_torch.serving.graphs import ForwardGraph

SCHEMA_VERSION = 2

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))


def default_cal_path() -> str:
    return os.path.join(_REPO_ROOT, "artifacts", "calibration_torch.json")


# paper §3 ground truth per model: (package MB, peak memory MB, 2017-era
# full-CPU prediction seconds used with ``use_fallback``)
PAPER_MODELS = {
    "squeezenet": {"package_mb": 5.0, "peak_mb": 85.0, "fallback_s": 0.22},
    "resnet18": {"package_mb": 45.0, "peak_mb": 229.0, "fallback_s": 0.35},
    "resnext50": {"package_mb": 98.0, "peak_mb": 429.0, "fallback_s": 0.80},
}

# The simulator's assumptions, as the reference states them: the framework
# import at one full CPU (the modern BOOTSTRAP, in place of the paper's 1.2 s
# MXNet import) and each modern model's declared working set for deploy-time
# OOM validation.  They are not measured here.
MODERN_BOOTSTRAP_CPU_S = 1.0
MODERN_PEAK_MB = {"deepseek-7b": 512.0, "qwen2.5-32b": 512.0,
                  "qwen3-moe-235b-a22b": 768.0, "rwkv6-1.6b": 384.0,
                  "qwen1.5-110b": 768.0}


# ------------------------------------------------------------- cache schema
def host_fingerprint(device="cuda", smoke: bool = False) -> dict:
    """Identity of the measuring host, device and config scale.  A cache
    written under another fingerprint is refused (re-measured), never
    silently mixed in."""
    dev = resolve_device(device)
    return {"node": _platform.node(),
            "machine": _platform.machine(),
            "system": _platform.system(),
            "python": _platform.python_version(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "backend": dev.type,
            "configs": "smoke" if smoke else "full"}


def new_cache(device="cuda", smoke: bool = False) -> dict:
    return {"schema_version": SCHEMA_VERSION,
            "host": host_fingerprint(device, smoke), "models": {}}


def load_cache(path: str | None = None, *, strict: bool = True, device="cuda",
               smoke: bool = False):
    """Load a calibration cache, or None when it must be re-measured.

    Returns None for a missing or corrupt file, a schema version other than
    ``SCHEMA_VERSION``, or (under ``strict``, the default) a fingerprint
    other than this host's for ``device`` and ``smoke``: the reference's
    file among them."""
    path = path or default_cal_path()
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            raw = json.load(f)
    except (ValueError, OSError):
        return None
    if not isinstance(raw, dict) or \
            raw.get("schema_version") != SCHEMA_VERSION or \
            not isinstance(raw.get("models"), dict):
        return None
    if strict and raw.get("host") != host_fingerprint(device, smoke):
        return None
    return raw


def save_cache(cache: dict, path: str | None = None) -> str:
    path = path or default_cal_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    return path


# -------------------------------------------------------------- measurement
def _wall(device: torch.device, fn) -> float:
    """Seconds of ``fn()``, with the device synchronised before each clock
    read."""
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    return time.perf_counter() - t0


def _measure_cnn(cfg: ModelConfig, *, device: torch.device, repeats: int = 5,
                 seed: int = 0) -> dict:
    """One image (the paper's Lambda request) of zeros through the forward
    captured into a CUDA graph (``ForwardGraph``; eager on the CPU), the
    counterpart of the reference's jitted forward: the first call is the
    warm-up, the capture and the first replay (the reference's compile and
    first call), then the median of ``repeats`` replays."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = cnn.init_params(cfg, gen, device)
    img = torch.zeros((1, 3, cfg.image_size, cfg.image_size), dtype=torch.float32,
                      device=device)
    graph = ForwardGraph(img.shape, cfg.num_classes, device,
                         lambda images: cnn.forward(params, images, cfg))

    def first_call():
        graph.capture()
        graph.run(img)

    first = _wall(device, first_call)
    times = sorted(_wall(device, lambda: graph.run(img)) for _ in range(repeats))
    return {"kind": "cnn", "warm_exec_s": times[len(times) // 2],
            "first_call_s": first}


def _measure_batch_curve(cfg: ModelConfig, params: dict, *, device: torch.device,
                         batches=(1, 2, 4), prompt: int = 8, steps: int = 6) -> list:
    """Per-request fused-decode cost vs batch size, from the port's
    ``ContinuousServer`` on ``params``: pin exactly ``b`` active slots, take
    one untimed step (on the card it captures the server's decode step, so
    the capture is never timed), then time ``steps`` steps; each server is
    dropped before the next is made.  Points are normalized (rel cost at
    batch 1 = 1.0) and clamped monotone by ``normalize_batch_curve``."""
    from repro_torch.serving.continuous import ContinuousServer, Request
    points = []
    for b in batches:
        srv = ContinuousServer(cfg, slots=int(b), max_seq=prompt + steps + 4,
                               params=params, device=device)
        for i in range(int(b)):
            srv.submit(Request(rid=i, prompt=[1 + i] * prompt, n_new=steps + 3))
        srv.prefill_pending()
        if srv.n_active() != int(b):
            raise RuntimeError(f"batch curve: {srv.n_active()} slots active, "
                               f"{b} wanted")
        srv.step()
        wall = _wall(device, lambda: [srv.step() for _ in range(steps)]) / steps
        points.append((int(b), wall / b))       # per-request share
        del srv     # its cache and graphs go before the next server's are made
    return [[b, r] for b, r in normalize_batch_curve(points)]


def _measure_llm(cfg: ModelConfig, *, device: torch.device, prompt: int = 16,
                 n_new: int = 8, repeats: int = 3, seed: int = 0) -> dict:
    from repro_torch.serving.engine import InferenceEngine
    eng = InferenceEngine(cfg, seed=seed, max_cache=prompt + n_new + 8, device=device)
    compile_s = eng.warmup(1, prompt)
    toks = torch.zeros((1, prompt), dtype=torch.long)
    walls, tps = [], 0.0
    for _ in range(repeats):
        res = eng.generate(toks, n_new)
        walls.append(res.prefill_s + res.decode_s)
        tps = res.tokens_per_s
    walls.sort()
    curve = []
    if cfg.family in ("dense", "moe", "vlm"):
        # the engine's weights: the same seeded draw, not another copy.  A vlm
        # curve fails at its first admission, as the reference's does: the
        # continuous server hands the vlm prefill no patch embeddings
        curve = _measure_batch_curve(cfg, eng.params, device=device)
    return {"kind": "llm",
            "warm_exec_s": walls[len(walls) // 2],
            "init_s": eng.load_s,
            "compile_s": compile_s,
            "package_mb": param_bytes(eng.params) / 1e6,
            "tokens_per_s": tps,
            "batch_curve": curve}


def measure_model(name: str, *, smoke: bool = False, device="cuda",
                  **measure_kw) -> dict:
    """Measure one model on ``device`` (the card unless the caller asks for
    the CPU; raises when the card is asked for and there is none): a paper
    CNN or a language model of ``repro_torch.configs.registry``, at its full
    config, or at its smoke config with ``smoke``."""
    from repro_torch.configs import registry
    dev = resolve_device(device)
    try:
        spec = registry.get(name)
    except KeyError:
        raise KeyError(f"unknown model {name!r}; the port measures "
                       f"{sorted(registry.ALL)}") from None
    cfg = spec.smoke if smoke else spec.config
    if cfg.family == "cnn":
        return _measure_cnn(cfg, device=dev, **measure_kw)
    return _measure_llm(cfg, device=dev, **measure_kw)


# ---------------------------------------------------------------- calibrate
def calibrate(path: str | None = None, force: bool = False, *, models=None,
              smoke: bool = False, device="cuda") -> dict:
    """Load-or-measure the calibration cache; returns the full v2 cache.

    A cache that fails ``load_cache``'s version/fingerprint checks is
    re-measured from scratch.  ``models`` selects what must be present
    (default: the three paper CNNs); anything already measured is kept,
    anything missing is measured and the file updated.  No model is
    skipped: a measurement that fails raises."""
    path = path or default_cal_path()
    cache = None if force else load_cache(path, device=device, smoke=smoke)
    fresh = cache is None
    if fresh:
        cache = new_cache(device, smoke)
    wanted = list(models) if models is not None else list(PAPER_MODELS)
    missing = [m for m in wanted if m not in cache["models"]]
    for m in missing:
        cache["models"][m] = measure_model(m, smoke=smoke, device=device)
    if fresh or missing:
        save_cache(cache, path)
    return cache


def ensure_measured(cache, name: str, path: str | None = None, *,
                    smoke: bool = False, device="cuda") -> dict:
    """Return a cache that contains ``name``, measuring (and persisting)
    it if absent.  ``cache=None`` loads-or-creates first."""
    if cache is None:
        cache = load_cache(path, device=device, smoke=smoke) or new_cache(device, smoke)
    if name not in cache["models"]:
        cache["models"][name] = measure_model(name, smoke=smoke, device=device)
        save_cache(cache, path)
    return cache


# ----------------------------------------------------------------- handlers
def _entries(calibrated) -> dict:
    """Model entries of a v2 cache (the only schema the port reads)."""
    return {} if calibrated is None else calibrated["models"]


def paper_handler(variant: str, *, calibrated: dict | None = None,
                  use_fallback: bool = False) -> Handler:
    """A Handler for a paper CNN: its measured warm forward, or the paper's
    own figure with ``use_fallback`` or without a measurement."""
    info = PAPER_MODELS[variant]
    base = info["fallback_s"]
    if not use_fallback:
        base = (_entries(calibrated).get(variant) or {}).get("warm_exec_s", base)
    return Handler(
        name=variant,
        base_cpu_seconds=float(base),
        bootstrap_cpu_seconds=1.2,          # MXNet import + runtime init
        package_mb=info["package_mb"],
        peak_memory_mb=info["peak_mb"],
    )


def modern_handler(name: str, *, calibrated: dict | None = None) -> Handler:
    """A Handler for a registry language model, built from its measured
    entry: warm exec = steady generate, LOAD gains the measured param init
    and warm-up, and the ``ContinuousServer`` batch-efficiency curve rides
    along for the cluster's batching path.  The port pins no fallback
    numbers, so a model must have been measured."""
    entry = _entries(calibrated).get(name)
    if entry is None:
        raise KeyError(f"no measured calibration for {name!r}; measure it first "
                       f"via calibrate(models=[{name!r}])")
    peak = MODERN_PEAK_MB.get(name, max(128.0, 2.0 * float(entry["package_mb"]) + 64.0))
    curve = tuple((int(b), float(r)) for b, r in entry.get("batch_curve") or ())
    return Handler(
        name=name,
        base_cpu_seconds=float(entry["warm_exec_s"]),
        bootstrap_cpu_seconds=MODERN_BOOTSTRAP_CPU_S,
        package_mb=float(entry["package_mb"]),
        peak_memory_mb=float(peak),
        load_cpu_seconds=float(entry["init_s"]) + float(entry["compile_s"]),
        batch_curve=curve,
    )


# ---------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Measure models with the PyTorch port and update its "
                    "calibration cache (schema v2, host-fingerprinted).")
    ap.add_argument("--models", nargs="+", default=None, metavar="NAME",
                    help="paper CNNs and/or registry arch ids (default: "
                         "the three paper CNNs)")
    ap.add_argument("--path", default=None,
                    help="cache file (default: artifacts/calibration_torch.json)")
    ap.add_argument("--force", action="store_true",
                    help="discard any existing cache and re-measure")
    ap.add_argument("--smoke", action="store_true",
                    help="measure the smoke configs (CNNs at 64 px)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache = calibrate(args.path, args.force, models=args.models, smoke=args.smoke,
                      device=args.device)
    print(f"calibration cache: {args.path or default_cal_path()}")
    print(f"host: {cache['host']}")
    for name in sorted(cache["models"]):
        e = cache["models"][name]
        extra = ""
        if e.get("kind") == "llm":
            extra = (f"  init={e['init_s']:.3f}s compile={e['compile_s']:.3f}s"
                     f"  {e['tokens_per_s']:.1f} tok/s curve={e.get('batch_curve')}")
        else:
            extra = f"  first={e['first_call_s']:.4f}s"
        print(f"  {name:24s} warm={e['warm_exec_s']:.4f}s{extra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
