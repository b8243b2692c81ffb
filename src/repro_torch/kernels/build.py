"""Builds the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, with ``nvcc``
for ``sm_90a``, into ``build/repro_torch/<name>-<digest>.so`` at the repo
root.  The digest covers the source, every shared header ``csrc/*.cuh`` and
the flags, so an edited source or header is rebuilt and a stale library is
never loaded.  A library is built at its first use; ``build_all`` starts one
``nvcc`` per source at once and waits for all.  Nothing is built when a
module is imported.  ``refuse_grad`` is the check every wrapper runs first.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise FileNotFoundError("nvcc not found on PATH or under CUDA_HOME")
    return str(path)


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def target(name: str) -> Path:
    """The library path for the current source, headers and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, proc, tmp, out


def _finish(job) -> str:
    name, proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every source without a current library, all at once.
    Returns each built source's compiler output (ptxas register and shared
    memory lines)."""
    jobs = [j for j in map(_start, sources()) if j is not None]
    logs, errors = {}, []
    for job in jobs:           # wait for every nvcc before raising
        try:
            logs[job[0]] = _finish(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _loaded:
            job = _start(name)
            if job is not None:
                _finish(job)
            _loaded[name] = ctypes.CDLL(str(target(name)))
        return _loaded[name]


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: a kernel
    called outside its ``torch.autograd.Function`` (``kernels/dispatch.py``)
    writes its output through ctypes, so the graph would end there and the
    gradients before it would be silently lost."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and the kernel called "
                           "outside an autograd Function (repro_torch.kernels.dispatch) "
                           "would drop its gradient")
