"""Weights bridge: the reference's parameter tree -> the port's.

The reference trees (``repro.models.transformer.init_params`` for the dense
and moe families, ``repro.models.ssm.init_params`` for RWKV-6) are nested
dicts of arrays whose layer params are stacked on a leading axis of length
``num_layers`` (built by ``vmap``).  The caller hands one over as numpy arrays
(this module imports neither JAX nor the reference); the converter unstacks
the layers into a list of per-layer dicts and keeps every other key (the
dense tree's ``embed`` and ``final_norm``, and the ssm tree's ``ln_in`` too).
Every leaf keeps its dtype: RWKV-6's ``u`` and ``w0`` stay float32 in a
bfloat16 tree, as does a MoE layer's float32 router ``moe.router.w`` (d, E)
beside its expert weights ``moe.wi``/``wu`` (E, d, f) and ``wd`` (E, f, d).

Dense weights stay ``(d_in, d_out)`` and the port applies them as ``x @ w``,
as the reference does, so nothing is transposed.  bfloat16 arrays (numpy's
``ml_dtypes.bfloat16``) are carried over bit for bit.

The cnn trees (``repro.models.cnn.init_params``) keep their lists
(``fires``, ``blocks``), which are not stacked.  Their 4-D conv weights go
from HWIO to OIHW, PyTorch's layout; everything else (``fc.w`` as
``(d_in, d_out)``, the folded BatchNorm's ``scale`` and ``bias``) is copied
as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from .common import ModelConfig


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: torch shares numpy's memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _convert_cnn(tree, device):
    if isinstance(tree, dict):
        return {k: _convert_cnn(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert_cnn(v, device) for v in tree]
    t = _tensor(tree, device)
    return t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def from_reference(np_params: dict, cfg: ModelConfig, device="cuda") -> dict:
    """np_params: the reference dense, moe, ssm or cnn param tree with numpy
    leaves."""
    if cfg.family not in ("dense", "moe", "ssm", "cnn"):
        raise NotImplementedError(f"{cfg.name}: only the dense, moe, ssm and cnn "
                                  "families are ported (ROADMAP.md Queue 1)")
    dev = resolve_device(device)
    if cfg.family == "cnn":
        return _convert_cnn(np_params, dev)
    layers = np_params["layers"]
    n = len(layers["ln1"]["scale"])
    if n != cfg.num_layers:
        raise ValueError(f"the tree has {n} layers, {cfg.name} has {cfg.num_layers}")
    out = {k: _convert(v, dev) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [_convert(_layer(layers, i), dev) for i in range(n)]
    return out
