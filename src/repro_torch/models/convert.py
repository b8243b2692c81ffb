"""Weights bridge: the reference's parameter tree -> the port's, and back.

The reference trees are nested dicts of arrays whose layer params are
stacked on a leading axis (built by ``vmap``).  The caller hands one over as
numpy arrays (this module imports neither JAX nor the reference); the
converter unstacks each stack into a list of per-layer dicts and keeps every
other key:

* dense, moe and vlm (``repro.models.transformer.init_params``; vlm's is the
  transformer's): ``layers`` becomes a list, ``embed`` and ``final_norm`` are
  kept;
* ssm (``repro.models.ssm.init_params``): the same, and ``ln_in`` is kept;
* hybrid (``repro.models.hybrid.init_params``): ``units``, a dict of pattern
  blocks ``b0``.. each stacked on ``n_units``, becomes a list of per-unit
  dicts, and ``extra``, already a list, is converted block by block;
* audio (``repro.models.encdec.init_params``): ``enc_layers`` and
  ``dec_layers`` become lists, and ``dec_pos`` (the learned decoder
  positions) and the norms are kept.

Every leaf keeps its dtype: RWKV-6's ``u`` and ``w0`` stay float32 in a
bfloat16 tree, as do a MoE layer's float32 router ``moe.router.w`` (d, E)
beside its expert weights ``moe.wi``/``wu`` (E, d, f) and ``wd`` (E, f, d),
and the RG-LRU's ``lam``.

Dense weights stay ``(d_in, d_out)`` and the port applies them as ``x @ w``,
as the reference does, so nothing is transposed.  bfloat16 arrays (numpy's
``ml_dtypes.bfloat16``) are carried over bit for bit.

The cnn trees (``repro.models.cnn.init_params``) keep their lists
(``fires``, ``blocks``), which are not stacked.  Their 4-D conv weights go
from HWIO to OIHW, PyTorch's layout; everything else (``fc.w`` as
``(d_in, d_out)``, the folded BatchNorm's ``scale`` and ``bias``) is copied
as it is.

``to_reference`` is the inverse: the port's tree (or a tree of its
gradients, or of its partition specs) in the reference's layout, each stack stacked again on axis 0,
as torch tensors on the tree's device (bfloat16 stays bfloat16: numpy has
no such type without the reference's ``ml_dtypes``).  ``from_reference``
also takes such a tree of tensors, as ``train/checkpoint.py::restore``
gives it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from .common import ModelConfig


def _tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, copy=True).contiguous()
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


def _unstack(tree, n: int, device) -> list:
    return [_convert(_layer(tree, i), device) for i in range(n)]


def _depth(tree) -> int:
    """The length of the stacked axis of a stacked tree."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return len(tree)


# the stacked keys of each family's tree, and the config's count of each
_STACKS = {
    "dense": {"layers": "num_layers"}, "moe": {"layers": "num_layers"},
    "vlm": {"layers": "num_layers"}, "ssm": {"layers": "num_layers"},
    "audio": {"enc_layers": "encoder_layers", "dec_layers": "num_layers"},
}


def from_reference(np_params: dict, cfg: ModelConfig, device="cuda") -> dict:
    """np_params: the reference param tree of ``cfg``'s family, with numpy
    leaves."""
    if cfg.family not in (*_STACKS, "hybrid", "cnn"):
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r}")
    dev = resolve_device(device)
    if cfg.family == "cnn":
        return _convert_cnn(np_params, dev)
    if cfg.family == "hybrid":
        units, extra = np_params["units"], np_params["extra"]
        out = {k: _convert(v, dev) for k, v in np_params.items()
               if k not in ("units", "extra")}
        n_units = _depth(units)
        if n_units * len(units) + len(extra) != cfg.num_layers:
            raise ValueError(f"the tree has {n_units} units of {len(units)} and "
                             f"{len(extra)} extra layers, {cfg.name} has {cfg.num_layers}")
        out["units"] = _unstack(units, n_units, dev)
        out["extra"] = [_convert(b, dev) for b in extra]
        return out
    stacks = _STACKS[cfg.family]
    out = {k: _convert(v, dev) for k, v in np_params.items() if k not in stacks}
    for key, count in stacks.items():
        n = _depth(np_params[key])
        if n != getattr(cfg, count):
            raise ValueError(f"the tree has {n} {key}, {cfg.name} has {getattr(cfg, count)}")
        out[key] = _unstack(np_params[key], n, dev)
    return out


def _stack(layers: list):
    """A list of per-layer trees -> one tree, each leaf stacked on axis 0."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in layers]) for k in first}
    if isinstance(first, tuple):   # a spec (launch/sharding.py): the stack is not cut
        return (None, *first)
    return torch.stack(layers)


def _to_cnn(tree):
    if isinstance(tree, dict):
        return {k: _to_cnn(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cnn(v) for v in tree]
    return tree.permute(2, 3, 1, 0).contiguous() if tree.dim() == 4 else tree


def to_reference(params: dict, cfg: ModelConfig) -> dict:
    """The port's tree of ``cfg``'s family -> the reference's layout (the
    inverse of ``from_reference``), with torch tensors as leaves."""
    if cfg.family not in (*_STACKS, "hybrid", "cnn"):
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.family == "cnn":
        return _to_cnn(params)
    if cfg.family == "hybrid":
        out = {k: v for k, v in params.items() if k not in ("units", "extra")}
        out["units"] = _stack(params["units"])
        out["extra"] = list(params["extra"])
        return out
    stacks = _STACKS[cfg.family]
    out = {k: v for k, v in params.items() if k not in stacks}
    for key in stacks:
        out[key] = _stack(params[key])
    return out
