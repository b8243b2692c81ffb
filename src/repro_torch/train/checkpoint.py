"""Checkpoints in the reference's format (``repro/train/checkpoint.py``):
``path.npz`` holds the leaves as ``a0``, ``a1``, ... and ``path.json`` the
manifest (``step``, ``treedef``, ``n``, ``dtypes``, ``extra``).

The leaves go in the reference's order: a tree of dicts and lists is
flattened as ``jax.tree_util`` flattens it, dict keys sorted, lists in
order.  So a model's tree must be in the reference's layout, layers
stacked on axis 0 (``models/convert.py::to_reference``), for a reference
checkpoint to restore here and a port checkpoint to restore there.
bfloat16 is stored as its ``uint16`` bits, tagged ``"bfloat16"``.  Arrays
are gathered to the host, as the reference's are.

Under a mesh (``launch/mesh.py``) a tree of a rank's local shards is saved
whole: ``save(..., mesh=, pspecs=)`` gathers each leaf from the ranks by
its spec (every rank calls) and rank 0 writes, the file the same as a
single device's; ``restore(..., mesh=, pspecs=)`` reads the whole tree and
cuts this rank's shards (``launch/sharding.py``), as the reference's
``restore`` places the leaves on its mesh.  The specs are in the tree's
own layout (``models/convert.py::to_reference`` also stacks a spec tree).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import sharding


def _flatten(tree) -> list:
    """The leaves in ``jax.tree_util.tree_flatten``'s order; a ``None`` node
    is no leaf there, so it is dropped here too."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [] if tree is None else [tree]


def treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure(tree))``
    writes it."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, list):
        return [_unflatten(v, leaves) for v in like]
    return None if like is None else next(leaves)


def save(path: str, tree, *, step: int = 0, extra: dict | None = None, mesh=None,
         pspecs=None) -> None:
    """``tree``: dicts and lists of torch tensors or numpy arrays.  A
    ``None`` node holds no array: it is named in ``treedef`` only, and ``n``,
    ``dtypes`` and the ``a{i}`` names count the arrays, as the reference's
    ``jax.tree_util.tree_flatten`` does.  With ``mesh``, ``tree`` holds this
    rank's shards of the leaves cut by ``pspecs``: every rank of the mesh
    calls, rank 0 writes the gathered tree, and all return once it is
    written."""
    if mesh is not None:
        tree = sharding.gather_tree(tree, pspecs, mesh)
        if mesh.rank == 0:
            save(path, tree, step=step, extra=extra)
        dist.barrier()
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = _flatten(tree)
    arrays = {}
    meta = {"step": step, "treedef": treedef(tree), "n": len(leaves), "dtypes": [],
            "extra": extra or {}}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                arrays[f"a{i}"] = t.view(torch.int16).numpy().view(np.uint16)
                meta["dtypes"].append("bfloat16")
                continue
            arr = t.numpy()
        else:
            arr = np.asarray(leaf)
        arrays[f"a{i}"] = arr
        meta["dtypes"].append(str(arr.dtype))
    np.savez(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def restore(path: str, like_tree, *, device="cpu", mesh=None, pspecs=None):
    """Restore into the structure of ``like_tree`` (its leaves are only
    counted; its ``None`` nodes stay ``None``) as torch tensors on
    ``device``; with ``mesh``, this rank's shards of them by ``pspecs``, on
    the mesh's device.  -> (tree, step, extra)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    data = np.load(path + ".npz")
    n = len(_flatten(like_tree))
    if n != meta["n"]:
        raise ValueError(f"{path}: {meta['n']} leaves, the tree to restore into has {n}")
    out = []
    for i, dt in enumerate(meta["dtypes"]):
        arr = data[f"a{i}"]
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if dt == "bfloat16"
             else torch.from_numpy(arr))
        out.append(t if mesh is not None else t.to(device))
    tree = _unflatten(like_tree, iter(out))
    if mesh is not None:
        tree = sharding.shard_tree(tree, pspecs, mesh)
    return tree, meta["step"], meta.get("extra", {})
