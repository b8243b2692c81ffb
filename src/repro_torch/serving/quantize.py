"""Weight-only int8 quantization for serving (the reference's beyond-paper
ablation, ``repro.serving.quantize``).

Each weight leaf of two or more dimensions whose key is in ``QUANT_KEYS``
becomes ``{"q": int8, "scale": float32}``, symmetric, with one scale per
output column: the largest magnitude over every other axis, over 127.
``dequantize_params`` restores a tree of the given dtype for the unmodified
model functions.  Activations and the KV cache stay as they are.

The parameter trees keep the reference's key names, so ``QUANT_KEYS``
selects the same leaves.  ``torch.round`` rounds half to even as
``jnp.round`` does, so a leaf gives the reference's ``q`` and ``scale`` bit
for bit.  The reference stacks its layer leaves on a leading layer axis,
where the port's model trees hold a list of per-layer trees (``STACKED``).
A leaf of such a list is quantized as the reference quantizes the stack:
its column maxima run over every layer, every layer's ``q`` is its slice of
the stack's, and the layers share one ``scale`` tensor, counted once.  So
the port's model tree quantizes to the reference's, layer for layer, with
the reference's stats.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import tensor_leaves

QUANT_KEYS = ("w", "wi", "wu", "wd", "embedding")
# the per-layer lists of the port's trees that the reference stacks on a
# leading layer axis (the hybrid's ``extra`` and the CNNs' lists are lists
# there too)
STACKED = ("layers", "units", "enc_layers", "dec_layers")


def _quantize_leaf(w: torch.Tensor) -> dict:
    wf = w.float()
    axes = tuple(range(w.dim() - 1))
    scale = torch.amax(wf.abs(), dim=axes, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _is_quantizable(name, leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 and name in QUANT_KEYS


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def quantize_params(params):
    """Returns (quantized tree, stats dict)."""
    stats = {"quantized_leaves": 0, "bytes_before": 0, "bytes_after": 0}

    def stacked(layers: list, name=None) -> list:
        """A list of per-layer trees, quantized as the reference's stack."""
        if isinstance(layers[0], dict):
            outs = {k: stacked([lp[k] for lp in layers], k) for k in layers[0]}
            return [{k: v[i] for k, v in outs.items()} for i in range(len(layers))]
        stats["bytes_before"] += sum(map(_nbytes, layers))
        if name in QUANT_KEYS and layers[0].dim() >= 1:   # the stack's two or more
            stats["quantized_leaves"] += 1
            out = _quantize_leaf(torch.stack(layers))
            scale = out["scale"][0]
            stats["bytes_after"] += out["q"].numel() + scale.numel() * 4
            return [{"q": lq, "scale": scale} for lq in out["q"].unbind(0)]
        stats["bytes_after"] += sum(map(_nbytes, layers))
        return layers

    def q(tree, name=None):
        if isinstance(tree, dict):
            return {k: stacked(v) if k in STACKED and isinstance(v, list) and v else q(v, k)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [q(v) for v in tree]
        stats["bytes_before"] += _nbytes(tree)
        if _is_quantizable(name, tree):
            stats["quantized_leaves"] += 1
            out = _quantize_leaf(tree)
            stats["bytes_after"] += out["q"].numel() + out["scale"].numel() * 4
            return out
        stats["bytes_after"] += _nbytes(tree)
        return tree

    qt = q(params)
    stats["ratio"] = stats["bytes_after"] / max(stats["bytes_before"], 1)
    return qt, stats


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def dequantize_params(qparams, dtype=torch.bfloat16):
    """The inverse transform, for execution through the unmodified model
    functions: each quantized leaf becomes ``q * scale`` in ``dtype``."""
    if _is_q(qparams):
        return (qparams["q"].float() * qparams["scale"]).to(dtype)
    if isinstance(qparams, dict):
        return {k: dequantize_params(v, dtype) for k, v in qparams.items()}
    if isinstance(qparams, (list, tuple)):
        return [dequantize_params(v, dtype) for v in qparams]
    return qparams


def quantization_error(params, dtype=torch.bfloat16) -> float:
    """The largest relative reconstruction error over the leaves of two or
    more dimensions (each leaf's max abs error over its max magnitude)."""
    rt = dequantize_params(quantize_params(params)[0], dtype)
    errs = []
    for a, b in zip(tensor_leaves(params), tensor_leaves(rt)):
        if a.dim() >= 2:
            af, bf = a.float(), b.float()
            denom = torch.clamp(af.abs().max(), min=1e-8)
            errs.append(float((af - bf).abs().max() / denom))
    return max(errs) if errs else 0.0
