"""Plain PyTorch versions of the flash prefill kernel (K1) and of its
backward (K1-bwd)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import NEG_INF, causal_window_mask, sdpa


def _mask(q, window: int) -> torch.Tensor:
    pos = torch.arange(q.shape[1], device=q.device)
    return causal_window_mask(pos, pos, window)


def flash_attention_ref(q, k, v, *, window: int = 0):
    """q: (B,S,H,hd); k,v: (B,S,K,hd).  Causal (+window) attention."""
    return sdpa(q, k, v, _mask(q, window))


def _logits(q, k):
    """(B,K,G,Sq,Sk) float32 scaled logits, query head h = K-index * G + G-index."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qf = q.float().reshape(b, s, kh, h // kh, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) * hd ** -0.5


def flash_attention_fwd_ref(q, k, v, *, window: int = 0):
    """-> (o, lse): the output of ``flash_attention_ref`` and each row's
    float32 log-sum-exp of its scaled logits, masked ones at the reference's
    finite -1e30, (B,H,S): what K1 writes for its backward."""
    b, s, h, _ = q.shape
    logits = torch.where(_mask(q, window), _logits(q, k), NEG_INF)
    return flash_attention_ref(q, k, v, window=window), \
        torch.logsumexp(logits, dim=-1).reshape(b, h, s)


def attention_bwd_ref(q, k, v, o, do, lse, mask):
    """The gradient of softmax attention under ``mask`` ((Sq,Sk) bool),
    computed explicitly, in float32, from the forward's output and row
    log-sum-exp (B,H,S), as K1-bwd computes it:
        P = exp(scale q k^T - lse) masked to 0, dV = P^T dO,
        D = rowsum(dO o O), dS = P o (dO V^T - D),
        dQ = scale dS K, dK = scale dS^T Q,
    dK and dV summed over each kv head's query heads.  -> (dq, dk, dv) in
    the inputs' dtypes."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    p = torch.where(mask, torch.exp(_logits(q, k) - lse.reshape(b, kh, g, s, 1)), 0.0)
    dof = do.float().reshape(b, s, kh, g, hd)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, v.float())
    d = (dof * o.float().reshape(b, s, kh, g, hd)).sum(-1)          # (B,S,K,G)
    ds = p * (dp - d.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, q.float().reshape(b, s, kh, g, hd)) * scale
    return dq.reshape(b, s, h, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, window: int = 0):
    """K1-bwd's plain version: ``attention_bwd_ref`` under the causal
    (+window) mask."""
    return attention_bwd_ref(q, k, v, o, do, lse, _mask(q, window))
