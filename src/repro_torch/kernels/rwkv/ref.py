"""Plain PyTorch version of the WKV-6 kernel (K3): the RWKV-6 recurrence as a
float32 loop over time, with the arithmetic of the reference model's scan."""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0):
    """r, k, v, w: (B,T,H,hd) float32; u: (H,hd); s0: (B,H,hd,hd).
    Per (b, h) and step t, with kv = k_t (outer) v_t:
        o_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * kv[i,j])
        S      = w_t[:, None] * S + kv
    Returns (o (B,T,H,hd), final state (B,H,hd,hd)); s0 is not written."""
    s = s0.float()
    bonus = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + bonus * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s
