"""Plain PyTorch versions of the WKV-6 kernel (K3), the RWKV-6 recurrence as a
float32 loop over time with the arithmetic of the reference model's scan, and
of its backward (K3-bwd)."""
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


def wkv6_bwd_ref(r, k, v, w, u, s0, do, ds_t):
    """The gradient of ``wkv6_ref``, computed explicitly (K3-bwd's plain
    version): the states S_{t-1} are rebuilt by a forward loop, then, with
    dS the gradient of S_t, from the final state's ``ds_t`` back over t:
        dr_t[i] = sum_j dO_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
        dk_t[i] = u[i] r_t[i] (dO_t . v_t) + sum_j dS[i,j] v_t[j]
        dv_t[j] = (sum_i r_t[i] u[i] k_t[i]) dO_t[j] + sum_i dS[i,j] k_t[i]
        dw_t[i] = sum_j dS[i,j] S_{t-1}[i,j]
        du[i]  += r_t[i] k_t[i] (dO_t . v_t)
        dS      = w_t[:, None] dS + r_t dO_t^T
    -> (dr, dk, dv, dw, du (H,hd) summed over B and T, ds0)."""
    s = s0.float()
    states = []
    for t in range(r.shape[1]):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    uf = u.float()
    ds = ds_t.float()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(r[:, 0])
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, wt, dot = (x[:, t] for x in (r, k, v, w, do))
        dov = (dot * vt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhj,bhij->bhi", dot, states[t]) + uf * kt * dov
        dk[:, t] = uf * rt * dov + torch.einsum("bhij,bhj->bhi", ds, vt)
        dv[:, t] = ((rt * uf * kt).sum(-1, keepdim=True) * dot
                    + torch.einsum("bhij,bhi->bhj", ds, kt))
        dw[:, t] = (ds * states[t]).sum(-1)
        du += rt * kt * dov
        ds = wt[..., None] * ds + rt[..., None] * dot[..., None, :]
    return dr, dk, dv, dw, du.sum(0), ds
