"""Plain reference of a dense decoder (Llama-style): float32, no cache, no
batching, no kernels.

Per layer: x += W_o attn(rope(W_q n1(x)), rope(W_k n1(x)), W_v n1(x)), then
x += W_d (silu(W_i n2(x)) * W_u n2(x)), with n1, n2 RMS norms (eps from the
configuration file) and causal softmax attention in which query head h reads
key and value head h // (heads / kv_heads).  RoPE rotates the two halves of
each head (x1, x2) by angles p * theta^(-2i/hd).  The logits are the final
RMS norm of x times the unembedding.  The weights are the benchmark's stacked
tensors (``families/dense.py``), read layer by layer and cast to float32
there, so that the whole model never sits in float32 at once.

``precision="fp8"`` is the control: every product's operands (activations a
row, weights a column at a time, and q, k, v) rounded to float8 e4m3 with a
scale, then multiplied in float32: the precision a lower-precision serving
path would compute in.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference:
    def __init__(self, config: dict, weights: dict, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.c = config
        self.w = weights
        self.fp8 = precision == "fp8"
        self.heads = config["num_attention_heads"]
        self.kv = config["num_key_value_heads"]
        self.hd = config.get("head_dim") or config["hidden_size"] // self.heads
        self.eps = float(config["rms_norm_eps"])

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * scale.float()

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        inv = 1.0 / float(self.c["rope_theta"]) ** (
            torch.arange(0, self.hd, 2, dtype=torch.float64, device=x.device) / self.hd)
        ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] * inv
        cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
        x1, x2 = x[..., : self.hd // 2], x[..., self.hd // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attend(self, q, k, v):
        n = q.shape[0]
        if self.fp8:
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        rep = self.heads // self.kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = torch.einsum("qhd,khd->hqk", q, k) / self.hd ** 0.5
        causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        return torch.einsum("hqk,khd->qhd", p, v).reshape(n, -1)

    def _layer(self, i: int, x: torch.Tensor) -> torch.Tensor:
        w, n = self.w, x.shape[0]
        h = self._norm(x, w["norms"][i, 0])
        q = self._rope(self._mm(h, w["wq"][i]).view(n, self.heads, self.hd))
        k = self._rope(self._mm(h, w["wk"][i]).view(n, self.kv, self.hd))
        v = self._mm(h, w["wv"][i]).view(n, self.kv, self.hd)
        x = x + self._mm(self._attend(q, k, v), w["wo"][i])
        h = self._norm(x, w["norms"][i, 1])
        g = torch.nn.functional.silu(self._mm(h, w["wi"][i])) * self._mm(h, w["wu"][i])
        return x + self._mm(g, w["wd"][i])

    @torch.no_grad()
    def logits(self, sequences: list, starts: list) -> list:
        """Float32 logits (n - start, V) of each token sequence at positions
        ``start`` to its end, the sequences run layer by layer."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            dev = self.w["embedding"].device
            xs = [self.w["embedding"][torch.as_tensor(s, device=dev)].float() for s in sequences]
            for i in range(self.w["wq"].shape[0]):
                xs = [self._layer(i, x) for x in xs]
            return [self._mm(self._norm(x[s:], self.w["final_norm"]), self.w["unembed"])
                    for x, s in zip(xs, starts)]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
