"""Shared model configuration and parameter utilities.

Parameters are nested dicts (and, for the layer stack, a list of per-layer
dicts) of ``torch.Tensor``; the forward code is plain functions on tensors, as
in the reference package, so a parameter tree converts one-to-one
(``repro_torch.models.convert``).  Dense weights keep the reference layout
``(d_in, d_out)`` and are applied as ``x @ w``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

Params = Any  # nested dict / list of torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single config type shared by every architecture family (the same
    fields as the reference's); dtypes are names that map to torch dtypes."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm | cnn
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- attention variants ---
    attention_window: int = 0    # 0 = full causal; >0 = sliding window
    rope_theta: float = 10000.0
    # --- hybrid (RecurrentGemma) ---
    pattern: tuple = ()          # e.g. ("rglru", "rglru", "attn")
    rglru_conv_width: int = 4
    # --- ssm (RWKV-6) ---
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32
    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0         # precomputed frame embeddings length
    # --- vlm (LLaVA-NeXT) ---
    num_image_tokens: int = 0    # anyres patch-embedding stub length
    # --- norm / act / dtypes ---
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu | relu
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- cnn (paper models) ---
    cnn_variant: str = ""        # squeezenet | resnet18 | resnext50
    num_classes: int = 1000
    image_size: int = 224

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.num_heads, 1)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def pdt(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdt(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (analytic, for roofline MODEL_FLOPS = 6*N*D).
    def param_count(self, active_only: bool = False) -> int:
        c = self
        if c.family == "cnn":
            return 0  # counted empirically via the parameter tree
        d = c.d_model
        attn = d * c.q_dim + 2 * d * c.kv_dim + c.q_dim * d
        if c.qkv_bias:
            attn += c.q_dim + 2 * c.kv_dim
        if c.is_moe:
            e = c.num_experts_per_tok if active_only else c.num_experts
            mlp = e * (3 * d * c.d_ff) + d * c.num_experts  # experts + router
        else:
            mlp = 3 * d * c.d_ff
        if c.family == "ssm":
            # rwkv6: time-mix (r,k,v,g,o ~ 5 d^2 + decay lora) + channel-mix
            tmix = 4 * d * d + d * d + 2 * d * c.rwkv_decay_lora
            cmix = d * c.d_ff + c.d_ff * d + d * d
            per_layer = tmix + cmix
        elif c.family == "hybrid":
            # average over the pattern: recurrent block vs attention block
            rec = 2 * d * d + d * c.rglru_conv_width + 2 * d  # in/out proj + conv + gates
            per_rec = rec + 3 * d * c.d_ff
            per_attn = attn + 3 * d * c.d_ff
            n_rec = sum(1 for p in self.full_pattern() if p == "rglru")
            n_attn = c.num_layers - n_rec
            return c.vocab_size * d + n_rec * per_rec + n_attn * per_attn
        else:
            per_layer = attn + mlp
        n = c.vocab_size * d + c.num_layers * per_layer
        if c.family == "audio":
            n += c.encoder_layers * (attn + mlp) + c.num_layers * attn  # cross-attn
        if not c.tie_embeddings:
            n += c.vocab_size * d
        return n

    def full_pattern(self) -> tuple:
        """Per-layer block types for hybrid models (len == num_layers)."""
        if not self.pattern:
            return ("attn",) * self.num_layers
        reps = math.ceil(self.num_layers / len(self.pattern))
        return (self.pattern * reps)[: self.num_layers]


# ----------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, bias: bool = False, scale: float | None = None) -> dict:
    """Normal(0, 1/d_in) weights drawn in float32 and cast, as the reference
    draws them (the draws themselves are torch's, not JAX's)."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: dict, x: torch.Tensor, dtype=None) -> torch.Tensor:
    w = p["w"]
    if dtype is not None:
        w = w.to(dtype)
        x = x.to(dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _mm_float32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if not a.is_cuda:              # the CPU has no GEMM with a float32 output
        return a.float() @ b.float()
    if b.dim() == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32).reshape(
        *a.shape[:-1], b.shape[-1])


class _Float32Products(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_float32(a, b)

    @staticmethod
    def backward(ctx, g):
        # the incoming gradient is a half-precision one cast up (the output
        # is cast back before it is used), so it rounds back exactly; each
        # operand's gradient is the GEMM its own dtype gives
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = (a.transpose(1, 2) @ g if b.dim() == 3
                  else a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1]))
        return ga, gb


def float32_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (a 2-D ``b``, or a batch of them against a 3-D ``a``) with
    its float32 accumulators as the output: the partial sums that a rank of
    a row-parallel product reduces.  Float32 operands multiply as they are.
    On the card, half-precision operands go through their own GEMM with a
    float32 output (``out_dtype``), at the tensor cores' rate and without
    float32 copies of the weights; on the CPU, which has no such GEMM, they
    are cast up."""
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        return a @ b
    return _Float32Products.apply(a, b)


def norm_init(d: int, kind: str, dtype, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMS or layer norm, computed in float32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def activation(name: str) -> Callable:
    return _ACTS[name]


# ----------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: broadcastable to (..., S).  Computed in
    float32 and cast back to x's dtype."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def row_positions(pos, batch: int, device) -> torch.Tensor:
    """A decode step's position as a (B,) int tensor on the device: a (B,)
    or 0-d tensor as given, a host int filled in (an int is then fixed in
    a captured step, so the engine passes a tensor)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(-1).expand(batch)
    return torch.full((batch,), int(pos), dtype=torch.long, device=device)


def remat(fn: Callable, on: bool) -> Callable:
    """``fn`` under activation checkpointing when ``on``: its activations
    are dropped after the forward and recomputed in the backward, the
    counterpart of the reference's ``jax.checkpoint`` with the
    ``nothing_saveable`` policy around each layer of its training scan."""
    if not on:
        return fn
    # No training forward of the port draws random numbers (no dropout; the
    # only draws are in the inits), so the recomputation needs no stashed
    # RNG state, and stashing it (``torch.cuda.get_rng_state``) would not
    # capture into a CUDA graph.
    return lambda *args: torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                                           preserve_rng_state=False)


def tensor_leaves(params: Params):
    """Every tensor of a nested dict / list tree, in order."""
    if isinstance(params, torch.Tensor):
        yield params
    elif isinstance(params, dict):
        for v in params.values():
            yield from tensor_leaves(v)
    elif isinstance(params, (list, tuple)):
        for v in params:
            yield from tensor_leaves(v)


def leaf_paths(params: Params, keys: tuple = ()):
    """The key path of every tensor of a nested dict / list tree, in
    ``tensor_leaves`` order (a list's index as an int)."""
    if isinstance(params, torch.Tensor):
        yield keys
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from leaf_paths(v, keys + (k,))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from leaf_paths(v, keys + (i,))


def count_params(params: Params) -> int:
    return sum(t.numel() for t in tensor_leaves(params))


def param_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in tensor_leaves(params))
