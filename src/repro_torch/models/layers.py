"""Shared layers: RMS norm, RoPE and M-RoPE, gated MLP (port of
repro/models/layers.py).

The activations round as the reference's jitted graph rounds them: XLA
lowers ``jax.nn.silu`` to negate, exp, add 1 and divide, and
``jax.nn.gelu(approximate=True)`` to a chain of products and sums with its
constants rounded to the input's dtype, each op rounded to that dtype.
``F.silu`` and ``F.gelu`` compute in f32 and round once, which differs in
the last bf16 bit on about two inputs in five.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.config import ModelConfig

# the model dtypes (``cfg.dtype``, ``cfg.attn_logits_dtype``) by name
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions (B, S), or (3, B, S) for M-RoPE.

    M-RoPE (qwen2-vl, reference :26-56): the hd/2 rotary frequencies split
    into (temporal, height, width) sections (s1, s2, n - s1 - s2), n =
    hd/2, s1 = n // 4, s2 = (n - s1) // 2, each rotated by its own
    position stream; when the three streams coincide it is plain RoPE."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    if positions.dim() == 2:                             # plain RoPE
        angles = positions[..., None].float() * freqs    # (B, S, hd/2)
    else:                                                # M-RoPE
        n = hd // 2
        s1 = n // 4
        s2 = (n - s1) // 2
        parts, start = [], 0
        for stream, sec in enumerate((s1, s2, n - s1 - s2)):
            parts.append(positions[stream][..., None].float()
                         * freqs[start:start + sec])
            start += sec
        angles = torch.cat(parts, dim=-1)                # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as jitted: x * (1 / (1 + exp(-x))), each op rounded
    to x's dtype."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)`` as jitted: the constants rounded to
    x's dtype, the cube as two products, each op rounded to x's dtype."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c * (x + a * (x * x * x)))))


def activation(cfg: ModelConfig):
    """The gated MLP's activation of ``cfg`` (swiglu or geglu)."""
    return silu if cfg.mlp_act == "swiglu" else gelu_tanh


def gated_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.matmul(x, p["w_gate"])
    up = torch.matmul(x, p["w_up"])
    return torch.matmul(activation(cfg)(gate) * up, p["w_down"])
