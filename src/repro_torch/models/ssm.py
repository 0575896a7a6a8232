"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) blocks (port of
repro/models/ssm.py).

The full-sequence mixer runs the chunked SSD scan through
``kernels/ssd/ops.ssd_scan`` (the hand-written kernel on the card, its
plain version on the CPU, with a gradient); one B/C group (n_groups=1).
Decode keeps the O(H P N) recurrent state and a (W-1)-token conv window
and steps them in plain tensor ops, as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, silu


def ssm_params_shape(cfg: ModelConfig) -> dict:
    D, din, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * N
    return {
        "in_proj": (D, 2 * din + 2 * N + H),
        "conv_w": (cfg.ssm_conv_width, conv_dim),
        "conv_b": (conv_dim,),
        "A_log": (H,),
        "dt_bias": (H,),
        "ssm_D": (H,),
        "gate_norm": (din,),
        "out_proj": (din, D),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d and SiLU. xbc: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return silu(out + b)


def ssd(u: torch.Tensor, dlog: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """u: (B, S, H, P); dlog: (B, S, H); Bm, Cm: (B, S, N) -> y like u, in
    chunks of ``min(chunk, S)`` positions.  S need not be a multiple: the
    kernel masks the last chunk and the plain version zero-pads it, as the
    reference does."""
    return ssd_ops.ssd_scan(u.contiguous(), dlog.float().contiguous(),
                            Bm.contiguous(), Cm.contiguous(), chunk)


def mamba_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Full Mamba2 mixer (train / prefill). x: (B, S, D)."""
    B, S, _ = x.shape
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["in_proj"])
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * N]
    dt_raw = zxbcdt[..., -H:]

    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xc = xbc[..., :din]
    Bm = xbc[..., din:din + N]
    Cm = xbc[..., din + N:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])                # (B, S, H)
    A = -torch.exp(p["A_log"].float())                             # (H,)
    u = xc.reshape(B, S, H, P)
    # dt is cast to u's dtype before the product, as the reference does
    y = ssd(u * dt[..., None].to(u.dtype), dt * A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["ssm_D"].to(y.dtype)[None, None, :, None] * u
    y = y.reshape(B, S, din)
    y = rms_norm(y * silu(z), p["gate_norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"])


def mamba_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor
                 ) -> tuple:
    """One-token decode. x: (B, 1, D); ssm_state: (B, H, P, N) f32;
    conv_state: (B, W-1, conv_dim).  Returns (out (B, 1, D), new ssm
    state, new conv state)."""
    B = x.shape[0]
    din, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = torch.matmul(x, p["in_proj"])
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * N]        # (B, 1, conv_dim)
    dt_raw = zxbcdt[..., -H:]

    window = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    w = p["conv_w"]
    conv_out = window[:, 0] * w[0]
    for i in range(1, w.shape[0]):
        conv_out = conv_out + window[:, i] * w[i]
    conv_out = silu(conv_out + p["conv_b"])[:, None]   # (B, 1, conv_dim)
    new_conv_state = window[:, 1:]

    xc = conv_out[..., :din]
    Bm = conv_out[..., din:din + N][:, 0]           # (B, N)
    Cm = conv_out[..., din + N:][:, 0]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])[:, 0]           # (B, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt * A)                                           # (B, H)
    xh = xc.reshape(B, H, P).float()
    u = xh * dt[..., None]
    new_state = a[:, :, None, None] * ssm_state + \
        torch.einsum("bhp,bn->bhpn", u, Bm.float())
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    y = y + p["ssm_D"].float()[None, :, None] * xh
    y = y.reshape(B, 1, din).to(x.dtype)
    y = rms_norm(y * silu(z), p["gate_norm"], cfg.norm_eps)
    return torch.matmul(y, p["out_proj"]), new_state, new_conv_state
