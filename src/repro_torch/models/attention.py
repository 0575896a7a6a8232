"""Attention: the full-sequence causal GQA attention of training and the
feedback gradient (port of repro/models/attention.py ``causal_attention``
:167) through the flash kernel, and one-token decode against a cache for
serving (``attention_decode`` :207) in plain tensor ops, as the reference
writes it (its XLA ``_chunk_attend``).  Queries are grouped, so KV heads are
never repeated in memory.  ``qkv_bias`` (qwen2.5) adds a bias to q, k and v
before the head reshape; ``qk_norm`` (qwen3) RMS-normalizes q and k over
the head dim before RoPE; decode projects through the same code."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm

NEG_INF = -1e30


def attn_params_shape(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
              "wo": (H * hd, D)}
    if cfg.qkv_bias:
        shapes.update({"bq": (H * hd,), "bk": (KV * hd,), "bv": (KV * hd,)})
    if cfg.qk_norm:
        shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
    return shapes


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: torch.Tensor) -> torch.Tensor:
    """One token's queries (B, 1, KV, G, hd) against the cache k, v
    (B, Smax, KV, hd) up to each lane's position ``pos`` ((B,) long), with
    an f32 softmax."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * hd ** -0.5, k.float())
    k_pos = torch.arange(k.shape[1], device=k.device)
    mask = (pos[:, None] >= k_pos)[:, None, None, None]    # (B,1,1,1,Smax)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd).

    ``kernels/flash/ops.flash_attention`` (the flash kernel on the card, its
    plain version on the CPU, with a gradient) reads the (B, S, H, hd)
    tensors in place as (B, H, S, hd) views; its output is stored
    (B, S, H, hd), so the transpose back is a view too."""
    out = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), causal=True)
    return out.transpose(1, 2)


def attention_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention sublayer (no residual/norm)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = causal_attention(cfg, q, k, v)
    return torch.matmul(out.reshape(B, S, -1), p["wo"])


def attention_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos) -> torch.Tensor:
    """One-token decode: x (B, 1, D), cache_k/v (B, Smax, KV, hd), ``pos``
    an int shared by every lane or a (B,) long tensor of per-lane positions
    (each lane's cache write, RoPE phase and causal mask follow its own
    position).  Writes this token's k, v into the caches in place (the
    reference returns new caches) and returns the sublayer output
    (B, 1, D)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((B,), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(cfg, p, x, pos[:, None])
    lanes = torch.arange(B, device=x.device)
    cache_k[lanes, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, pos] = v[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, 1, KV, H // KV, hd)
    out = _attend(qg, cache_k, cache_v, pos)
    return torch.matmul(out.reshape(B, 1, H * hd), p["wo"])
