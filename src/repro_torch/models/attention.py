"""Training-path attention: GQA with q-chunked causal softmax in f32 (port
of repro/models/attention.py ``causal_attention`` :167, in plain tensor ops
as the reference writes it).  Queries are grouped (B, S, KV, G, hd), so KV
heads are never repeated in memory."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope

NEG_INF = -1e30


def attn_params_shape(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
            "wo": (H * hd, D)}


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, S, H, hd)
    k = torch.matmul(x, p["wk"]).reshape(B, S, KV, hd)
    v = torch.matmul(x, p["wv"]).reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q_chunk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            q_start: int) -> torch.Tensor:
    """One q chunk (B, cq, KV, G, hd) against the causal prefix of k, v
    (B, S, KV, hd), with an f32 softmax."""
    cq, hd = q_chunk.shape[1], q_chunk.shape[-1]
    S = k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q_chunk.float() * hd ** -0.5,
                     k.float())
    q_pos = q_start + torch.arange(cq, device=k.device)
    mask = q_pos[:, None] >= torch.arange(S, device=k.device)[None, :]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    cq = min(cfg.q_chunk, S)
    n_chunks = (S + cq - 1) // cq
    if n_chunks * cq != S:  # pad seq to a chunk multiple
        qg = torch.nn.functional.pad(qg, (0, 0, 0, 0, 0, 0,
                                          0, n_chunks * cq - S))
    outs = [_attend(qg[:, i * cq:(i + 1) * cq], k, v, i * cq)
            for i in range(n_chunks)]
    out = torch.cat(outs, dim=1)[:, :S]
    return out.reshape(B, S, H, hd)


def attention_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence attention sublayer (no residual/norm)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    out = causal_attention(cfg, q, k, v)
    return torch.matmul(out.reshape(B, S, -1), p["wo"])
