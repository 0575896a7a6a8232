"""Attention: the full-sequence causal GQA attention of training and the
feedback gradient (port of repro/models/attention.py ``causal_attention``
:167) through the flash kernel, and one-token decode against a cache for
serving (``attention_decode`` :207) in plain tensor ops, as the reference
writes it (its XLA ``_chunk_attend``).  Queries are grouped, so KV heads are
never repeated in memory.  ``qkv_bias`` (qwen2.5) adds a bias to q, k and v
before the head reshape; ``qk_norm`` (qwen3) RMS-normalizes q and k over
the head dim before RoPE; decode projects through the same code.
Positions are (B, S), or (3, B, S) with ``mrope`` (qwen2-vl), as
``layers.apply_rope`` takes them.

``attn_logits_dtype`` other than f32 (the reference's ``_attend_math``
:84-120) rounds the softmax as the reference's XLA path does: the f32
logits less their f32 row max, cast to that dtype, ``exp`` in it, divided
by the f32 sum cast back.  The decode path and the whole-sequence path on
the CPU do exactly that.  On the card the whole-sequence path stays on
kernel 7, whose statistics are f32 whatever the setting: a decision, and
a departure from the reference model, whose ``causal_attention``
(:167-194) rounds through ``_attend_math`` on every path (its Pallas flash
kernel, which keeps f32, is not called by the model).  A one-pass kernel
cannot round so: the reference centres each row on its final maximum
before the cast.  Rounding inside kernel 7 is an open item (ROADMAP queue
3).  The card is held against the CPU at the bf16 tolerance."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import DTYPES, apply_rope, rms_norm

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


def softmax(s: torch.Tensor, logits_dtype: torch.dtype) -> torch.Tensor:
    """The softmax over the last dim of f32 logits ``s``: in f32, or with
    another ``logits_dtype`` the reference's rounding (``_attend_math``
    :112-117): the row max (no gradient) subtracted in f32, the result cast,
    exp in that dtype, divided by its f32 sum cast back."""
    if logits_dtype == torch.float32:
        return torch.softmax(s, dim=-1)
    m = torch.amax(s, dim=-1, keepdim=True).detach()
    p = torch.exp((s - m).to(logits_dtype))
    return p / torch.sum(p.float(), dim=-1, keepdim=True).to(logits_dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: torch.Tensor, logits_dtype=torch.float32) -> torch.Tensor:
    """One token's queries (B, 1, KV, G, hd) against the cache k, v
    (B, Smax, KV, hd) up to each lane's position ``pos`` ((B,) long), with
    the softmax of ``logits_dtype``."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float() * hd ** -0.5, k.float())
    k_pos = torch.arange(k.shape[1], device=k.device)
    mask = (pos[:, None] >= k_pos)[:, None, None, None]    # (B,1,1,1,Smax)
    s = torch.where(mask, s, NEG_INF)
    p = softmax(s, logits_dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)


def _causal_rounded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logits_dtype: torch.dtype) -> torch.Tensor:
    """The whole-sequence causal attention of ``_attend_math`` with logits
    rounded to ``logits_dtype``, in plain tensor ops (its gradient is
    autograd's): q (B, S, H, hd), k, v (B, S, KV, hd) -> (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * hd ** -0.5,
                     k.float())
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, NEG_INF)
    p = softmax(s, logits_dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), v)
    return out.reshape(B, S, H, hd)


def causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) -> (B, S, H, hd).

    ``kernels/flash/ops.flash_attention`` (the flash kernel on the card, its
    plain version on the CPU, with a gradient) reads the (B, S, H, hd)
    tensors in place as (B, H, S, hd) views; its output is stored
    (B, S, H, hd), so the transpose back is a view too.  On the CPU with
    logits other than f32, ``_causal_rounded`` (the module's note)."""
    ldt = DTYPES[cfg.attn_logits_dtype]
    if ldt != torch.float32 and q.device.type == "cpu":
        return _causal_rounded(q, k, v, ldt)
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
    position; with ``mrope`` all three position streams are the lane's).
    Writes this token's k, v into the caches in place (the reference
    returns new caches) and returns the sublayer output (B, 1, D)."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((B,), pos, dtype=torch.long, device=x.device)
    positions = pos[:, None]                              # (B, 1)
    if cfg.mrope:                   # the three streams at the lane's pos
        positions = positions[None].expand(3, B, 1)
    q, k, v = _project_qkv(cfg, p, x, positions)
    lanes = torch.arange(B, device=x.device)
    cache_k[lanes, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[lanes, pos] = v[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, 1, KV, H // KV, hd)
    out = _attend(qg, cache_k, cache_v, pos,
                  DTYPES[cfg.attn_logits_dtype])
    return torch.matmul(out.reshape(B, 1, H * hd), p["wo"])
