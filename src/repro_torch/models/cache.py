"""Decode caches and the one-token decode step of the dense family (port of
repro/models/cache.py :26-112, :145-173).

Cache layout, stacked over layers: attention k/v (L, B, Smax, KV, hd) in
the model's dtype.  The mamba and hybrid layouts of the reference (and its
moe, vlm and audio families) are not ported yet (ROADMAP.md queue 1 item
13).  The reference returns new caches from every call; here the decode
step and ``reset_lanes`` write into the cache tensors in place (one cache
per engine, no copy per token) and return the same dict.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import gated_mlp, rms_norm


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int
                 ) -> Dict[str, tuple]:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} cache layout is not ported yet "
            f"(ROADMAP.md queue 1 item 13); the port serves the dense family")
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": shape, "v": shape}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cpu") -> Dict[str, torch.Tensor]:
    dtype = model_lib.DTYPES[cfg.dtype]
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, shape in cache_shapes(cfg, batch, max_seq).items()}


def reset_lanes(cache: Dict[str, torch.Tensor],
                lane_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero the lanes marked in ``lane_mask`` ((B,) bool), in place: the
    slot-reuse primitive, a freed lane is wiped before a queued request
    prefills into it.  Batch is axis 1 of every cache tensor."""
    for x in cache.values():
        mask = lane_mask.reshape((1, -1) + (1,) * (x.ndim - 2))
        x.masked_fill_(mask, 0)
    return cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: Dict[str, torch.Tensor],
                batch: dict, pos):
    """One-token decode: ``batch["token"]`` (B, 1) long; ``pos`` an int,
    the write position shared by every lane (the cache holds [0, pos)), or
    a (B,) long tensor of per-lane positions (continuous batching).
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    model_lib.check_supported(cfg)
    x = model_lib.embed_tokens(cfg, params, {"tokens": batch["token"]})
    for i in range(cfg.num_layers):
        p_i = model_lib.layer(params["layers"], i)
        h = rms_norm(x, p_i["norm1"], cfg.norm_eps)
        x = x + attn_lib.attention_decode(cfg, p_i["attn"], h,
                                          cache["k"][i], cache["v"][i], pos)
        h = rms_norm(x, p_i["norm2"], cfg.norm_eps)
        x = x + gated_mlp(cfg, p_i["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return model_lib.project_logits(cfg, params, x), cache
