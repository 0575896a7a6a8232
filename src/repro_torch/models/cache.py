"""Decode caches and the one-token decode step of every family (port of
repro/models/cache.py :26-72, :84-112, :145-223).

Cache layouts, stacked over layers (batch is axis 1 of every tensor):
  dense, moe, vlm, audio: attention k/v (L, B, Smax, KV, hd), the moe
          family's dense layers first
  ssm:    ssm (L, B, H, P, N) in f32 and conv (L, B, W-1, conv_dim)
  hybrid: the ssm layout for all L layers, and attention k/v only at the
          shared-attention sites (n_sites, B, Smax, KV, hd)
in the model's dtype except the f32 SSM state.  The vlm decodes an
embedding ``batch["embed"]`` (B, 1, D) with M-RoPE at the lanes'
positions, the audio family tokens ``batch["token"]`` (B, 1, K) into
(B, 1, K, V) logits, as the reference renames them (:94-98).  The
moe family decodes its dense layers against ``k[:fd]``, ``v[:fd]`` and its
moe layers against ``k[fd:]``, ``v[fd:]``, the moe sublayer in place of
the MLP (reference :127-130, :145-171).  The reference
returns new caches from every call; here the decode step and
``reset_lanes`` write into the cache tensors in place (one cache per
engine, no copy per token) and return the same dict.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import tree
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int
                 ) -> Dict[str, tuple]:
    L, B = cfg.num_layers, batch
    kv = (max_seq, cfg.num_kv_heads, cfg.head_dim)
    if cfg.family in model_lib.ATTENTION_STACKS:
        return {"k": (L, B) + kv, "v": (L, B) + kv}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    shapes = {
        "ssm": (L, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
        "conv": (L, B, cfg.ssm_conv_width - 1,
                 cfg.d_inner + 2 * cfg.ssm_state),
    }
    if cfg.family == "hybrid":
        n_sites = len(cfg.shared_attn_layers())
        shapes["k"] = (n_sites, B) + kv
        shapes["v"] = (n_sites, B) + kv
    return shapes


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cpu") -> Dict[str, torch.Tensor]:
    dtype = model_lib.DTYPES[cfg.dtype]
    return {name: torch.zeros(shape, device=device, dtype=torch.float32
                              if name == "ssm" else dtype)
            for name, shape in cache_shapes(cfg, batch, max_seq).items()}


def reset_lanes(cache: Dict[str, torch.Tensor],
                lane_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero the lanes marked in ``lane_mask`` ((B,) bool), in place: the
    slot-reuse primitive, a freed lane is wiped before a queued request
    prefills into it.  Attention k/v beyond a lane's position are masked
    anyway, but the SSM and conv states are cumulative, so a reused lane
    must be cleared.  Batch is axis 1 of every cache tensor."""
    for x in cache.values():
        mask = lane_mask.reshape((1, -1) + (1,) * (x.ndim - 2))
        x.masked_fill_(mask, 0)
    return cache


def _dense_layer_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                        cache_k: torch.Tensor, cache_v: torch.Tensor,
                        pos) -> torch.Tensor:
    """A dense or moe layer (by its parameters) against its cache."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_lib.attention_decode(cfg, p["attn"], h, cache_k, cache_v,
                                      pos)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + model_lib.mlp_sublayer(cfg, p, h)


def _mamba_layer_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                        cache: Dict[str, torch.Tensor], i: int
                        ) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    out, state, conv = ssm_lib.mamba_decode(cfg, p["mixer"], h,
                                            cache["ssm"][i], cache["conv"][i])
    cache["ssm"][i].copy_(state)
    cache["conv"][i].copy_(conv)
    return x + out


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, cache: Dict[str, torch.Tensor],
                batch: dict, pos):
    """One-token decode: ``batch["token"]`` (B, 1) long, (B, 1, K) with K
    codebooks, or ``batch["embed"]`` (B, 1, D) without ``embed_inputs``;
    ``pos`` an int, the write position shared by every lane (the cache
    holds [0, pos)), or a (B,) long tensor of per-lane positions
    (continuous batching).  Returns (logits (B, 1, V) or (B, 1, K, V),
    cache), the cache updated in place."""
    model_lib.check_supported(cfg)
    names = {"token": "tokens", "embed": "embeds"}
    x = model_lib.embed_tokens(cfg, params, {names.get(k, k): v
                                             for k, v in batch.items()})
    if cfg.family in model_lib.ATTENTION_STACKS:
        i = 0
        for stacked in model_lib.stacks(params):
            for j in range(tree.flatten(stacked)[0].shape[0]):
                x = _dense_layer_decode(cfg, model_lib.layer(stacked, j), x,
                                        cache["k"][i], cache["v"][i], pos)
                i += 1
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return model_lib.project_logits(cfg, params, x), cache
    sites = cfg.shared_attn_layers()
    for i in range(cfg.num_layers):
        p_i = model_lib.layer(params["layers"], i)
        if i in sites:
            s = sites.index(i)
            x = _dense_layer_decode(cfg, params["shared_attn"], x,
                                    cache["k"][s], cache["v"][s], pos)
        x = _mamba_layer_decode(cfg, p_i, x, cache, i)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return model_lib.project_logits(cfg, params, x), cache
