"""Architecture registry (port of the ``get_config`` / ``get_reduced`` part
of repro/configs/registry.py), with every architecture of the reference:
the dense paper-lm-100m, phi3-mini-3.8b, qwen2.5-32b, qwen3-32b and
gemma-2b, the moe deepseek-moe-16b and kimi-k2-1t-a32b, mamba2-370m (ssm),
zamba2-7b (hybrid), qwen2-vl-72b (vlm) and musicgen-large (audio)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ALIASES = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "zamba2-7b": "zamba2_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "gemma-2b": "gemma_2b",
    "qwen3-32b": "qwen3_32b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "musicgen-large": "musicgen_large",
    "mamba2-370m": "mamba2_370m",
    "paper-lm-100m": "paper_lm_100m",
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALIASES.values():
        raise ValueError(f"unknown architecture {name!r}; ported: "
                         f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Smoke-test variant: same family and features, tiny dims (the
    reference's reduction, repro/configs/registry.py:57-87)."""
    cfg = get_config(name)
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    if cfg.num_kv_heads == 1:
        kv = 1
    repl = dict(
        num_layers=max(2, min(3, cfg.num_layers)),
        d_model=64,
        vocab_size=256,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        dense_ff=128 if cfg.dense_ff else 0,
        num_experts=8 if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        attn_every=2 if cfg.attn_every else 0,
        capacity_factor=8.0,
        q_chunk=32,
        remat=False,
        dtype="float32",
        first_dense_layers=min(cfg.first_dense_layers, 1),
    )
    if cfg.family == "hybrid":
        repl["num_layers"] = 4
    return dataclasses.replace(cfg, **repl)
