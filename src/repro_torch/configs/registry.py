"""Architecture registry (port of the ``get_config`` / ``get_reduced`` part
of repro/configs/registry.py).  Only paper-lm-100m is ported; ROADMAP.md
queue 1 item 13 ports the other architectures."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ALIASES = {"paper-lm-100m": "paper_lm_100m"}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    if mod_name not in ALIASES.values():
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (ROADMAP.md queue 1 "
            f"item 13); ported: {sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_reduced(name: str) -> ModelConfig:
    """Smoke-test variant: same family and features, tiny dims (the
    reference's reduction, restricted to the fields a dense model uses)."""
    cfg = get_config(name)
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0
    if cfg.num_kv_heads == 1:
        kv = 1
    return dataclasses.replace(
        cfg,
        num_layers=max(2, min(3, cfg.num_layers)),
        d_model=64,
        vocab_size=256,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=kv,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        q_chunk=32,
        remat=False,
        dtype="float32",
    )
