"""Optimizer factory: config -> full training transformation chain (port of
repro/core/factory.py).

Chain layout (paper App. C), as a labelled ``named_chain`` inside
``inject_hyperparams`` (lr and beta2 evaluated every step):
  clip -> precond (sketchy | shampoo | adam) -> momentum (EMA; not for
  adam, which keeps its own first moment) -> weight_decay -> lr
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import adam as adam_lib
from repro_torch.core import api, schedules, transform
from repro_torch.core import shampoo as shampoo_lib
from repro_torch.core import sketchy as sketchy_lib

OPTIMIZERS = ("sketchy", "shampoo", "adam")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "sketchy"              # sketchy | shampoo | adam
    learning_rate: float = 1e-3
    total_steps: int = 1000
    warmup_frac: float = 0.05
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    schedule: str = "warmup_cosine"    # warmup_cosine | constant
    rank: int = 256                    # sketchy only
    # the sketch-rank budget (sketchy only, core/sketchy.RankBudget); None
    # keeps every block at ``rank``, a budget supersedes ``rank``
    rank_budget: Optional[sketchy_lib.RankBudget] = None
    block_size: int = 1024
    update_every: int = 10             # sketchy's refresh, shampoo's roots
    start_preconditioning_step: int = 0
    # diagonal-fallback damping of vector and scalar leaves (sketchy and
    # shampoo); None keeps the grafting's epsilon (core/api.py)
    diag_eps: Optional[float] = None
    # refresh phasing and timing (core/api.py): "synchronized" |
    # "staggered", "inline" | "async"; sketchy and shampoo
    refresh_schedule: str = "synchronized"
    refresh_mode: str = "inline"
    # torch.profiler ranges around the engine's phases
    profile_annotations: bool = False
    # storage of the second-moment state between steps (core/quantize.py):
    # "fp32" | "bf16" | "int8"; sketchy and shampoo (adam's elementwise
    # state stays f32)
    second_moment_dtype: str = "fp32"
    # fused int8 compute (core/api.py EngineConfig): "auto" | "off" | "on";
    # sketchy only (shampoo's root solve needs f32 factors)
    quantized_epilogue: str = "auto"
    # "replicated" | "sharded" (core/api.py): sketchy only; Shampoo and Adam
    # keep replicated statistics under "sharded", as in the reference
    stats_reduction: str = "replicated"

    def __post_init__(self):
        if self.name not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.name!r}; expected one "
                             f"of {OPTIMIZERS}")
        if self.schedule not in ("warmup_cosine", "constant"):
            raise ValueError(f"unknown schedule {self.schedule!r}")


def _direction(cfg: OptimizerConfig,
               beta2) -> transform.GradientTransformation:
    refresh = dict(refresh_schedule=cfg.refresh_schedule,
                   refresh_mode=cfg.refresh_mode, diag_eps=cfg.diag_eps,
                   profile_annotations=cfg.profile_annotations)
    if cfg.name == "sketchy":
        budget = cfg.rank_budget if cfg.rank_budget is not None \
            else sketchy_lib.RankBudget(min_k=cfg.rank, max_k=cfg.rank)
        return sketchy_lib.sketchy(sketchy_lib.SketchyConfig(
            rank_budget=budget, block_size=cfg.block_size, beta2=beta2,
            update_every=cfg.update_every,
            start_preconditioning_step=cfg.start_preconditioning_step,
            second_moment_dtype=cfg.second_moment_dtype,
            quantized_epilogue=cfg.quantized_epilogue,
            stats_reduction=cfg.stats_reduction, **refresh))
    if cfg.name == "shampoo":
        return shampoo_lib.shampoo(shampoo_lib.ShampooConfig(
            block_size=cfg.block_size, beta2=beta2,
            root_every=cfg.update_every,
            start_preconditioning_step=cfg.start_preconditioning_step,
            second_moment_dtype=cfg.second_moment_dtype, **refresh))
    return adam_lib.adam(adam_lib.AdamConfig(beta1=cfg.beta1, beta2=beta2))


def make_optimizer(cfg: OptimizerConfig) -> transform.GradientTransformation:
    def build(learning_rate, beta2):
        stages = []
        if cfg.grad_clip:
            stages.append(("clip",
                           transform.clip_by_global_norm(cfg.grad_clip)))
        stages.append(("precond", _direction(cfg, beta2)))
        if cfg.name != "adam":   # adam keeps its own first moment
            stages.append(("momentum", transform.momentum(cfg.beta1, ema=True)))
        if cfg.weight_decay:
            stages.append(("weight_decay",
                           transform.add_decayed_weights(cfg.weight_decay)))
        stages.append(("lr", transform.scale(-1.0 * learning_rate)))
        return api.named_chain(*stages)

    if cfg.schedule == "warmup_cosine":
        lr_hyper = schedules.warmup_cosine(cfg.learning_rate, cfg.total_steps,
                                           cfg.warmup_frac)
    else:
        lr_hyper = cfg.learning_rate
    return api.inject_hyperparams(build)(learning_rate=lr_hyper,
                                         beta2=cfg.beta2)
