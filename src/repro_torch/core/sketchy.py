"""Sketchy Shampoo (paper Alg. 3 + Obs. 6 EMA variant) on the shared engine
(port of repro/core/sketchy.py, static rank budget).

Per matrix block, every ``update_every`` steps:
    (rho_L, L-sketch) <- FD-update(beta2 * L-sketch, G G^T)
    (rho_R, R-sketch) <- FD-update(beta2 * R-sketch, G^T G)
and every step:
    P = (L-sketch + (rho_L+eps) I)^{-1/4} G (R-sketch + (rho_R+eps) I)^{-1/4}
all in factored (U, s, rho) form, one call per packed pool stack.  Under
int8 storage with the fused path, U arrives as an int8 ``QuantizedPool`` and
core/fd.py runs both on the int8 values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, NamedTuple

import torch

from repro_torch.core import api, pool
from repro_torch.core.fd import (FDState, fd_apply_inverse_root_batched,
                                 fd_init, fd_update_batched)
from repro_torch.core.transform import GradientTransformation

DEFAULT_RANK = 256                  # paper fixes 256 (untuned)
MATRIX_EPS = 1e-6                   # damping added to rho (Alg. 3)
EXPONENT = -0.25                    # per-side inverse root (Alg. 3)


@dataclasses.dataclass(frozen=True)
class RankBudget:
    """Sketch rank per block.  Only the ``"static"`` policy is ported: every
    block keeps rank ``max_k`` (its capacity ``min(max_k, dim)``)."""
    max_k: int = DEFAULT_RANK
    policy: str = "static"

    def __post_init__(self):
        if self.policy != "static":
            raise NotImplementedError(
                f"RankBudget(policy={self.policy!r}) is not ported yet "
                f"(ROADMAP.md queue 1 item 10); the port runs 'static'")
        if self.max_k < 1:
            raise ValueError(f"need max_k >= 1, got {self.max_k}")


@dataclasses.dataclass(frozen=True)
class SketchyConfig:
    rank_budget: RankBudget = RankBudget()
    block_size: int = 1024          # paper App. C
    beta2: Any = 0.999              # second-moment EMA (paper §5.2)
    update_every: int = 10          # FD observes every k-th gradient (§6)
    start_preconditioning_step: int = 0
    refresh_schedule: str = "synchronized"
    refresh_mode: str = "inline"
    second_moment_dtype: str = "fp32"   # fp32 | bf16 | int8 (quantize.py)
    quantized_epilogue: str = "auto"    # fused int8 path (api.EngineConfig)
    stats_reduction: str = "replicated"


class SketchyBlockStats(NamedTuple):
    """FD sketch pair of a pool stack: leaves carry the pool dim N."""
    left: FDState
    right: FDState

    second_moments = ("left", "right")     # core/quantize.py


@dataclasses.dataclass(frozen=True)
class SketchyPreconditioner:
    cfg: SketchyConfig

    # the refresh and the apply run on int8 eigenvectors (core/fd.py), so
    # the engine hands them the int8 containers (api.scale_by_preconditioner)
    supports_quantized_compute: ClassVar[bool] = True

    def init_block(self, grp: pool.PoolGroup, *, device) -> SketchyBlockStats:
        """Zero f32 sketch pair for every block of one pool group (the
        engine stores it in the configured layout)."""
        k = self.cfg.rank_budget.max_k
        kw = dict(num_blocks=grp.num_blocks, device=device)
        return SketchyBlockStats(
            left=fd_init(grp.bs_m, k, torch.float32, **kw),
            right=fd_init(grp.bs_n, k, torch.float32, **kw))

    def refresh_batched(self, state: SketchyBlockStats, G: torch.Tensor
                        ) -> SketchyBlockStats:
        return SketchyBlockStats(
            left=fd_update_batched(state.left, G, self.cfg.beta2),
            right=fd_update_batched(state.right, G.mT, self.cfg.beta2))

    def precondition_batched(self, state: SketchyBlockStats,
                             G: torch.Tensor) -> torch.Tensor:
        kw = dict(exponent=EXPONENT, eps=MATRIX_EPS)
        tmp = fd_apply_inverse_root_batched(state.left, G, **kw)
        return fd_apply_inverse_root_batched(state.right, tmp.mT, **kw).mT


def sketchy(cfg: SketchyConfig = SketchyConfig()) -> GradientTransformation:
    """S-Shampoo direction transform (emits a descent direction, no lr)."""
    return api.scale_by_preconditioner(
        SketchyPreconditioner(cfg),
        api.EngineConfig(
            block_size=cfg.block_size, beta2=cfg.beta2,
            update_every=cfg.update_every,
            start_preconditioning_step=cfg.start_preconditioning_step,
            refresh_schedule=cfg.refresh_schedule,
            refresh_mode=cfg.refresh_mode,
            second_moment_dtype=cfg.second_moment_dtype,
            quantized_epilogue=cfg.quantized_epilogue,
            stats_reduction=cfg.stats_reduction))
