"""Sketchy Shampoo (paper Alg. 3 + Obs. 6 EMA variant) on the shared engine
(port of repro/core/sketchy.py).

Per matrix block, every ``update_every`` steps:
    (rho_L, L-sketch) <- FD-update(beta2 * L-sketch, G G^T)
    (rho_R, R-sketch) <- FD-update(beta2 * R-sketch, G^T G)
and every step:
    P = (L-sketch + (rho_L+eps) I)^{-1/4} G (R-sketch + (rho_R+eps) I)^{-1/4}
all in factored (U, s, rho) form, one call per packed pool stack.  Under
int8 storage with the fused path, U arrives as an int8 ``QuantizedPool`` and
core/fd.py runs both on the int8 values.

The rank budget (``RankBudget``) stores every block's sketch pair at the
capacity ``min(max_k, dim)`` and gives block b an active rank ``k_b``, a
masked prefix of its ladder, with ``sum_b k_b`` fixed.  The ``"static"``
policy keeps every block at capacity (the unmasked path); ``"rho_greedy"``
re-pours the budget at refresh boundaries by descending escaped-mass
pressure (``realloc_pools``).

Sharded statistics (``stats_reduction="sharded"``, core/api.py): each rank
refreshes both sketches on its own gradients and merges them over the
ranks (``refresh_sharded_batched``), the factors on the wire in
``stats_wire_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, NamedTuple, Optional

import torch

from repro_torch.core import api, pool
from repro_torch.core.fd import (FDState, fd_apply_inverse_root_batched,
                                 fd_init, fd_resize_batched,
                                 fd_update_batched)
from repro_torch.core.transform import GradientTransformation
from repro_torch.distributed.sketch_merge import WIRE_DTYPES

DEFAULT_RANK = 256                  # paper fixes 256 (untuned)
MATRIX_EPS = 1e-6                   # damping added to rho (Alg. 3)
EXPONENT = -0.25                    # per-side inverse root (Alg. 3)
RANK_POLICIES = ("static", "rho_greedy")


@dataclasses.dataclass(frozen=True)
class RankBudget:
    """One fixed total sketch rank over all blocks (module docstring).
    ``total=None`` resolves to ``N_blocks * max_k`` at init; an explicit
    total must satisfy ``N * min_k <= total <= N * max_k``.
    ``realloc_every`` counts refresh windows (``update_every`` steps)."""
    total: Optional[int] = None
    min_k: int = 1
    max_k: int = DEFAULT_RANK
    realloc_every: int = 1
    policy: str = "static"          # static | rho_greedy

    def __post_init__(self):
        if self.policy not in RANK_POLICIES:
            raise ValueError(f"unknown RankBudget policy {self.policy!r}; "
                             f"expected one of {RANK_POLICIES}")
        if not 1 <= self.min_k <= self.max_k:
            raise ValueError(f"need 1 <= min_k <= max_k, got "
                             f"min_k={self.min_k} max_k={self.max_k}")
        if self.realloc_every < 1:
            raise ValueError(f"realloc_every must be >= 1, got "
                             f"{self.realloc_every}")

    def resolve_total(self, num_blocks: int) -> int:
        """The total once the model's block count is known."""
        total = self.total if self.total is not None \
            else num_blocks * self.max_k
        if not num_blocks * self.min_k <= total <= num_blocks * self.max_k:
            raise ValueError(
                f"rank budget total={total} infeasible for {num_blocks} "
                f"blocks with min_k={self.min_k} max_k={self.max_k}: need "
                f"{num_blocks * self.min_k} <= total <= "
                f"{num_blocks * self.max_k}")
        return total


@dataclasses.dataclass(frozen=True)
class SketchyConfig:
    rank_budget: RankBudget = RankBudget()
    block_size: int = 1024          # paper App. C
    beta2: Any = 0.999              # second-moment EMA (paper §5.2)
    update_every: int = 10          # FD observes every k-th gradient (§6)
    start_preconditioning_step: int = 0
    diag_eps: Optional[float] = None      # diag-fallback damping (api.py)
    graft: str = "rmsprop_normalized"     # rmsprop_normalized | rmsprop | none
    refresh_schedule: str = "synchronized"  # synchronized | staggered
    refresh_mode: str = "inline"            # inline | async (core/api.py)
    profile_annotations: bool = False       # engine spans (core/api.py)
    second_moment_dtype: str = "fp32"   # fp32 | bf16 | int8 (quantize.py)
    quantized_epilogue: str = "auto"    # fused int8 path (api.EngineConfig)
    # "replicated" | "sharded": local refreshes merged over the process group
    # bound to ``stats_axis`` (core/api.py), the factors exchanged in
    # ``stats_wire_dtype``: "int8" (about (ell - 1) * d bytes a block a
    # round) or "fp32" (exact: the FD merge bound holds with no rounding)
    stats_reduction: str = "replicated"
    stats_axis: str = "data"
    stats_wire_dtype: str = "int8"

    def __post_init__(self):
        if self.stats_wire_dtype not in WIRE_DTYPES:
            raise ValueError(f"unknown stats_wire_dtype "
                             f"{self.stats_wire_dtype!r}; expected one of "
                             f"{WIRE_DTYPES}")


class SketchyBlockStats(NamedTuple):
    """FD sketch pair of a pool stack: leaves carry the pool dim N."""
    left: FDState
    right: FDState

    second_moments = ("left", "right")     # core/quantize.py


class BudgetedSketchStats(NamedTuple):
    """``SketchyBlockStats`` plus the active ranks ``k`` (N,) int32 of a
    policy other than static.  ``k`` counts each block once; each side
    clips it to its own capacity.  It is no second moment: stored as it
    is, counted in no byte."""
    left: FDState
    right: FDState
    k: torch.Tensor

    second_moments = ("left", "right")     # core/quantize.py
    roles = {"k": "count"}                 # train/checkpoint.py


def _sketch_pressure(fd: FDState) -> torch.Tensor:
    """(N,) escaped-mass ratio ``rho / (trace + rho)``, eigenvalues and rho
    clamped at 0 (repro/core/sketchy.py :201, not fd.fd_pressure): high
    means the block's sketch drops mass and wants columns."""
    trace = torch.sum(torch.clamp(fd.eigvals.float(), min=0.0), dim=-1)
    rho = torch.clamp(fd.rho.float(), min=0.0)
    return rho / (trace + rho + 1e-30)


@dataclasses.dataclass(frozen=True)
class SketchyPreconditioner:
    cfg: SketchyConfig

    # the refresh and the apply run on int8 eigenvectors (core/fd.py), so
    # the engine hands them the int8 containers (api.scale_by_preconditioner)
    supports_quantized_compute: ClassVar[bool] = True

    def init_block(self, grp: pool.PoolGroup, *, device):
        """Zero f32 sketch pair for every block of one pool group (the
        engine stores it in the configured layout); with a policy other
        than static also the active ranks, at ``min_k`` until
        ``finalize_init_pools`` spreads the budget."""
        budget = self.cfg.rank_budget
        kw = dict(num_blocks=grp.num_blocks, device=device)
        left = fd_init(grp.bs_m, budget.max_k, torch.float32, **kw)
        right = fd_init(grp.bs_n, budget.max_k, torch.float32, **kw)
        if budget.policy == "static":
            return SketchyBlockStats(left=left, right=right)
        k = torch.full((grp.num_blocks,), budget.min_k, dtype=torch.int32,
                       device=device)
        return BudgetedSketchStats(left=left, right=right, k=k)

    def finalize_init_pools(self, groups, stacks: dict) -> dict:
        """Engine init hook: the uniform allocation of the budget over the
        blocks of every group, in pool order (the budget is global)."""
        budget = self.cfg.rank_budget
        if budget.policy == "static":
            return stacks
        n = sum(g.num_blocks for g in groups)
        device = stacks[groups[0].key].k.device
        k_all = pool.uniform_ranks(n, budget.resolve_total(n), budget.min_k,
                                   budget.max_k, device=device)
        return self._split(groups, stacks, k_all,
                           lambda st, k: st._replace(k=k))

    def realloc_pools(self, groups, stacks: dict) -> dict:
        """Engine refresh-boundary hook: re-pour the budget by the
        escaped-mass pressure summed over the sides (``pool.allocate_ranks``,
        ceiling the scalar ``max_k``); shrunk blocks fold their dropped
        eigenvalues into rho (``fd_resize_batched``), grown blocks unmask
        zero columns."""
        budget = self.cfg.rank_budget
        n = sum(g.num_blocks for g in groups)
        pressure = torch.cat([_sketch_pressure(stacks[g.key].left)
                              + _sketch_pressure(stacks[g.key].right)
                              for g in groups])
        k_all = pool.allocate_ranks(pressure, total=budget.resolve_total(n),
                                    min_k=budget.min_k, max_k=budget.max_k)
        return self._split(groups, stacks, k_all, lambda st, k: st._replace(
            left=fd_resize_batched(st.left, k),
            right=fd_resize_batched(st.right, k), k=k))

    @staticmethod
    def _split(groups, stacks: dict, k_all: torch.Tensor, put) -> dict:
        """``put(stack, k)`` for each group's slice of ``k_all``."""
        out, offset = dict(stacks), 0
        for g in groups:
            out[g.key] = put(stacks[g.key],
                             k_all[offset:offset + g.num_blocks])
            offset += g.num_blocks
        return out

    def refresh_batched(self, state, G: torch.Tensor):
        # a budgeted stack masks each block at its active rank; the static
        # one has no ``k`` and takes the unmasked path
        active_k = getattr(state, "k", None)
        beta2 = self.cfg.beta2
        return state._replace(
            left=fd_update_batched(state.left, G, beta2, active_k),
            right=fd_update_batched(state.right, G.mT, beta2, active_k))

    def refresh_sharded_batched(self, state, G: torch.Tensor, *, axis: str,
                                axis_size: int):
        """The sharded refresh (repro/core/sketchy.py :332): both sketches
        refreshed on this rank's gradient stack G, then merged over the
        ranks of ``axis`` (``butterfly_merge_fd``), so every rank ends with
        the same sketches.

        The incoming sketches are the same on every rank (the last merge
        left them so) and the merge sums covariances, so they enter scaled
        by 1/P: merged ~= beta2 S_prev + (1/P) sum_i G_i G_i^T (the engine
        scaled G by 1/sqrt(P)), the replicated ``beta2 S_prev + Gbar
        Gbar^T`` when the ranks' gradients agree.  A rank budget's blocks
        are masked again after the merge, which sketches at the full
        capacity: the mass past a block's rank folds into rho."""
        from repro_torch.distributed import reduce as dreduce
        inv = 1.0 / axis_size
        scale = lambda fd: FDState(eigvecs=fd.eigvecs,
                                   eigvals=fd.eigvals * inv, rho=fd.rho * inv)
        state = state._replace(left=scale(state.left),
                               right=scale(state.right))
        local = self.refresh_batched(state, G)
        merge = lambda st: dreduce.butterfly_merge_fd(
            st, axis=axis, axis_size=axis_size,
            wire_dtype=self.cfg.stats_wire_dtype)
        merged = local._replace(left=merge(local.left),
                                right=merge(local.right))
        active_k = getattr(merged, "k", None)
        if active_k is not None:
            merged = merged._replace(
                left=fd_resize_batched(merged.left, active_k),
                right=fd_resize_batched(merged.right, active_k))
        return merged

    def precondition_batched(self, state, G: torch.Tensor) -> torch.Tensor:
        kw = dict(exponent=EXPONENT, eps=MATRIX_EPS)
        tmp = fd_apply_inverse_root_batched(state.left, G, **kw)
        return fd_apply_inverse_root_batched(state.right, tmp.mT, **kw).mT


def sketchy(cfg: SketchyConfig = SketchyConfig()) -> GradientTransformation:
    """S-Shampoo direction transform (emits a descent direction, no lr)."""
    budget = cfg.rank_budget
    return api.scale_by_preconditioner(
        SketchyPreconditioner(cfg),
        api.EngineConfig(
            block_size=cfg.block_size, beta2=cfg.beta2,
            update_every=cfg.update_every,
            start_preconditioning_step=cfg.start_preconditioning_step,
            graft=cfg.graft, diag_eps=cfg.diag_eps,
            refresh_schedule=cfg.refresh_schedule,
            refresh_mode=cfg.refresh_mode,
            second_moment_dtype=cfg.second_moment_dtype,
            quantized_epilogue=cfg.quantized_epilogue,
            stats_reduction=cfg.stats_reduction,
            stats_axis=cfg.stats_axis,
            realloc_every=(0 if budget.policy == "static"
                           else budget.realloc_every),
            profile_annotations=cfg.profile_annotations))
