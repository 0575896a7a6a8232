"""Blocked full-matrix Shampoo, the paper's primary baseline (port of
repro/core/shampoo.py), as a preconditioner on the shared engine.

Per block, dense factors L (bm x bm) and R (bn x bn) accumulate an EMA of
``G G^T`` and ``G^T G`` every step; every ``root_every`` steps the inverse
4th roots ``PL, PR = (M + eps I)^-1/4`` are recomputed by ``eigh`` with the
eigenvalues clamped at eps; every step the direction is ``PL G PR``.
Second-moment memory is O(bm^2 + bn^2) a block, what Sketchy reduces.  The
engine's refresh schedules and modes (core/api.py) gate the roots: a
staggered schedule recomputes a group's due blocks' roots, async commits
them a step later; L and R accumulate every step either way.

``L += G G^T`` is the Gram of ``G^T`` and ``R += G^T G`` the Gram of G, so
both go through ``KERNELS.batched_gram`` over the whole pool stack (kernel
1 on the card), which reads a contiguous stack: ``G^T`` is copied first.
The roots' ``eigh`` and the ``PL G PR`` products are library calls in both
packages.  L and R are the second moments (stored in bf16 or int8 under
those storages, then dequantized at the pool boundary: Shampoo has no
fused int8 path); the cached roots stay f32 and are not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import api, pool
from repro_torch.core.fd import _eigh
from repro_torch.core.transform import GradientTransformation
from repro_torch.kernels.registry import KERNELS

MATRIX_EPS = 1e-6                   # damping of L and R before the root


@dataclasses.dataclass(frozen=True)
class ShampooConfig:
    block_size: int = 1024
    beta2: Any = 0.999              # may be an f32 scalar tensor (injected)
    root_every: int = 10            # paper: preconditioning_compute_steps
    start_preconditioning_step: int = 0
    diag_eps: Optional[float] = None    # diag-fallback damping (api.py)
    graft: str = "rmsprop_normalized"   # rmsprop_normalized | rmsprop | none
    refresh_schedule: str = "synchronized"  # synchronized | staggered
    refresh_mode: str = "inline"            # inline | async (core/api.py)
    profile_annotations: bool = False       # engine spans (core/api.py)
    second_moment_dtype: str = "fp32"   # fp32 | bf16 | int8 (quantize.py)


class ShampooBlockStats(NamedTuple):
    """Dense factors and cached roots of a pool stack (leading dim N)."""
    L: torch.Tensor      # (N, bm, bm) EMA statistic
    R: torch.Tensor      # (N, bn, bn)
    PL: torch.Tensor     # cached L^-1/4
    PR: torch.Tensor     # cached R^-1/4

    # core/quantize.py; the roots are the reference's role "preconditioner"
    # (train/checkpoint.py)
    second_moments = ("L", "R")
    roles = {"PL": "preconditioner", "PR": "preconditioner"}


def _inv_root(m: torch.Tensor, eps: float, power: float) -> torch.Tensor:
    """(N, d, d) PSD stack -> ``(M + eps I)^power`` by ``eigh``, eigenvalues
    clamped at eps.  M is symmetrized first, as ``jnp.linalg.eigh`` does."""
    d = m.shape[-1]
    eye = torch.eye(d, dtype=m.dtype, device=m.device)
    lam, V = _eigh(0.5 * (m + m.mT) + eps * eye)
    lam = torch.clamp(lam, min=eps)
    return torch.matmul(V * torch.pow(lam, power)[..., None, :], V.mT)


@dataclasses.dataclass(frozen=True)
class ShampooPreconditioner:
    cfg: ShampooConfig

    def init_block(self, grp: pool.PoolGroup, *, device
                   ) -> ShampooBlockStats:
        """Zero factors and identity roots for every block of one pool
        group."""
        N = grp.num_blocks

        def zeros(d):
            return torch.zeros((N, d, d), dtype=torch.float32, device=device)

        def eyes(d):
            return torch.eye(d, dtype=torch.float32,
                             device=device).expand(N, d, d).clone()

        return ShampooBlockStats(L=zeros(grp.bs_m), R=zeros(grp.bs_n),
                                 PL=eyes(grp.bs_m), PR=eyes(grp.bs_n))

    def update_stats_batched(self, state: ShampooBlockStats,
                             G: torch.Tensor) -> ShampooBlockStats:
        """Un-normalized EMA, every step: ``L = beta2 L + G G^T``, ``R =
        beta2 R + G^T G``, the Grams through the batched Gram kernel."""
        beta2 = self.cfg.beta2
        L_inc = KERNELS.batched_gram(G.mT.contiguous())
        R_inc = KERNELS.batched_gram(G)
        return state._replace(L=beta2 * state.L + L_inc,
                              R=beta2 * state.R + R_inc)

    def refresh_batched(self, state: ShampooBlockStats,
                        G: torch.Tensor) -> ShampooBlockStats:
        return state._replace(PL=_inv_root(state.L, MATRIX_EPS, -0.25),
                              PR=_inv_root(state.R, MATRIX_EPS, -0.25))

    def precondition_batched(self, state: ShampooBlockStats,
                             G: torch.Tensor) -> torch.Tensor:
        return torch.matmul(torch.matmul(state.PL, G), state.PR)


def shampoo(cfg: ShampooConfig = ShampooConfig()) -> GradientTransformation:
    """Blocked Shampoo direction transform (emits a descent direction, no
    lr)."""
    return api.scale_by_preconditioner(
        ShampooPreconditioner(cfg),
        api.EngineConfig(
            block_size=cfg.block_size, beta2=cfg.beta2,
            update_every=cfg.root_every,
            start_preconditioning_step=cfg.start_preconditioning_step,
            graft=cfg.graft, diag_eps=cfg.diag_eps,
            refresh_schedule=cfg.refresh_schedule,
            refresh_mode=cfg.refresh_mode,
            profile_annotations=cfg.profile_annotations,
            second_moment_dtype=cfg.second_moment_dtype))
