"""Sketchy AdaGrad, S-AdaGrad (paper Alg. 2), on the shared engine (port of
repro/core/sadagrad.py :26-90).

It works on one d-dimensional decision vector in the OCO setting (paper
Sec. 2) and on the serving path's flattened head (serve/adapt.py): a
left-only FD sketch over the (d, 1) gradient column with exponent -1/2, no
grafting, refreshed every step.  The sketch is one tall (d, ell) factor, so
its refresh Gram and its apply run through the single-block kernels that
split over d (``KERNELS.gram``, ``KERNELS.lowrank_apply``).

The Appendix-A competitors (Ada-FD, FD-SON, RFD-SON, diagonal AdaGrad,
OGD) are not ported yet (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import api, pool
from repro_torch.core.fd import (FDState, fd_apply_inverse_root, fd_init,
                                 fd_update)
from repro_torch.core.transform import GradientTransformation

ENGINE = api.EngineConfig(block_size=1 << 30, beta2=1.0, update_every=1,
                          graft="none", treat_vectors_as_columns=True)


@dataclasses.dataclass(frozen=True)
class SAdaGradPreconditioner:
    """Alg. 2: FD-sketch the gradient stream, compensate with rho I,
    precondition by the -1/2 root.  ``ell`` is used only at init; ``beta2``
    is the FD EMA decay (paper Obs. 6): 1.0 is the unweighted regret
    setting, < 1 forgets old mass, which serve-time adaptation wants under
    drift.  It may be an f32 scalar tensor (an injected hyperparameter).

    The engine loops the per-block ``refresh`` and ``precondition`` over
    the pool dim (one block for a d-vector)."""
    ell: int = 0
    beta2: Any = 1.0

    def init_block(self, grp: pool.PoolGroup, *, device) -> FDState:
        return fd_init(grp.bs_m, min(self.ell, grp.bs_m),
                       num_blocks=grp.num_blocks, device=device)

    def refresh(self, state: FDState, G: torch.Tensor) -> FDState:
        return fd_update(state, G, beta2=self.beta2)

    def precondition(self, state: FDState, G: torch.Tensor) -> torch.Tensor:
        return fd_apply_inverse_root(state, G, exponent=-0.5, eps=0.0)


def sadagrad(ell: int, beta2=1.0) -> GradientTransformation:
    """S-AdaGrad as a direction transform on the shared engine."""
    return api.scale_by_preconditioner(SAdaGradPreconditioner(ell, beta2),
                                       ENGINE)


# the update never depends on ell (it reads the state's shapes), so one
# transform serves every step call
_STEP_TX = sadagrad(0)


class SAdaGradState(NamedTuple):
    opt: Any    # engine PrecondState

    @property
    def sketch(self) -> FDState:
        """The (d, ell) FD sketch, unbatched."""
        return FDState(*(x[0] for x in api.pool_stats(self.opt)))


def sadagrad_init(d: int, ell: int, device="cuda") -> SAdaGradState:
    return SAdaGradState(opt=sadagrad(ell).init(
        [torch.zeros((d,), dtype=torch.float32, device=device)]))


def sadagrad_step(state: SAdaGradState, x: torch.Tensor, g: torch.Tensor,
                  lr) -> tuple[torch.Tensor, SAdaGradState]:
    """One OCO step: ``x - lr * direction``."""
    (direction,), opt = _STEP_TX.update([g], state.opt)
    return x - lr * direction, SAdaGradState(opt=opt)
