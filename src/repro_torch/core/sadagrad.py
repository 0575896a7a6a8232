"""Sketchy AdaGrad, S-AdaGrad (paper Alg. 2), on the shared engine, and the
Appendix-A convex competitors (port of repro/core/sadagrad.py).

S-AdaGrad works on one d-dimensional decision vector in the OCO setting
(paper Sec. 2) and on the serving path's flattened head (serve/adapt.py): a
left-only FD sketch over the (d, 1) gradient column with exponent -1/2, no
grafting, refreshed every step.  The sketch is one tall (d, ell) factor, so
its refresh Gram and its apply run through the single-block kernels that
split over d (``KERNELS.gram``, ``KERNELS.lowrank_apply``).

The competitors (paper Tbl. 3) keep their direct FD forms: Ada-FD and
FD-SON apply the sketch with a fixed ``delta I`` and no compensation
(exponent -1/2 and -1), RFD-SON compensates with ``rho / 2`` (exponent -1),
through the same ``fd_update`` and ``fd_apply_inverse_root``, so on the
card they run the same two kernels; diagonal AdaGrad and OGD run none.
Every learner is ``state = init(d[, ell], device=...)``, ``x, state =
step(state, x, g, lr[, delta])`` (``LEARNERS``).
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


# ---------------------------------------------------------------------------
# The Appendix-A competitors (repro/core/sadagrad.py :96-183)


def _fd_direction(sketch: FDState, rho: torch.Tensor, g: torch.Tensor, *,
                  exponent: float, eps: float) -> torch.Tensor:
    """``(U diag(s) U^T + (rho + eps) I)^exponent g`` with the sketch's
    ``rho`` replaced."""
    return fd_apply_inverse_root(sketch._replace(rho=rho), g[:, None],
                                 exponent=exponent, eps=eps)[:, 0]


class AdaFDState(NamedTuple):
    sketch: FDState


def adafd_init(d: int, ell: int, device="cuda") -> AdaFDState:
    return AdaFDState(sketch=fd_init(d, ell, device=device))


def adafd_step(state: AdaFDState, x: torch.Tensor, g: torch.Tensor, lr,
               delta: float) -> tuple[torch.Tensor, AdaFDState]:
    """Ada-FD: FD sketch plus a fixed ``delta I``, the escaped mass ignored
    (provably Omega(T^3/4) on the paper's Obs. 2 stream)."""
    sketch = fd_update(state.sketch, g[:, None], beta2=1.0)
    direction = _fd_direction(sketch, torch.zeros_like(sketch.rho), g,
                              exponent=-0.5, eps=delta)
    return x - lr * direction, AdaFDState(sketch=sketch)


class FDSONState(NamedTuple):
    sketch: FDState


def fdson_init(d: int, ell: int, device="cuda") -> FDSONState:
    return FDSONState(sketch=fd_init(d, ell, device=device))


def fdson_step(state: FDSONState, x: torch.Tensor, g: torch.Tensor, lr,
               delta: float) -> tuple[torch.Tensor, FDSONState]:
    """FD-SON: the Online-Newton-Step inverse (exponent -1) of the sketch
    with a fixed ``delta I``."""
    sketch = fd_update(state.sketch, g[:, None], beta2=1.0)
    direction = _fd_direction(sketch, torch.zeros_like(sketch.rho), g,
                              exponent=-1.0, eps=delta)
    return x - lr * direction, FDSONState(sketch=sketch)


class RFDSONState(NamedTuple):
    sketch: FDState


def rfdson_init(d: int, ell: int, device="cuda") -> RFDSONState:
    return RFDSONState(sketch=fd_init(d, ell, device=device))


def rfdson_step(state: RFDSONState, x: torch.Tensor, g: torch.Tensor, lr
                ) -> tuple[torch.Tensor, RFDSONState]:
    """RFD-SON (its delta = 0 variant, RFD_0): robust FD compensates with
    ``rho / 2`` in the ONS-style inverse."""
    sketch = fd_update(state.sketch, g[:, None], beta2=1.0)
    direction = _fd_direction(sketch, sketch.rho * 0.5, g, exponent=-1.0,
                              eps=0.0)
    return x - lr * direction, RFDSONState(sketch=sketch)


class DiagAdaGradState(NamedTuple):
    acc: torch.Tensor


def adagrad_init(d: int, device="cuda") -> DiagAdaGradState:
    return DiagAdaGradState(acc=torch.zeros((d,), dtype=torch.float32,
                                            device=device))


def adagrad_step(state: DiagAdaGradState, x: torch.Tensor, g: torch.Tensor,
                 lr) -> tuple[torch.Tensor, DiagAdaGradState]:
    acc = state.acc + torch.square(g)
    return x - lr * g * torch.rsqrt(acc + 1e-12), DiagAdaGradState(acc=acc)


def ogd_init(d: int, device="cuda") -> tuple:
    return ()


def ogd_step(state: tuple, x: torch.Tensor, g: torch.Tensor, lr
             ) -> tuple[torch.Tensor, tuple]:
    return x - lr * g, state


# name -> (init, step, which of ell and delta the learner takes)
LEARNERS = {
    "s-adagrad": (sadagrad_init, sadagrad_step, {"ell": True, "delta": False}),
    "ada-fd": (adafd_init, adafd_step, {"ell": True, "delta": True}),
    "fd-son": (fdson_init, fdson_step, {"ell": True, "delta": True}),
    "rfd-son": (rfdson_init, rfdson_step, {"ell": True, "delta": False}),
    "adagrad": (adagrad_init, adagrad_step, {"ell": False, "delta": False}),
    "ogd": (ogd_init, ogd_step, {"ell": False, "delta": False}),
}
