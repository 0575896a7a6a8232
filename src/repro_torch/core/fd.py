"""Frequent Directions sketches (port of repro/core/fd.py).

A sketch of the PSD stream ``G_t = sum_s beta2^{t-s} A_s A_s^T`` is kept in
eigenpair form ``(U, s, rho)``: ``U (d, ell)`` orthonormal columns, ``s``
descending eigenvalues with ``s[-1] == 0`` after deflation, and ``rho`` the
escaped mass behind the ``rho * I`` compensation.  Each update
eigendecomposes the small (ell+r) x (ell+r) Gram of ``M = [sqrt(beta2) B, A]``
instead of anything d x d.  The ``*_batched`` functions work on a whole pool
stack (leaves carry a leading pool dim N); ``fd_update`` and
``fd_apply_inverse_root`` on one unbatched sketch, the serving path's
monitor and S-AdaGrad over a flattened head.  The read-outs
(``fd_pressure``, ``fd_leading_eigval``, ``fd_subspace_angle``) take either.

The Gram and the low-rank apply go through the device-dispatching kernel
set of kernels/registry.py: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors; the single-block entries use the kernels that
split over d.  ``eigh`` is ``torch.linalg.eigh`` and ``svdvals``
``torch.linalg.svdvals``, library calls in both packages.

The eigenvector stack may arrive as an int8 ``QuantizedPool`` (the engine's
fused int8 path, core/api.py): then the refresh Gram, the eigenvector
write-back and the apply run on the int8 values through the fused kernel
entries, and no f32 eigenvector stack is formed.

The rank budget (core/sketchy.py) masks ranks: ``fd_update_batched`` with
``active_k`` runs each block at its leading ``active_k[b]`` ladder columns
of the stack's capacity, and ``fd_resize_batched`` moves blocks to new
active ranks, folding the dropped eigenvalue mass into ``rho``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.quantize import QuantizedPool
from repro_torch.kernels.registry import KERNELS


class FDState(NamedTuple):
    eigvecs: torch.Tensor  # ([N,] d, ell) approximate top eigenvectors U
    eigvals: torch.Tensor  # ([N,] ell) deflated eigenvalues, descending
    rho: torch.Tensor      # ([N]) accumulated escaped mass

    second_moments = ("eigvecs", "eigvals", "rho")     # core/quantize.py


def fd_init(d: int, ell: int, dtype=torch.float32, *,
            num_blocks: Optional[int] = None, device="cpu") -> FDState:
    """Zero sketch of dim ``d`` and rank ``min(ell, d)``: one unbatched
    sketch, or a stack of ``num_blocks``."""
    ell = min(ell, d)
    lead = () if num_blocks is None else (num_blocks,)
    return FDState(
        eigvecs=torch.zeros(lead + (d, ell), dtype=dtype, device=device),
        eigvals=torch.zeros(lead + (ell,), dtype=dtype, device=device),
        rho=torch.zeros(lead, dtype=dtype, device=device))


def fd_update(state: FDState, new_factor: torch.Tensor,
              beta2=1.0) -> FDState:
    """One FD step of an unbatched sketch on the PSD increment
    ``new_factor @ new_factor.T`` (new_factor (d, r), or (d,) for r = 1).
    The Gram of ``M`` (d, ell + r) goes through ``KERNELS.gram``."""
    U, s, rho = state
    ell = U.shape[-1]
    if new_factor.ndim == 1:
        new_factor = new_factor[:, None]
    compute_dtype = torch.promote_types(U.dtype, torch.float32)

    s_clamped = torch.clamp(beta2 * s.to(compute_dtype), min=0.0)
    # M = [U sqrt(s), new_factor] written in place, and U_new scaled in
    # place: at the serving monitor's d (209,715,200 for deepseek-moe-16b's
    # head) each (d, ell) temporary is 6.7 GB
    M = torch.empty((U.shape[0], ell + new_factor.shape[1]),
                    dtype=compute_dtype, device=U.device)
    torch.mul(U.to(compute_dtype), torch.sqrt(s_clamped)[None, :],
              out=M[:, :ell])
    M[:, ell:] = new_factor

    lam_top, V, inv_sqrt = _top_eigenpairs(KERNELS.gram(M), ell)
    rho_t = lam_top[..., ell - 1]
    U_new = torch.matmul(M, V[:, :ell]).mul_(inv_sqrt[None, :])
    return FDState(eigvecs=U_new.to(U.dtype),
                   eigvals=(lam_top - rho_t).to(s.dtype),   # last entry 0
                   rho=(beta2 * rho + rho_t).to(rho.dtype))


def fd_update_batched(state: FDState, new_factor: torch.Tensor,
                      beta2=1.0, active_k: Optional[torch.Tensor] = None
                      ) -> FDState:
    """One FD step on every block of the stack: the PSD increment of block
    n is ``new_factor[n] @ new_factor[n].T`` (new_factor (N, d, r)).

    ``active_k`` (N,) int masks ranks: block b runs at its leading
    ``active_k[b]`` ladder columns (clipped to the capacity ``ell``); only
    those enter the Gram, deflation subtracts ``lam[active_k[b] - 1]``, and
    the columns past it come back zero.  ``None`` is the unmasked step.

    With an int8 ``QuantizedPool`` eigenvector stack the step runs on the
    int8 values (``_fd_update_batched_quantized``) and returns a new
    ``QuantizedPool``."""
    U, s, rho = state
    if isinstance(U, QuantizedPool):
        return _fd_update_batched_quantized(U, s, rho, new_factor, beta2,
                                            active_k)
    ell = U.shape[-1]
    if new_factor.ndim == 2:
        new_factor = new_factor[..., None]
    compute_dtype = torch.promote_types(U.dtype, torch.float32)

    # the ladder is non-negative by construction; the clamp only guards
    # sqrt(negative) -> NaN if stored state was perturbed below zero
    s_clamped = torch.clamp(beta2 * s.to(compute_dtype), min=0.0)
    kmask = _rank_mask(active_k, ell)
    if kmask is not None:
        s_clamped = torch.where(kmask, s_clamped, 0.0)
    B = U.to(compute_dtype) * torch.sqrt(s_clamped)[:, None, :]
    M = torch.cat([B, new_factor.to(compute_dtype)], dim=2)

    lam_top, V, inv_sqrt = _top_eigenpairs(KERNELS.batched_gram(M), ell)
    rho_t = _escaped_eigval(lam_top, active_k, ell)
    U_new = torch.matmul(M, V[..., :ell]) * inv_sqrt[:, None, :]
    s_new = lam_top - rho_t[..., None]            # deflate: last entry 0
    if kmask is not None:
        U_new = torch.where(kmask[:, None, :], U_new, 0.0)
        s_new = torch.where(kmask, s_new, 0.0)

    return FDState(eigvecs=U_new.to(U.dtype), eigvals=s_new.to(s.dtype),
                   rho=(beta2 * rho + rho_t).to(rho.dtype))


def _fd_update_batched_quantized(U: QuantizedPool, s: torch.Tensor,
                                 rho: torch.Tensor, new_factor: torch.Tensor,
                                 beta2, active_k=None) -> FDState:
    """``fd_update_batched`` with the eigenvectors in int8 storage end to
    end (repro/core/fd.py :211).  The block scale and the ladder weights
    are both per column of the small factor, so they fold into one (N, ell)
    weight: ``B = dequant(Vq) sqrt(beta2 s) = Vq diag(colw)``, ``colw =
    scale * sqrt(beta2 s)``.  The refreshed eigenvectors come back
    requantized, rounded to nearest.  A rank mask zeroes the inactive
    columns' weights before the Gram and W's inactive output columns
    before the write-back; the kernels are the unmasked ones."""
    vq, scale = U                            # (N, d, ell) int8, (N, 1, 1)
    N, d, ell = vq.shape
    if new_factor.ndim == 2:
        new_factor = new_factor[..., None]
    A = new_factor.float().contiguous()      # (N, d, r)

    s_clamped = torch.clamp(beta2 * s.float(), min=0.0)
    kmask = _rank_mask(active_k, ell)
    if kmask is not None:
        # zero weights zero the inactive columns of B, whatever the int8
        # values hold there
        s_clamped = torch.where(kmask, s_clamped, 0.0)
    colw = scale.reshape(N, 1) * torch.sqrt(s_clamped)   # (N, ell)

    lam_top, V, inv_sqrt = _top_eigenpairs(
        KERNELS.batched_gram_mixed(vq, colw, A), ell)
    rho_t = _escaped_eigval(lam_top, active_k, ell)
    # U_new = M @ W with M = [Vq diag(colw), A]: split W by row block and
    # fold the column weights into the top half, so the projection reads
    # the raw int8 values (row-major copies: the kernel reads them so, and
    # eigh on the card returns V column-major)
    W = V[..., :ell] * inv_sqrt[:, None, :]       # (N, ell + r, ell)
    if kmask is not None:
        # zero output columns stay zero through the in-kernel quantization
        W = torch.where(kmask[:, None, :], W, 0.0)
    w_top = (colw[..., None] * W[..., :ell, :]).contiguous()   # (N, ell, ell)
    w_bot = W[..., ell:, :].contiguous()          # (N, r, ell)
    values, scale_new = KERNELS.batched_project_quantize(vq, w_top, A, w_bot)

    s_new = lam_top - rho_t[..., None]            # deflate: last entry 0
    if kmask is not None:
        s_new = torch.where(kmask, s_new, 0.0)
    return FDState(eigvecs=QuantizedPool(values=values, scale=scale_new),
                   eigvals=s_new.to(s.dtype),
                   rho=(beta2 * rho + rho_t).to(rho.dtype))


def _rank_mask(active_k: Optional[torch.Tensor], ell: int
               ) -> Optional[torch.Tensor]:
    """(N, ell) bool mask of the active ladder columns, or None unmasked."""
    if active_k is None:
        return None
    kk = torch.clamp(active_k, 1, ell)
    return torch.arange(ell, device=kk.device)[None, :] < kk[:, None]


def _escaped_eigval(lam_top: torch.Tensor, active_k: Optional[torch.Tensor],
                    ell: int) -> torch.Tensor:
    """Per-block deflation eigenvalue (N,): ``lam[k - 1]`` at the active
    rank, ``lam[ell - 1]`` unmasked."""
    if active_k is None:
        return lam_top[..., ell - 1]
    kk = torch.clamp(active_k, 1, ell).long()
    return torch.gather(lam_top, -1, kk[:, None] - 1)[..., 0]


def _top_eigenpairs(C: torch.Tensor, ell: int) -> tuple:
    """Of the symmetrized Gram stack C: the top ``ell`` eigenvalues
    descending (negatives clipped), all eigenvectors in descending order,
    and ``lam^-1/2`` of the top ``ell`` (0 where lam <= 1e-30)."""
    lam, V = _eigh(0.5 * (C + C.mT))              # ascending, batched
    lam = torch.clamp(lam.flip(-1), min=0.0)      # descending, clip negatives
    lam_top = lam[..., :ell]
    inv_sqrt = torch.where(lam_top > 1e-30,
                           torch.rsqrt(torch.clamp(lam_top, min=1e-30)), 0.0)
    return lam_top, V.flip(-1), inv_sqrt


def fd_resize_batched(state: FDState, new_k: torch.Tensor) -> FDState:
    """Move each block of a stack to a new active rank (N,); the shapes
    (the capacity) never change.  Shrinking block b to ``new_k[b]`` folds
    the dropped eigenvalues into ``rho`` exactly (``rho += sum_{i >= k}
    s_i``, which keeps the block's FD bound) and zeroes the dropped ladder
    and eigenvector columns; growing is free, as the columns past the old
    rank are zero already.  An int8 ``QuantizedPool`` stack has its values
    zeroed in place of the mask, each block's scale kept."""
    U, s, rho = state
    quantized = isinstance(U, QuantizedPool)
    ell = (U.values if quantized else U).shape[-1]
    kmask = _rank_mask(new_k, ell)                         # (N, ell)
    s_f = s.float()
    dropped = torch.sum(torch.where(kmask, 0.0, s_f), dim=-1)   # (N,)
    s_new = torch.where(kmask, s_f, 0.0).to(s.dtype)
    rho_new = (rho.float() + dropped).to(rho.dtype)
    if quantized:
        U_new = QuantizedPool(
            values=torch.where(kmask[:, None, :], U.values,
                               torch.zeros((), dtype=torch.int8,
                                           device=U.values.device)),
            scale=U.scale)
    else:
        U_new = torch.where(kmask[:, None, :], U, 0.0).to(U.dtype)
    return FDState(eigvecs=U_new, eigvals=s_new, rho=rho_new)


def _eigh(C: torch.Tensor):
    """``torch.linalg.eigh``.  On the CPU it runs with denormals flushed to
    zero, as XLA's CPU runtime runs the reference: MKL's ssyevd otherwise
    fails to converge on the Grams of blocks with tiny gradients."""
    if C.device.type != "cpu":
        return torch.linalg.eigh(C)
    torch.set_flush_denormal(True)
    try:
        return torch.linalg.eigh(C)
    finally:
        torch.set_flush_denormal(False)


def fd_pressure(state: FDState) -> torch.Tensor:
    """Escaped-mass ratio ``rho / (trace + rho)`` in [0, 1]: near 0 the
    leading-``ell`` subspace holds the stream, near 1 the mass escapes past
    the sketch rank.  A stack gives one ratio per block."""
    trace = torch.sum(state.eigvals.float(), dim=-1)
    rho = state.rho.float()
    return rho / torch.clamp(trace + rho, min=1e-30)


def fd_leading_eigval(state: FDState, *, compensated: bool = True
                      ) -> torch.Tensor:
    """Top eigenvalue of the sketched covariance: ``s[0] + rho`` (the
    rho-compensated estimate the preconditioner applies), or the raw ladder
    top ``s[0]`` without ``compensated``."""
    top = state.eigvals[..., 0].float()
    if compensated:
        top = top + state.rho.float()
    return top


def fd_subspace_angle(a, b, k: Optional[int] = None) -> torch.Tensor:
    """Largest principal angle (radians) between the leading-``k`` sketch
    subspaces of ``a`` and ``b`` (FDState or (d, ell) eigenvector
    tensors): ``arccos(sigma_min(Ua^T Ub))``, 0 when they coincide, pi/2
    when a direction of one is orthogonal to all of the other.  ``k``
    defaults to ``ell - 1`` (the deflated last column is zero)."""
    Ua = a.eigvecs if isinstance(a, FDState) else a
    Ub = b.eigvecs if isinstance(b, FDState) else b
    if k is None:
        k = max(Ua.shape[-1] - 1, 1)
    k = min(k, Ua.shape[-1], Ub.shape[-1])
    C = Ua[..., :k].float().mT @ Ub[..., :k].float()
    sv = torch.linalg.svdvals(C)
    return torch.arccos(torch.clamp(torch.min(sv, dim=-1).values, 0.0, 1.0))


def fd_covariance(state: FDState, include_rho: bool = False) -> torch.Tensor:
    """The sketched covariance ``U diag(s) U^T`` (+ ``rho I``) of an
    unbatched sketch, d x d (testing and analysis only)."""
    U, s, rho = state
    cov = (U * s[None, :]) @ U.T
    if include_rho:
        cov = cov + rho * torch.eye(U.shape[0], dtype=cov.dtype,
                                    device=cov.device)
    return cov


def fd_inverse_root_coeffs(state: FDState, *, exponent: float, eps: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(base, coeffs) with ``(U diag(s) U^T + (rho+eps) I)^exponent G =
    base G + U diag(coeffs) U^T G``: base ([N]), coeffs ([N,] ell).

    Moore-Penrose semantics (paper Alg. 2): with no diagonal mass,
    directions outside span(U) map to 0."""
    _, s, rho = state
    damp = rho + eps
    tol = 1e-10
    base = torch.where(damp > tol,
                       torch.pow(torch.clamp(damp, min=tol), exponent), 0.0)
    lam = s + damp[..., None]
    coeffs = torch.where(lam > tol,
                         torch.pow(torch.clamp(lam, min=tol), exponent),
                         0.0) - base[..., None]
    return base, coeffs


def fd_apply_inverse_root(state: FDState, G: torch.Tensor, *,
                          exponent: float, eps: float) -> torch.Tensor:
    """``(sketch + (rho+eps) I)^exponent @ G`` for an unbatched sketch,
    without forming d x d: G (d, n) -> (d, n), through
    ``KERNELS.lowrank_apply`` (which reads G row-major)."""
    base, coeffs = fd_inverse_root_coeffs(state, exponent=exponent, eps=eps)
    return KERNELS.lowrank_apply(state.eigvecs, coeffs, base, G.contiguous())


def fd_apply_inverse_root_batched(state: FDState, G: torch.Tensor, *,
                                  exponent: float, eps: float
                                  ) -> torch.Tensor:
    """``(sketch + (rho+eps) I)^exponent @ G[n]`` for every block, without
    forming d x d: G (N, d, n) -> (N, d, n).

    The kernel reads G row-major.  A strided G (Sketchy's right-side apply
    gets the transpose of the left side's output) is copied first: one
    read and one write of G, against the kernel's own read of G and U and
    write of the result.

    An int8 ``QuantizedPool`` eigenvector stack is applied as it is stored:
    the block scale commutes out of ``U diag(c) U^T`` as ``scale^2`` and is
    folded into the coefficients (repro/core/fd.py :515-519)."""
    base, coeffs = fd_inverse_root_coeffs(state, exponent=exponent, eps=eps)
    U = state.eigvecs
    if isinstance(U, QuantizedPool):
        return KERNELS.batched_lowrank_apply_quantized(
            U.values, U.scale, coeffs, base, G.contiguous())
    return KERNELS.batched_lowrank_apply(U, coeffs, base, G.contiguous())

