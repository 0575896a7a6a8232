"""Frequent Directions sketches over packed pool stacks (port of
repro/core/fd.py, unquantized and unmasked).

A sketch of the PSD stream ``G_t = sum_s beta2^{t-s} A_s A_s^T`` is kept in
eigenpair form ``(U, s, rho)``: ``U (d, ell)`` orthonormal columns, ``s``
descending eigenvalues with ``s[-1] == 0`` after deflation, and ``rho`` the
escaped mass behind the ``rho * I`` compensation.  Each update
eigendecomposes the small (ell+r) x (ell+r) Gram of ``M = [sqrt(beta2) B, A]``
instead of anything d x d.  Every function here works on a whole pool
stack: leaves carry a leading pool dim N.

The Gram and the low-rank apply go through the device-dispatching kernel
set of kernels/registry.py: the Hopper kernels for CUDA tensors, the plain
versions for CPU tensors.  ``eigh`` is
``torch.linalg.eigh``, a library call in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.registry import KERNELS


class FDState(NamedTuple):
    eigvecs: torch.Tensor  # (N, d, ell) approximate top eigenvectors U
    eigvals: torch.Tensor  # (N, ell) deflated eigenvalues, descending
    rho: torch.Tensor      # (N,) accumulated escaped mass


def fd_init(d: int, ell: int, dtype=torch.float32, *, num_blocks: int = 1,
            device="cpu") -> FDState:
    """Zero sketch stack of ``num_blocks`` blocks of dim ``d``, rank
    ``min(ell, d)``."""
    ell = min(ell, d)
    return FDState(
        eigvecs=torch.zeros((num_blocks, d, ell), dtype=dtype, device=device),
        eigvals=torch.zeros((num_blocks, ell), dtype=dtype, device=device),
        rho=torch.zeros((num_blocks,), dtype=dtype, device=device))


def fd_update_batched(state: FDState, new_factor: torch.Tensor,
                      beta2=1.0) -> FDState:
    """One FD step on every block of the stack: the PSD increment of block
    n is ``new_factor[n] @ new_factor[n].T`` (new_factor (N, d, r))."""
    U, s, rho = state
    ell = U.shape[-1]
    if new_factor.ndim == 2:
        new_factor = new_factor[..., None]
    compute_dtype = torch.promote_types(U.dtype, torch.float32)

    # the ladder is non-negative by construction; the clamp only guards
    # sqrt(negative) -> NaN if stored state was perturbed below zero
    s_clamped = torch.clamp(beta2 * s.to(compute_dtype), min=0.0)
    B = U.to(compute_dtype) * torch.sqrt(s_clamped)[:, None, :]
    M = torch.cat([B, new_factor.to(compute_dtype)], dim=2)

    C = KERNELS.batched_gram(M)
    C = 0.5 * (C + C.mT)

    lam, V = _eigh(C)                             # ascending, batched
    lam = torch.clamp(lam.flip(-1), min=0.0)      # descending, clip negatives
    V = V.flip(-1)

    lam_top = lam[..., :ell]
    rho_t = lam_top[..., ell - 1]                 # escaped eigenvalue, (N,)
    inv_sqrt = torch.where(lam_top > 1e-30,
                           torch.rsqrt(torch.clamp(lam_top, min=1e-30)), 0.0)
    U_new = torch.matmul(M, V[..., :ell]) * inv_sqrt[:, None, :]
    s_new = lam_top - rho_t[..., None]            # deflate: last entry 0

    return FDState(eigvecs=U_new.to(U.dtype), eigvals=s_new.to(s.dtype),
                   rho=(beta2 * rho + rho_t).to(rho.dtype))


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


def fd_inverse_root_coeffs(state: FDState, *, exponent: float, eps: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(base, coeffs) with ``(U diag(s) U^T + (rho+eps) I)^exponent G =
    base G + U diag(coeffs) U^T G``: base (N,), coeffs (N, ell).

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


def fd_apply_inverse_root_batched(state: FDState, G: torch.Tensor, *,
                                  exponent: float, eps: float
                                  ) -> torch.Tensor:
    """``(sketch + (rho+eps) I)^exponent @ G[n]`` for every block, without
    forming d x d: G (N, d, n) -> (N, d, n).

    The kernel reads G row-major.  A strided G (Sketchy's right-side apply
    gets the transpose of the left side's output) is copied first: one
    read and one write of G, against the kernel's own read of G and U and
    write of the result."""
    base, coeffs = fd_inverse_root_coeffs(state, exponent=exponent, eps=eps)
    return KERNELS.batched_lowrank_apply(state.eigvecs, coeffs, base,
                                         G.contiguous())

