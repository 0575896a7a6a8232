"""Wrapper of the hand-written Hopper low-rank apply (csrc/lowrank.cu).

Replaces repro/kernels/lowrank/kernel.py::batched_lowrank_apply_pallas.  The
wrapper takes CUDA tensors only (the registry sends CPU tensors to
``ref.py``), checks what the kernel accepts, allocates the output and the
f32 ``P = c o U^T G`` scratch of the kernel's two passes, launches on the
current stream and raises on a launch error.  ``launches`` counts the calls
that launched (one per call, for both passes).

G must be contiguous.  The right-side apply of Sketchy sees a transposed
view; its caller makes the copy (core/fd.py fd_apply_inverse_root_batched).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0


def batched_lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor,
                          base: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Y[n] = base[n] G[n] + U[n] diag(coeffs[n]) U[n]^T G[n] on the card.

    u (N, d, ell), coeffs (N, ell), base (N,) and g (N, d, n) are f32
    contiguous CUDA tensors on one device (Sketchy's sketches and packed
    gradients are f32; no caller needs another dtype).  N = 0 returns an
    empty result unlaunched."""
    global launches
    tensors = {"u": u, "coeffs": coeffs, "base": base, "g": g}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != g.device:
            raise ValueError(f"batched_lowrank_apply kernel needs CUDA "
                             f"tensors on one device; {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"batched_lowrank_apply kernel needs contiguous "
                             f"tensors; {name} has strides {t.stride()}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"batched_lowrank_apply kernel takes float32 "
                            f"only; {name} is {t.dtype}")
    if u.ndim != 3 or g.ndim != 3:
        raise ValueError(f"u and g must be 3-D, got {tuple(u.shape)}, "
                         f"{tuple(g.shape)}")
    N, d, ell = u.shape
    m = g.shape[2]
    if g.shape[:2] != (N, d) or coeffs.shape != (N, ell) \
            or base.shape != (N,):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, base {tuple(base.shape)}, "
                         f"g {tuple(g.shape)}")
    if N > 65535:
        raise ValueError(f"batched_lowrank_apply kernel takes at most 65535 "
                         f"blocks, got {N}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    scratch = torch.empty((N, ell, m), dtype=torch.float32, device=g.device)
    fn = build.library("lowrank").repro_batched_lowrank_apply
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(u.data_ptr(), coeffs.data_ptr(), base.data_ptr(),
                 g.data_ptr(), scratch.data_ptr(), out.data_ptr(), N, d, ell,
                 m, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"batched_lowrank_apply kernel launch failed: CUDA "
                           f"error {err} at u {tuple(u.shape)}, g "
                           f"{tuple(g.shape)}")
    launches += 1
    return out
