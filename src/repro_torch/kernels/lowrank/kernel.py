"""Wrappers of the hand-written Hopper low-rank applies (csrc/lowrank.cu,
csrc/lowrank_tall.cu) and of the int8 FD write-back
(csrc/project_quantize.cu).

``batched_lowrank_apply`` replaces
repro/kernels/lowrank/kernel.py::batched_lowrank_apply_pallas,
``lowrank_apply`` (the apply of one tall factor, split over d) replaces
::lowrank_apply_pallas and ``batched_project_quantize`` replaces
::batched_project_quantize_pallas.
The wrappers take CUDA tensors only (the registry sends CPU tensors to
``ref.py``), check what the kernels accept, allocate the outputs and the
f32 scratch of the kernels' two passes, launch on the current stream and
raise on a launch error.  Each counts the calls that launched (one per call,
for both passes): ``launches`` the apply with an f32 U, ``int8_launches``
the apply with an int8 U (the fused int8 path), ``single_launches`` the
single-block apply, and ``project_quantize_launches`` the write-back.

G must be contiguous.  The right-side apply of Sketchy sees a transposed
view; its caller makes the copy (core/fd.py fd_apply_inverse_root_batched).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, split_d

U_DTYPES = {torch.float32: 0, torch.int8: 2}
G_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_BLOCKS = 65535      # the grid's z / y dimension
MAX_ELL = 1024          # the single-block expand pass holds P's tile in
                        # shared memory: ell * 8 f32
launches = 0
int8_launches = 0
single_launches = 0
project_quantize_launches = 0


def _check(name: str, tensors: dict, device) -> None:
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} kernel needs CUDA tensors on one "
                             f"device; {arg} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors; {arg} "
                             f"has strides {t.stride()}")


def batched_lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor,
                          base: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Y[n] = base[n] G[n] + U[n] diag(coeffs[n]) U[n]^T G[n] on the card.

    u (N, d, ell) is f32, or int8 for the fused int8 path (the registry's
    ``batched_lowrank_apply_quantized`` folds the block scale^2 into
    coeffs); coeffs (N, ell), base (N,) and g (N, d, n) are f32.  All are
    contiguous CUDA tensors on one device.  N = 0 returns an empty result
    unlaunched."""
    global launches, int8_launches
    _check("batched_lowrank_apply",
           {"u": u, "coeffs": coeffs, "base": base, "g": g}, g.device)
    if u.dtype not in U_DTYPES:
        raise TypeError(f"batched_lowrank_apply kernel takes a float32 or "
                        f"int8 u; u is {u.dtype}")
    for name, t in (("coeffs", coeffs), ("base", base), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"batched_lowrank_apply kernel takes float32 "
                            f"{name}; it is {t.dtype}")
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
    if N > MAX_BLOCKS:
        raise ValueError(f"batched_lowrank_apply kernel takes at most "
                         f"{MAX_BLOCKS} blocks, got {N}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    scratch = torch.empty((N, ell, m), dtype=torch.float32, device=g.device)
    err = build.launch(build.library("lowrank").repro_batched_lowrank_apply,
                       g.device, u.data_ptr(), U_DTYPES[u.dtype],
                       coeffs.data_ptr(), base.data_ptr(), g.data_ptr(),
                       scratch.data_ptr(), out.data_ptr(), N, d, ell, m)
    if err != 0:
        raise RuntimeError(f"batched_lowrank_apply kernel launch failed: CUDA "
                           f"error {err} at u {tuple(u.shape)} {u.dtype}, g "
                           f"{tuple(g.shape)}")
    if u.dtype == torch.int8:
        int8_launches += 1
    else:
        launches += 1
    return out


def lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor, base,
                  g: torch.Tensor) -> torch.Tensor:
    """Y = base G + U diag(coeffs) U^T G for one tall factor on the card:
    u (d, ell) and coeffs (ell,) f32, base an f32 scalar (a tensor on the
    card or a number), g (d, n) f32, bf16 or fp16 -> (d, n) in g's dtype.
    The projection is summed over slabs of d in a fixed order (the same
    bits on every run).  An empty result returns unlaunched."""
    global single_launches
    base = torch.as_tensor(base, dtype=torch.float32,
                           device=g.device).reshape(())
    _check("lowrank_apply", {"u": u, "coeffs": coeffs, "base": base, "g": g},
           g.device)
    if u.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError(f"lowrank_apply kernel takes float32 u and coeffs; "
                        f"got {u.dtype}, {coeffs.dtype}")
    if g.dtype not in G_DTYPES:
        raise TypeError(f"lowrank_apply kernel takes a float32, bfloat16 or "
                        f"float16 g; g is {g.dtype}")
    if u.ndim != 2 or g.ndim != 2:
        raise ValueError(f"u and g must be 2-D, got {tuple(u.shape)}, "
                         f"{tuple(g.shape)}")
    d, ell = u.shape
    n = g.shape[1]
    if g.shape[0] != d or coeffs.shape != (ell,):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, g {tuple(g.shape)}")
    if not 0 < ell <= MAX_ELL:
        raise ValueError(f"lowrank_apply kernel takes 0 < ell <= {MAX_ELL}, "
                         f"got {ell}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    # blocks per slab: the cross product's (n / 8) x (ell / 256) tiles
    slabs, slab_rows = split_d.slabs(
        d, math.ceil(n / 8) * math.ceil(ell / 256), ell * n)
    partial = torch.empty((slabs, ell, n), dtype=torch.float32,
                          device=g.device)
    p = torch.empty((ell, n), dtype=torch.float32, device=g.device)
    err = build.launch(build.library("lowrank_tall").repro_lowrank_tall,
                       g.device, u.data_ptr(), coeffs.data_ptr(),
                       base.data_ptr(), g.data_ptr(), G_DTYPES[g.dtype],
                       partial.data_ptr(), p.data_ptr(), out.data_ptr(), d,
                       ell, n, slabs, slab_rows)
    if err != 0:
        raise RuntimeError(f"lowrank_apply kernel launch failed: CUDA error "
                           f"{err} at u {tuple(u.shape)}, g {tuple(g.shape)} "
                           f"{g.dtype}")
    single_launches += 1
    return out


def batched_project_quantize(vq: torch.Tensor, w_top: torch.Tensor,
                             a: torch.Tensor, w_bot: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``U_new = f32(vq) @ w_top + a @ w_bot`` requantized per block, on the
    card: vq (N, d, k) int8, w_top (N, k, e), a (N, d, r), w_bot (N, r, e)
    f32, contiguous, on one device -> (values (N, d, e) int8, scale
    (N, 1, 1) f32), rounding to nearest as ``quantize.quantize_stack``.
    N = 0 returns empty results unlaunched."""
    global project_quantize_launches
    _check("batched_project_quantize",
           {"vq": vq, "w_top": w_top, "a": a, "w_bot": w_bot}, a.device)
    if vq.dtype != torch.int8 or any(
            t.dtype != torch.float32 for t in (w_top, a, w_bot)):
        raise TypeError(f"batched_project_quantize kernel takes int8 vq and "
                        f"float32 w_top, a, w_bot; got {vq.dtype}, "
                        f"{w_top.dtype}, {a.dtype}, {w_bot.dtype}")
    if vq.ndim != 3 or a.ndim != 3 or w_top.ndim != 3:
        raise ValueError(f"vq, a and w_top must be 3-D, got "
                         f"{tuple(vq.shape)}, {tuple(a.shape)}, "
                         f"{tuple(w_top.shape)}")
    N, d, k = vq.shape
    r, e = a.shape[2], w_top.shape[2]
    if w_top.shape != (N, k, e) or a.shape[:2] != (N, d) \
            or w_bot.shape != (N, r, e):
        raise ValueError(f"shape mismatch: vq {tuple(vq.shape)}, w_top "
                         f"{tuple(w_top.shape)}, a {tuple(a.shape)}, w_bot "
                         f"{tuple(w_bot.shape)}")
    if N > MAX_BLOCKS:
        raise ValueError(f"batched_project_quantize kernel takes at most "
                         f"{MAX_BLOCKS} blocks, got {N}")
    values = torch.empty((N, d, e), dtype=torch.int8, device=a.device)
    scale = torch.ones((N, 1, 1), dtype=torch.float32, device=a.device)
    if values.numel() == 0:
        return values, scale
    scratch = torch.empty((N, d, e), dtype=torch.float32, device=a.device)
    absmax = torch.zeros((N,), dtype=torch.int32, device=a.device)
    err = build.launch(
        build.library("project_quantize").repro_batched_project_quantize,
        a.device, vq.data_ptr(), w_top.data_ptr(), a.data_ptr(),
        w_bot.data_ptr(), scratch.data_ptr(), absmax.data_ptr(),
        values.data_ptr(), scale.data_ptr(), N, d, k, r, e)
    if err != 0:
        raise RuntimeError(f"batched_project_quantize kernel launch failed: "
                           f"CUDA error {err} at vq {tuple(vq.shape)}, a "
                           f"{tuple(a.shape)}, e {e}")
    project_quantize_launches += 1
    return values, scale
