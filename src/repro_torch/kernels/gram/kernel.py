"""Wrappers of the hand-written Hopper Gram kernels (csrc/gram.cu,
csrc/gram_tall.cu).

``batched_gram`` replaces repro/kernels/gram/kernel.py::batched_gram_pallas,
``batched_gram_mixed`` replaces ::batched_gram_mixed_pallas and ``gram``
(the single-block Gram of one tall matrix, split over d) replaces
::gram_pallas.  The wrappers take CUDA tensors only (the registry sends CPU
tensors to ``ref.py``), check what the kernel accepts, allocate the output
and the kernel's scratch, launch on the current stream and raise on a
launch error.  ``launches``, ``mixed_launches`` and ``single_launches``
count each wrapper's launches, so a run can show that its Grams went
through the kernels; ``launches_by_dtype`` splits ``launches`` by the
operand's dtype.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, split_d

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SINGLE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_GRID_X = 2**31 - 1  # a grid's x dimension, which takes every block
TILE = 128              # csrc/gram.cu kTile: output tiles of 128 x 128
ROWS_MAX_K = 16         # csrc/gram_tall.cu kRowsMaxK: whole rows per thread
launches = 0
launches_by_dtype: dict = {}   # batched_gram's, by a's dtype
mixed_launches = 0
single_launches = 0


def _check_stack(name: str, t: torch.Tensor, device) -> None:
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{t.device}")
    if t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{name} needs a contiguous (N, d, k) stack, got "
                         f"shape {tuple(t.shape)} strides {t.stride()}")


def gram_grid(N: int, k: int) -> int:
    """The batched Grams' one-dimensional grid (csrc/gram.cu): the
    upper-triangular 128 x 128 tiles of each of the N outputs, (k / 128)
    (k / 128 + 1) / 2 of them, block n's after block n - 1's.  Raises
    where it would pass the grid's x limit."""
    tiles = math.ceil(k / TILE)
    blocks = N * tiles * (tiles + 1) // 2
    if blocks > MAX_GRID_X:
        raise ValueError(f"batched Gram kernel's grid of {blocks} blocks is "
                         f"over the card's {MAX_GRID_X} (N {N}, k {k})")
    return blocks


def batched_gram(a: torch.Tensor) -> torch.Tensor:
    """C[n] = A[n]^T A[n] for a contiguous CUDA (N, d, k) f32, bf16 or fp16
    stack (fp16 and bf16 are exact in tf32: one product); the result is
    (N, k, k) f32.  N = 0 returns an empty result unlaunched."""
    global launches
    if a.dtype not in DTYPES:
        raise TypeError(f"batched_gram kernel takes float32, bfloat16 or "
                        f"float16, got {a.dtype}")
    _check_stack("batched_gram kernel", a, a.device)
    N, d, k = a.shape
    gram_grid(N, k)
    out = torch.empty((N, k, k), dtype=torch.float32, device=a.device)
    if N == 0 or k == 0:
        return out
    err = build.launch(build.library("gram").repro_batched_gram, a.device,
                       a.data_ptr(), out.data_ptr(), N, d, k, DTYPES[a.dtype])
    if err != 0:
        raise RuntimeError(f"batched_gram kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(a.shape)}")
    launches += 1
    launches_by_dtype[a.dtype] = launches_by_dtype.get(a.dtype, 0) + 1
    return out


def batched_gram_mixed(vq: torch.Tensor, colw: torch.Tensor,
                       a: torch.Tensor) -> torch.Tensor:
    """Gram of ``[vq * colw, a]`` for contiguous CUDA tensors: vq (N, d, k)
    int8, colw (N, k) f32, a (N, d, r) f32 -> (N, k+r, k+r) f32.

    The kernel forms ``C0 = [V, A]^T [V, A]`` and applies the column weights
    ``C = C0 o w w^T``, ``w = [colw, 1]``, in its epilogue, in the
    reference's order.  N = 0 returns an empty result unlaunched."""
    global mixed_launches
    if vq.dtype != torch.int8 or a.dtype != torch.float32 \
            or colw.dtype != torch.float32:
        raise TypeError(f"batched_gram_mixed kernel takes int8 vq and float32 "
                        f"colw and a, got {vq.dtype}, {colw.dtype}, "
                        f"{a.dtype}")
    for name, t in (("vq", vq), ("a", a)):
        _check_stack(f"batched_gram_mixed kernel ({name})", t, a.device)
    N, d, k = vq.shape
    r = a.shape[2]
    if a.shape[:2] != (N, d) or colw.shape != (N, k) \
            or colw.device != a.device:
        raise ValueError(f"shape mismatch: vq {tuple(vq.shape)}, colw "
                         f"{tuple(colw.shape)}, a {tuple(a.shape)}")
    gram_grid(N, k + r)
    colw = colw.contiguous()
    out = torch.empty((N, k + r, k + r), dtype=torch.float32, device=a.device)
    if N == 0:
        return out
    err = build.launch(build.library("gram").repro_batched_gram_mixed,
                       a.device, vq.data_ptr(), a.data_ptr(), colw.data_ptr(),
                       out.data_ptr(), N, d, k, r)
    if err != 0:
        raise RuntimeError(f"batched_gram_mixed kernel launch failed: CUDA "
                           f"error {err} at vq {tuple(vq.shape)}, a "
                           f"{tuple(a.shape)}")
    mixed_launches += 1
    return out


def gram(a: torch.Tensor) -> torch.Tensor:
    """C = A^T A for a contiguous CUDA (d, k) f32, bf16 or fp16 matrix; the
    result is (k, k) f32, summed over slabs of d in a fixed order (the same
    bits on every run).  An empty A returns zeros unlaunched."""
    global single_launches
    if a.dtype not in SINGLE_DTYPES:
        raise TypeError(f"gram kernel takes float32, bfloat16 or float16, "
                        f"got {a.dtype}")
    if a.device.type != "cuda":
        raise ValueError(f"gram kernel needs a CUDA tensor, got {a.device}")
    if a.ndim != 2 or not a.is_contiguous():
        raise ValueError(f"gram kernel needs a contiguous (d, k) matrix, got "
                         f"shape {tuple(a.shape)} strides {a.stride()}")
    d, k = a.shape
    out = torch.zeros((k, k), dtype=torch.float32, device=a.device)
    if d == 0 or k == 0:
        return out
    # blocks per slab: one, or the cross product's (k / 8) x (k / 256) tiles
    tiles = 1 if k <= ROWS_MAX_K else math.ceil(k / 8) * math.ceil(k / 256)
    slabs, slab_rows = split_d.slabs(d, tiles, k * k)
    partial = torch.empty((slabs, k, k), dtype=torch.float32,
                          device=a.device)
    err = build.launch(build.library("gram_tall").repro_gram_tall, a.device,
                       a.data_ptr(), partial.data_ptr(), out.data_ptr(), d, k,
                       SINGLE_DTYPES[a.dtype], slabs, slab_rows)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err} at "
                           f"shape {tuple(a.shape)} {a.dtype}")
    single_launches += 1
    return out
