"""Wrapper of the hand-written Hopper Gram kernel (csrc/gram.cu).

Replaces repro/kernels/gram/kernel.py::batched_gram_pallas.  The wrapper
takes CUDA tensors only (the registry sends CPU tensors to ``ref.py``),
checks what the kernel accepts, allocates the output, launches on the
current stream and raises on a launch error.  ``launches`` counts the
launches, so a run can show that its Grams went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
launches = 0


def batched_gram(a: torch.Tensor) -> torch.Tensor:
    """C[n] = A[n]^T A[n] for a contiguous CUDA (N, d, k) f32/bf16 stack;
    the result is (N, k, k) f32.  N = 0 returns an empty result unlaunched."""
    global launches
    if a.device.type != "cuda":
        raise ValueError(f"batched_gram kernel needs a CUDA tensor, got "
                         f"{a.device}")
    if a.dtype not in DTYPES:
        raise TypeError(f"batched_gram kernel takes float32 or bfloat16, got "
                        f"{a.dtype}")
    if a.ndim != 3 or not a.is_contiguous():
        raise ValueError(f"batched_gram kernel needs a contiguous (N, d, k) "
                         f"stack, got shape {tuple(a.shape)} strides "
                         f"{a.stride()}")
    N, d, k = a.shape
    if N > 65535:
        raise ValueError(f"batched_gram kernel takes at most 65535 blocks, "
                         f"got {N}")
    out = torch.empty((N, k, k), dtype=torch.float32, device=a.device)
    if N == 0 or k == 0:
        return out
    fn = build.library("gram").repro_batched_gram
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), out.data_ptr(), N, d, k, DTYPES[a.dtype],
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"batched_gram kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(a.shape)}")
    launches += 1
    return out
