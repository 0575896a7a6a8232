"""Public wrappers of the Gram kernels (port of
repro/kernels/gram/ops.py).

Each goes through the kernel registry (kernels/registry.py), which
dispatches on the tensor's device: a CUDA tensor launches the hand-written
kernel (csrc/gram_tall.cu, csrc/gram.cu), a CPU tensor takes the plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, registry


def gram(a: torch.Tensor) -> torch.Tensor:
    """C = A^T A of one tall (d, k) matrix, f32."""
    return registry.gram(a)


def batched_gram(a: torch.Tensor, *,
                 config: Optional[autotune.TileConfig] = None
                 ) -> torch.Tensor:
    """C[n] = A[n]^T A[n] over a (N, d, k) pool stack.  The kernel's tiles
    are fixed (128 x 128), so ``config`` has nothing to pin."""
    return registry.batched_gram(a, config=config)


def batched_gram_mixed(vq: torch.Tensor, colw: torch.Tensor, a: torch.Tensor,
                       *, config: Optional[autotune.TileConfig] = None
                       ) -> torch.Tensor:
    """Gram of ``[f32(vq) * colw, A]``, the int8 stack upcast in registers;
    see kernels/gram/kernel.py."""
    return registry.batched_gram_mixed(vq, colw, a, config=config)
