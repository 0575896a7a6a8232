"""Public wrappers of the low-rank preconditioner applies and the int8 FD
write-back (port of repro/kernels/lowrank/ops.py).

Each goes through the kernel registry (kernels/registry.py), which
dispatches on the tensor's device: a CUDA tensor launches the hand-written
kernel (csrc/lowrank_tall.cu, csrc/lowrank.cu, csrc/project_quantize.cu),
a CPU tensor takes the plain version.  ``config`` (kernels/autotune.py)
pins the batched apply's column tile or the write-back's block count on
the card; omitted, the tune cache's config for the shape is used.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, registry


def lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor, base,
                  g: torch.Tensor) -> torch.Tensor:
    return registry.lowrank_apply(u, coeffs, base, g)


def batched_lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor,
                          base: torch.Tensor, g: torch.Tensor, *,
                          config: Optional[autotune.TileConfig] = None
                          ) -> torch.Tensor:
    """Pool-stack apply (leading N on every operand)."""
    return registry.batched_lowrank_apply(u, coeffs, base, g, config=config)


def batched_lowrank_apply_quantized(values: torch.Tensor, scale: torch.Tensor,
                                    coeffs: torch.Tensor, base: torch.Tensor,
                                    g: torch.Tensor, *,
                                    config: Optional[autotune.TileConfig]
                                    = None) -> torch.Tensor:
    """Quantized-storage apply: int8 values and their per-block scale
    consumed directly (scale^2 folded into coeffs); see
    kernels/registry.py."""
    return registry.batched_lowrank_apply_quantized(
        values, scale, coeffs, base, g, config=config)


def batched_project_quantize(vq: torch.Tensor, w_top: torch.Tensor,
                             a: torch.Tensor, w_bot: torch.Tensor, *,
                             config: Optional[autotune.TileConfig] = None):
    """Fused FD write-back -> (values int8, scale f32); see
    kernels/lowrank/kernel.py."""
    return registry.batched_project_quantize(vq, w_top, a, w_bot,
                                             config=config)
