"""The optimizer hot path's kernel set, dispatched on the tensor's device.

Port of repro/kernels/registry.py (``KernelSet`` :52) with the two entries
the Sketchy training step uses.  There is no backend choice: a CUDA tensor
launches the hand-written Hopper kernel (which raises if it cannot build or
launch), a CPU tensor takes the plain PyTorch version, and any other device
raises.  Nothing falls back from the kernel to the plain version.

    batched_gram(a):                      (N, d, k) -> (N, k, k) f32
    batched_lowrank_apply(u, c, b, g):    (N, d, ell), (N, ell), (N,),
                                          (N, d, n) -> (N, d, n), g's dtype
                                          (the card's kernel takes f32 only)
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import kernel as lowrank_kernel
from repro_torch.kernels.lowrank import ref as lowrank_ref


class KernelSet(NamedTuple):
    batched_gram: Callable
    batched_lowrank_apply: Callable


def _route(t: torch.Tensor, on_card: Callable, on_cpu: Callable) -> Callable:
    if t.device.type == "cuda":
        return on_card
    if t.device.type == "cpu":
        return on_cpu
    raise ValueError(f"no kernel for device {t.device}")


def batched_gram(a: torch.Tensor) -> torch.Tensor:
    return _route(a, gram_kernel.batched_gram, gram_ref.batched_gram_ref)(a)


def batched_lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor,
                          base: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    fn = _route(g, lowrank_kernel.batched_lowrank_apply,
                lowrank_ref.batched_lowrank_apply_ref)
    return fn(u, coeffs, base, g)


KERNELS = KernelSet(batched_gram=batched_gram,
                    batched_lowrank_apply=batched_lowrank_apply)
