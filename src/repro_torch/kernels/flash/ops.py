"""Differentiable attention forward: the flash kernel (or, on the CPU, its
plain version) with a gradient.

The forward goes through the kernel set (kernels/registry.py): a CUDA
tensor launches csrc/flash.cu, a CPU tensor takes ``ref.attention_ref``.
The JAX package has no backward kernel (its models differentiate
``causal_attention`` with XLA), so none is ported: the backward recomputes
the plain version from the saved inputs under autograd and differentiates
that, the counterpart of XLA's autodiff.  The forward kernel is not a
fallback of anything: on a CUDA tensor it runs or raises.  Under
``torch.utils.checkpoint`` the recomputed forward launches the kernel
again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.flash import ref


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return registry.flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, grad):
        return (*registry.grad_of_plain(
            lambda *t: ref.attention_ref(*t, causal=ctx.causal),
            ctx.saved_tensors, ctx.needs_input_grad[:3], grad), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Hq, S, hd); k, v: (B, Hkv, Sk, hd) -> (B, Hq, S, hd)."""
    return _FlashAttention.apply(q, k, v, causal)
