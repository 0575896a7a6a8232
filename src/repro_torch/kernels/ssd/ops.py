"""Differentiable SSD chunk scan: the kernel (or, on the CPU, its plain
version) with a gradient.

The forward goes through the kernel set (kernels/registry.py): a CUDA
tensor launches csrc/ssd.cu, a CPU tensor takes ``ref.ssd_ref``.  The JAX
package has no backward kernel (its models differentiate ``models/ssm.py``
``ssd`` with XLA), so none is ported: the backward recomputes the plain
version from the saved inputs under autograd and differentiates that, the
counterpart of XLA's autodiff.  The forward kernel is not a fallback of
anything: on a CUDA tensor it runs or raises.  Under
``torch.utils.checkpoint`` the recomputed forward launches the kernel
again.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.ssd import ref


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, u, dlog, Bm, Cm, chunk):
        ctx.save_for_backward(u, dlog, Bm, Cm)
        ctx.chunk = chunk
        return registry.ssd_scan(u, dlog, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, grad):
        return (*registry.grad_of_plain(
            lambda *t: ref.ssd_ref(*t, ctx.chunk), ctx.saved_tensors,
            ctx.needs_input_grad[:4], grad), None)


def ssd_scan(u: torch.Tensor, dlog: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """u: (B, S, H, P); dlog: (B, S, H) f32; Bm, Cm: (B, S, N) -> y like u,
    in chunks of ``min(chunk, S)`` positions."""
    return _SSDScan.apply(u, dlog, Bm, Cm, chunk)
