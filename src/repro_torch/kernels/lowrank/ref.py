"""Plain PyTorch versions of the batched low-rank apply and of the int8 FD
write-back (mirror of repro/kernels/lowrank/ref.py): the CPU path of the
registry and the references the CUDA kernels are held against on the
card."""
import torch

from repro_torch.core import quantize


def lowrank_apply_ref(u: torch.Tensor, coeffs: torch.Tensor, base,
                      g: torch.Tensor) -> torch.Tensor:
    """Y = base G + U diag(coeffs) U^T G for one block: u (d, ell), coeffs
    (ell,), base a scalar, g (d, n) -> (d, n) in g's dtype.  Both products
    accumulate in f32, as the kernel does (float64 inputs stay float64: the
    card holds the kernel against that)."""
    dt = torch.promote_types(torch.promote_types(u.dtype, g.dtype),
                             torch.float32)
    u32, g32 = u.to(dt), g.to(dt)
    proj = u32.T @ g32
    out = base * g32 + u32 @ (coeffs.to(dt)[:, None] * proj)
    return out.to(g.dtype)


def batched_lowrank_apply_ref(u: torch.Tensor, coeffs: torch.Tensor,
                              base: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Y[n] = base[n] G[n] + U[n] diag(coeffs[n]) U[n]^T G[n].

    u (N, d, ell) f32 or int8, coeffs (N, ell), base (N,), g (N, d, n) ->
    (N, d, n) in g's dtype; both products accumulate in f32, as the kernel
    does."""
    u32, g32 = u.float(), g.float()
    proj = torch.matmul(u32.mT, g32)
    expand = torch.matmul(u32, coeffs.float()[:, :, None] * proj)
    return (base.float()[:, None, None] * g32 + expand).to(g.dtype)


def batched_lowrank_apply_quantized_ref(values: torch.Tensor,
                                        scale: torch.Tensor,
                                        coeffs: torch.Tensor,
                                        base: torch.Tensor,
                                        g: torch.Tensor) -> torch.Tensor:
    """The apply with an int8 factor: the block scale commutes out of
    ``U diag(c) U^T`` as ``scale^2`` and is folded into the coefficients,
    so the apply runs on the raw int8 values.  values (N, d, ell) int8,
    scale (N, 1, 1) f32."""
    s2 = torch.square(scale.reshape(scale.shape[0], 1).float())
    return batched_lowrank_apply_ref(values, coeffs * s2, base, g)


def batched_project_quantize_ref(vq: torch.Tensor, w_top: torch.Tensor,
                                 a: torch.Tensor, w_bot: torch.Tensor
                                 ) -> tuple:
    """The int8 FD write-back: ``U_new = f32(vq) @ w_top + a @ w_bot``
    requantized per block, rounding to nearest (``quantize_stack`` with no
    key).  vq (N, d, k) int8, w_top (N, k, e), a (N, d, r), w_bot (N, r, e)
    f32 -> (values (N, d, e) int8, scale (N, 1, 1) f32)."""
    un = torch.matmul(vq.float(), w_top) + torch.matmul(a.float(), w_bot)
    qp = quantize.quantize_stack(un)
    return qp.values, qp.scale


def project_quantize_differences(got: tuple, vq: torch.Tensor,
                                 w_top: torch.Tensor, a: torch.Tensor,
                                 w_bot: torch.Tensor) -> int:
    """How many int8 values of ``got = (values, scale)``, a result of the
    card's write-back kernel on these inputs, differ from the plain
    version's; raises ``AssertionError`` where the difference is more than
    summation order explains.  The kernel sums the k + r products of U_new
    in another order, so its scale may differ by ``rtol = 1e-5`` and a value
    by 1, only where the plain ``U_new / scale`` lies within 1e-3 of a step
    of a .5 boundary (a few hundred ulp at the int8 range's top, 127)."""
    values, scale = got
    un = torch.matmul(vq.float(), w_top) + torch.matmul(a.float(), w_bot)
    want_values, want_scale = quantize.quantize_stack(un)
    if not torch.allclose(scale, want_scale, rtol=1e-5, atol=0.0):
        raise AssertionError(
            f"write-back scales differ by up to "
            f"{float((scale / want_scale - 1).abs().max()):.3e} relative")
    diff = (values.int() - want_values.int()).abs()
    t = un / want_scale
    near_half = (t - (torch.floor(t) + 0.5)).abs() <= 1e-3
    if bool((diff > 1).any()) or bool((diff > 0)[~near_half].any()):
        raise AssertionError(
            f"write-back values differ by up to {int(diff.max())}, "
            f"{int((diff > 0).sum())} of {diff.numel()} entries, not all "
            f"at a .5 boundary")
    return int((diff > 0).sum())
