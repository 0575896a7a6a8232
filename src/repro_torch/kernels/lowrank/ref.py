"""Plain PyTorch version of the batched low-rank apply (mirror of
repro/kernels/lowrank/ref.py): the CPU path of the registry and the
reference the CUDA kernel is held against on the card."""
import torch


def batched_lowrank_apply_ref(u: torch.Tensor, coeffs: torch.Tensor,
                              base: torch.Tensor,
                              g: torch.Tensor) -> torch.Tensor:
    """Y[n] = base[n] G[n] + U[n] diag(coeffs[n]) U[n]^T G[n].

    u (N, d, ell), coeffs (N, ell), base (N,), g (N, d, n) -> (N, d, n) in
    g's dtype; both products accumulate in f32, as the kernel does."""
    u32, g32 = u.float(), g.float()
    proj = torch.matmul(u32.mT, g32)
    expand = torch.matmul(u32, coeffs.float()[:, :, None] * proj)
    return (base.float()[:, None, None] * g32 + expand).to(g.dtype)
