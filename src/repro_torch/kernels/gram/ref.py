"""Plain PyTorch versions of the Grams (mirror of
repro/kernels/gram/ref.py): the CPU path of the registry and the references
the CUDA kernels are held against on the card."""
import torch


def gram_ref(a: torch.Tensor) -> torch.Tensor:
    """C = A^T A for a (d, k) matrix; f32 accumulation (float64 inputs stay
    float64: the card holds the kernel against that)."""
    a32 = a.to(torch.promote_types(a.dtype, torch.float32))
    return a32.T @ a32


def batched_gram_ref(a: torch.Tensor) -> torch.Tensor:
    """C[n] = A[n]^T A[n] for an (N, d, k) stack; f32 accumulation."""
    a32 = a.float()
    return torch.matmul(a32.mT, a32)


def batched_gram_mixed_ref(vq: torch.Tensor, colw: torch.Tensor,
                           a: torch.Tensor) -> torch.Tensor:
    """Gram of the mixed FD stack ``[vq * colw, a]``: vq (N, d, k) int8
    eigenvectors, colw (N, k) f32 column weights (block scale x
    sqrt(beta2 * s)), a (N, d, r) f32 new factors -> (N, k+r, k+r) f32.

    As the kernel computes it: the unweighted Gram of ``[V, A]`` first, the
    column weights applied to the small output."""
    N, r = vq.shape[0], a.shape[-1]
    m = torch.cat([vq.float(), a.float()], dim=2)
    c0 = torch.matmul(m.mT, m)
    w = torch.cat([colw.float(), torch.ones((N, r), dtype=torch.float32,
                                            device=colw.device)], dim=1)
    return c0 * w[:, :, None] * w[:, None, :]
