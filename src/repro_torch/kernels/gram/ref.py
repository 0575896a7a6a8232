"""Plain PyTorch version of the batched Gram (mirror of
repro/kernels/gram/ref.py): the CPU path of the registry and the reference
the CUDA kernel is held against on the card."""
import torch


def batched_gram_ref(a: torch.Tensor) -> torch.Tensor:
    """C[n] = A[n]^T A[n] for an (N, d, k) stack; f32 accumulation."""
    a32 = a.float()
    return torch.matmul(a32.mT, a32)
