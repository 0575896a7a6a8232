"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips on a host without
one; the file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: f32 ``atol = 1e-4 * sqrt(d)``,
``rtol = 1e-5``; bf16 inputs (Gram only) 10x that.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import ref as lowrank_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(d: int, dtype: str) -> dict:
    scale = 1 if dtype == "float32" else 10
    return dict(atol=1e-4 * np.sqrt(d) * scale, rtol=1e-5 * scale)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,k", [(1, 16, 4), (3, 20, 6), (5, 100, 30),
                                   (7, 33, 9), (2, 12, 780), (2, 768, 76),
                                   (48, 768, 832)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gram_kernel_matches_plain_on_card(card, N, d, k, dtype):
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(d)
    a = torch.randn(N, d, k, generator=gen, device=card).to(DTYPES[dtype])
    before = kernel.launches
    got = kernel.batched_gram(a)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, gram_ref.batched_gram_ref(a),
                               **_tol(d, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,ell,n", [(1, 32, 4, 8), (3, 24, 6, 10),
                                       (7, 123, 17, 50), (2, 12, 12, 768),
                                       (2, 768, 64, 12), (48, 768, 64, 768)])
def test_lowrank_kernel_matches_plain_on_card(card, N, d, ell, n):
    """f32, the one dtype the apply kernel takes."""
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(d)
    u = torch.randn(N, d, ell, generator=gen, device=card)
    g = torch.randn(N, d, n, generator=gen, device=card)
    coeffs = torch.rand(N, ell, generator=gen, device=card)
    base = torch.rand(N, generator=gen, device=card)
    before = kernel.launches
    got = kernel.batched_lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(
        got, lowrank_ref.batched_lowrank_apply_ref(u, coeffs, base, g),
        **_tol(d, "float32"))


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(card):
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.lowrank import kernel as lowrank_kernel
    a = torch.zeros(2, 8, 4, device=card)
    with pytest.raises(TypeError):
        gram_kernel.batched_gram(a.half())
    with pytest.raises(ValueError, match="contiguous"):
        gram_kernel.batched_gram(a.mT)
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernel.batched_gram(a.cpu())
    u, g = torch.zeros(2, 8, 3, device=card), torch.zeros(2, 8, 5, device=card)
    c, b = torch.zeros(2, 3, device=card), torch.zeros(2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lowrank_kernel.batched_lowrank_apply(u, c, b, g.mT.contiguous().mT)
    with pytest.raises(TypeError, match="float32"):
        lowrank_kernel.batched_lowrank_apply(u.bfloat16(), c, b,
                                             g.bfloat16())
