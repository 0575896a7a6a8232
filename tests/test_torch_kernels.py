"""The port's kernel entries against the JAX Pallas kernels.

On the CPU the port's entries are the plain PyTorch versions; they are held
against ``batched_gram_pallas`` / ``batched_lowrank_apply_pallas`` run in
interpret mode, over the ragged shapes of tests/test_kernels.py, in f32 and
bf16, with empty pools.  tests/test_torch_cuda.py holds the hand-written
Hopper kernels against the plain versions on the card.

Tolerances: f32 ``atol = 1e-4 * sqrt(d)``, ``rtol = 1e-5`` (the two sides
sum d products in different orders); bf16 inputs 10x that.  A bf16 output
(the low-rank apply keeps G's dtype) is also allowed one bf16 rounding step,
at most 2^-7 of the value: both sides compute in f32 and round once, and f32
results a few ulps apart can round to neighbouring bf16 values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.kernels.gram.kernel import batched_gram_pallas
from repro.kernels.lowrank.kernel import batched_lowrank_apply_pallas
from repro_torch.kernels import registry
from repro_torch.kernels.gram import ref as gram_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAM_CASES = [(1, 16, 4, 1), (3, 20, 6, 2), (5, 100, 30, 2), (7, 33, 9, 3),
              (4, 64, 16, 4)]
LOWRANK_CASES = [(1, 32, 4, 8, 1), (3, 24, 6, 10, 2), (5, 64, 16, 33, 3),
                 (7, 123, 17, 50, 4)]


def _both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _tol(d: int, dtype: str) -> dict:
    scale = 1 if dtype == "float32" else 10
    return dict(atol=1e-4 * np.sqrt(d) * scale, rtol=1e-5 * scale)


@pytest.mark.parametrize("N,d,k,bn_stack", GRAM_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_gram_matches_pallas(N, d, k, bn_stack, dtype):
    rng = np.random.default_rng(N * 1000 + d)
    a_j, a_t = _both(rng.normal(size=(N, d, k)).astype(np.float32), dtype)
    want = batched_gram_pallas(a_j, bk=16, bd=32, bn_stack=bn_stack)
    got = registry.batched_gram(a_t)
    assert got.dtype == torch.float32 and got.shape == (N, k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(d, dtype))


@pytest.mark.parametrize("N,d,ell,n,bn_stack", LOWRANK_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_lowrank_matches_pallas(N, d, ell, n, bn_stack, dtype):
    rng = np.random.default_rng(N * 1000 + d)
    u_j, u_t = _both(rng.normal(size=(N, d, ell)).astype(np.float32), dtype)
    g_j, g_t = _both(rng.normal(size=(N, d, n)).astype(np.float32), dtype)
    coeffs = rng.random((N, ell)).astype(np.float32)
    base = rng.random(N).astype(np.float32)
    want = batched_lowrank_apply_pallas(u_j, jnp.asarray(coeffs),
                                        jnp.asarray(base), g_j, bn=16,
                                        bn_stack=bn_stack)
    got = registry.batched_lowrank_apply(u_t, torch.from_numpy(coeffs),
                                         torch.from_numpy(base), g_t)
    assert got.dtype == g_t.dtype and got.shape == (N, d, n)
    tol = _tol(d, dtype)
    if dtype == "bfloat16":
        tol["rtol"] = max(tol["rtol"], 2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_empty_pool(dtype):
    """N = 0 gives empty results of the right shape, as in JAX."""
    _, tdt = DTYPES[dtype]
    c = registry.batched_gram(torch.zeros((0, 8, 5), dtype=tdt))
    assert c.shape == (0, 5, 5) and c.dtype == torch.float32
    assert c.shape == batched_gram_pallas(jnp.zeros((0, 8, 5))).shape
    y = registry.batched_lowrank_apply(
        torch.zeros((0, 8, 3), dtype=tdt), torch.zeros((0, 3)),
        torch.zeros((0,)), torch.zeros((0, 8, 4), dtype=tdt))
    assert y.shape == (0, 8, 4) and y.dtype == tdt


def test_registry_dispatches_on_device():
    """CPU tensors take the plain versions; a device with no kernel raises
    (nothing falls back)."""
    a = torch.randn(2, 6, 3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(registry.batched_gram(a),
                               gram_ref.batched_gram_ref(a), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        registry.batched_gram(a.to("meta"))
