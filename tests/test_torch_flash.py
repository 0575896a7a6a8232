"""The port's attention against the reference's: the plain version
(``kernels/flash/ref.attention_ref``, the CPU route of the kernel set)
against repro/kernels/flash's ``attention_ref`` and ``flash_attention_pallas``
in interpret mode, over the reference's sweep (tests/test_kernels.py:196-213)
in f32 and bf16; the model's ``causal_attention`` (which now goes through
``kernels/flash/ops.flash_attention``) against the reference's; and the
attention gradient (the ``autograd.Function`` with the plain forward)
against ``jax.grad`` of ``attention_ref``.

Tolerances: the reference's own, ``atol = 2e-5`` in f32 and 0.05 in bf16
(bf16 inputs against the reference on their f32 upcast, as its sweep holds
the Pallas kernel); the model's attention and the gradients in f32
``rtol = 1e-5, atol = 1e-6`` (sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.kernels.flash.kernel import flash_attention_pallas
from repro.kernels.flash.ref import attention_ref as j_attention_ref
from repro.models import attention as jattention
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import registry as kernel_registry
from repro_torch.kernels.flash import ops, ref
from repro_torch.models import attention as tattention

SWEEP = [(1, 2, 2, 64, 16, True), (2, 4, 2, 96, 32, True),
         (1, 8, 1, 128, 64, True), (2, 2, 2, 80, 16, False)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, Hq, Hkv, S, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, h, S, hd)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_ref_matches_jax_and_pallas(B, Hq, Hkv, S, hd, causal,
                                              dtype):
    jdt, tdt = DTYPES[dtype]
    arrays = _inputs(B, Hq, Hkv, S, hd)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    got = ref.attention_ref(*_torch(arrays, tdt), causal=causal)
    routed = kernel_registry.flash_attention(*_torch(arrays, tdt),
                                             causal=causal)
    assert got.dtype == tdt and torch.equal(got, routed)
    want = j_attention_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                           jv.astype(jnp.float32), causal=causal)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, bq=32, bk=32)
    tol = 2e-5 if dtype == "float32" else 0.05
    for other in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(other, np.float32), atol=tol)


@pytest.mark.parametrize("S", [16, 40])
def test_causal_attention_matches_jax(S):
    """The model's full-sequence attention (B, S, H, hd), GQA, against the
    reference's q-chunked one (q_chunk 32: S = 40 takes two chunks)."""
    jcfg = jregistry.get_reduced("paper-lm-100m")
    tcfg = tregistry.get_reduced("paper-lm-100m")
    rng = np.random.default_rng(S)
    H, KV, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
    q, k, v = (rng.normal(size=(2, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    want = jattention.causal_attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), unroll=True)
    got = tattention.causal_attention(tcfg, torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v))
    assert got.shape == (2, S, H, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_gradient_matches_jax(causal):
    arrays = _inputs(2, 4, 2, 24, 16, seed=3)
    w = np.random.default_rng(4).normal(size=(2, 4, 24, 16)).astype(
        np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(
        j_attention_ref(q, k, v, causal=causal) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [t.requires_grad_(True) for t in _torch(arrays, torch.float32)]
    out = ops.flash_attention(*leaves, causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_flash_route_raises_off_cpu_and_cuda():
    q = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kernel_registry.flash_attention(q, q, q)
