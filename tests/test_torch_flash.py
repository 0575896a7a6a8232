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

The card kernel's launch arithmetic (``kernel.plan``, ``check_aligned``)
is plain Python and is checked here too: which kernel each dtype takes,
that every head dim fits the block's shared memory and that the grid
covers every query tile, and the bf16 kernel's alignment rule.
"""
import types

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
from repro_torch.kernels.flash import kernel as fkernel
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
    """A device with no kernel raises; a meta tensor (the dry run's shapes)
    takes the plain version's."""
    q = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel for device"):
        kernel_registry.flash_attention(q, q, q)
    m = torch.zeros(1, 2, 4, 16, device="meta")
    got = kernel_registry.flash_attention(m, m, m)
    assert (got.device.type, got.shape) == ("meta", m.shape)


# (B, Hq, S): the main paths' shapes, S 4096, rows that fill no tile, B * Hq
# over 132, and S on each side of the one-warpgroup block (64)
PLAN_SHAPES = [(8, 12, 128), (4, 32, 16), (1, 32, 4096), (2, 6, 130),
               (5, 32, 100), (1, 2, 64), (1, 2, 65), (3, 1, 1)]


@pytest.mark.parametrize("hd", fkernel.HEAD_DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_plan_fits_and_covers(hd, dtype):
    tdt = DTYPES[dtype][1]
    for B, Hq, S in PLAN_SHAPES:
        p = fkernel.plan(tdt, B, Hq, S, hd)
        assert p.smem_bytes <= fkernel.SMEM_LIMIT
        if tdt == torch.float32:
            assert (p.kernel, p.block_m, p.threads) == ("simt_f32", 64, 256)
            tiles, heads, batch = p.grid
            assert (heads, batch) == (Hq, B)
        else:
            assert p.kernel == "wgmma_bf16"
            two_per_sm = B * Hq * -(-S // 128) >= 2 * fkernel.SMS
            # at hd 256 one block a SM fits anyway: two warpgroups in it
            wide = hd > 128 and S > 64
            assert p.block_m == (128 if two_per_sm or wide else 64)
            assert p.threads == 128 * (p.block_m // 64)   # a warpgroup a 64
            bh, tiles, one = p.grid
            assert (bh, one) == (B * Hq, 1)
        # every query row in exactly one tile
        assert (tiles - 1) * p.block_m < S <= tiles * p.block_m


def test_flash_plan_raises_on_what_no_kernel_takes():
    with pytest.raises(TypeError):
        fkernel.plan(torch.float16, 1, 2, 64, 64)
    with pytest.raises(ValueError, match="grid"):
        fkernel.plan(torch.float32, 70_000, 2, 64, 64)
    with pytest.raises(ValueError, match="grid"):
        fkernel.plan(torch.bfloat16, 1, 2, 128 * 65_536, 64)
    assert fkernel.plan(torch.bfloat16, 70_000, 2, 64, 64).grid[0] == 140_000


def test_flash_alignment_rule():
    """Base and batch, sequence and head strides of a bf16 operand must be
    multiples of 16 bytes; the model's transposed (B, S, H, hd) views are."""
    def check(name, t):
        fkernel.check_aligned(name, t, t.stride())
    x = torch.zeros(2, 16, 4, 64, dtype=torch.bfloat16)
    check("q", x.transpose(1, 2))
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16)
    check("q", flat[8:].view(2, 16, 4, 64).transpose(1, 2))
    with pytest.raises(ValueError, match="aligned"):
        check("q", flat[1:1 + x.numel()].view(2, 16, 4, 64).transpose(1, 2))
    wide = torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        check("k", wide[..., :64].transpose(1, 2))
    check("k", torch.zeros(2, 16, 4, 72, dtype=torch.bfloat16)
          [..., :64].transpose(1, 2))
