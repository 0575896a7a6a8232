"""The port's Mamba2 / SSD against repro/models/ssm.py and
repro/kernels/ssd: the plain chunked scan (``kernels/ssd/ref.ssd_ref``, the
CPU route of the kernel set) against the reference's ``ssm.ssd`` and
``ssd_pallas`` in interpret mode over the reference's sweep
(tests/test_kernels.py:215-230) in f32 and bf16; ``models/ssm.ssd`` with a
ragged S; ``mamba_block`` and ``mamba_decode`` on the reference's weights;
and the scan's gradient (the ``autograd.Function`` with the plain forward)
against ``jax.grad`` of ``ssm.ssd``.

The card's scan (csrc/ssd.cu) runs in three phases: each chunk's state,
the states passed on in chunk order, each chunk's outputs.  A copy of that
algorithm written in this file (``_three_phases``, not the package's code)
is held against ``ssd_ref``, the reference's ``ssm.ssd`` and ``ssd_pallas``
over the reference's sweep and a ragged S, and with the bf16 rounding the
card applies to the decayed scores, the carried state and the decayed u,
against ``ssd_ref`` at the main head and state widths.

Tolerances: the scan as the reference's sweep, ``atol = 5e-6 * S`` in f32
and 0.15 in bf16 (bf16 inputs against the reference on their f32 upcast),
and in bf16 also a relative error of the whole output of 1e-2
(chip_smoke.py's MODEL_RTOL); the mixer, decode and gradients in f32
``rtol = 1e-4, atol = 1e-5`` (sums in another order, through exp and the
gate's rms norm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.kernels.ssd.kernel import ssd_pallas
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import registry as kernel_registry
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import ssm as tssm

SWEEP = [(1, 32, 4, 16, 16, 8, 4), (2, 64, 8, 16, 32, 16, 4),
         (1, 48, 6, 32, 64, 16, 2)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, S, H, P, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32) * 0.5,
            -np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.1,
            rng.normal(size=(B, S, N)).astype(np.float32) * 0.3,
            rng.normal(size=(B, S, N)).astype(np.float32) * 0.3)


@pytest.mark.parametrize("B,S,H,P,N,chunk,ht", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_ref_matches_jax_and_pallas(B, S, H, P, N, chunk, ht, dtype):
    jdt, tdt = DTYPES[dtype]
    u, dlog, Bm, Cm = _inputs(B, S, H, P, N)
    ju, jB, jC = (jnp.asarray(a, jdt) for a in (u, Bm, Cm))
    jd = jnp.asarray(dlog)
    tu, tB, tC = (torch.from_numpy(a).to(tdt) for a in (u, Bm, Cm))
    td = torch.from_numpy(dlog)
    got = ref.ssd_ref(tu, td, tB, tC, chunk)
    assert got.dtype == tdt
    assert torch.equal(got, kernel_registry.ssd_scan(tu, td, tB, tC, chunk))
    want = jssm.ssd(ju.astype(jnp.float32), jd, jB.astype(jnp.float32),
                    jC.astype(jnp.float32), chunk, unroll=True)
    pallas = ssd_pallas(ju, jd, jB, jC, chunk=chunk, head_tile=ht)
    tol = 5e-6 * S if dtype == "float32" else 0.15
    for other in (want, pallas):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(other, np.float32), atol=tol)


def _three_phases(u, dlog, Bm, Cm, chunk, rnd=lambda x: x):
    """The SSD scan as csrc/ssd.cu computes it, in f32 torch: (1) each chunk
    but the last, the state it adds, dS_c = sum_s exp(A_end - A_s) u_s
    B_s^T, and its decay exp(A_end); (2) in chunk order, S_{c+1} =
    exp(A_end,c) S_c + dS_c; (3) each chunk's intra term over s <= q, and
    after the first chunk the inter term exp(A_q) C_q S_c^T.  ``rnd`` is
    applied where the card rounds to bf16: the decayed u, the decayed
    scores and the carried state."""
    u, dlog, Bm, Cm = (t.float() for t in (u, dlog, Bm, Cm))
    S = u.shape[1]
    Q = min(chunk, S)
    starts = list(range(0, S, Q))
    states, keep = [], []
    for c0 in starts[:-1]:                                   # phase 1
        A = torch.cumsum(dlog[:, c0:c0 + Q], dim=1)
        du = rnd(u[:, c0:c0 + Q] * torch.exp(A[:, -1:] - A)[..., None])
        states.append(torch.einsum("bqhp,bqn->bhpn", du, Bm[:, c0:c0 + Q]))
        keep.append(torch.exp(A[:, -1])[..., None, None])
    for c in range(1, len(states)):                          # phase 2
        states[c] = keep[c] * states[c - 1] + states[c]
    ys = []
    for c, c0 in enumerate(starts):                          # phase 3
        sl = slice(c0, min(c0 + Q, S))
        A = torch.cumsum(dlog[:, sl], dim=1)
        q = A.shape[1]
        scores = torch.einsum("bqn,bsn->bqs", Cm[:, sl], Bm[:, sl])
        dec = A[:, :, None, :] - A[:, None, :, :]
        causal = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
        w = rnd(torch.where(causal, scores[..., None]
                            * torch.exp(dec.masked_fill(~causal, 0.)), 0.))
        y = torch.einsum("bqsh,bshp->bqhp", w, u[:, sl])
        if c > 0:
            y = y + torch.exp(A)[..., None] * torch.einsum(
                "bqn,bhpn->bqhp", Cm[:, sl], rnd(states[c - 1]))
        ys.append(y)
    return torch.cat(ys, dim=1)


def _bf16(x):
    return x.bfloat16().float()


@pytest.mark.parametrize("B,S,H,P,N,chunk", [c[:6] for c in SWEEP]
                         + [(2, 70, 5, 32, 48, 32)])
def test_three_phases_match_the_reference_scan(B, S, H, P, N, chunk):
    """The card's decomposition, in f32, against ``ssd_ref``, the
    reference's ``ssm.ssd`` and (S a multiple of the chunk) ``ssd_pallas``
    in interpret mode, within the f32 sweep's 5e-6 S."""
    u, dlog, Bm, Cm = _inputs(B, S, H, P, N, seed=S + N)
    got = _three_phases(*(torch.from_numpy(a) for a in (u, dlog, Bm, Cm)),
                        chunk).numpy()
    tol = 5e-6 * S
    want = ref.ssd_ref(*(torch.from_numpy(a) for a in (u, dlog, Bm, Cm)),
                       chunk)
    np.testing.assert_allclose(got, want.numpy(), atol=tol, rtol=0)
    ja = [jnp.asarray(a) for a in (u, dlog, Bm, Cm)]
    others = [jssm.ssd(*ja, chunk, unroll=True)]
    if S % chunk == 0:
        others.append(ssd_pallas(*ja, chunk=chunk, head_tile=1))
    for other in others:
        np.testing.assert_allclose(got, np.asarray(other), atol=tol, rtol=0)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 16, 8, 64, 64, 16),       # zamba2-7b's feedback shape, 8 heads
    (1, 560, 3, 64, 64, 256),     # zamba2-7b's widths, 3 chunks, ragged
    (1, 560, 2, 64, 128, 256)])   # mamba2-370m's widths
def test_three_phases_in_bf16_hold_the_model_tolerance(B, S, H, P, N, chunk):
    """With bf16 inputs and the card's bf16 rounding of the decayed scores,
    the carried state and the decayed u, the decomposition stays within the
    bf16 atol 0.15 and a relative error of the whole output of 1e-2 of
    ``ssd_ref`` on the f32 upcast inputs."""
    u, dlog, Bm, Cm = (torch.from_numpy(a) for a in
                       _inputs(B, S, H, P, N, seed=S + N + 1))
    u, Bm, Cm = (t.bfloat16() for t in (u, Bm, Cm))
    got = _three_phases(u, dlog, Bm, Cm, chunk, rnd=_bf16).bfloat16().float()
    want = ref.ssd_ref(u.float(), dlog, Bm.float(), Cm.float(), chunk)
    err = got - want
    assert float(err.abs().max()) <= 0.15
    assert float(err.norm() / want.norm()) <= 1e-2


@pytest.mark.parametrize("S,chunk", [(20, 8), (5, 16)])
def test_model_ssd_pads_a_ragged_sequence(S, chunk):
    u, dlog, Bm, Cm = _inputs(2, S, 3, 16, 8, seed=S)
    want = jssm.ssd(*(jnp.asarray(a) for a in (u, dlog, Bm, Cm)), chunk,
                    unroll=False)
    got = tssm.ssd(*(torch.from_numpy(a) for a in (u, dlog, Bm, Cm)), chunk)
    assert got.shape == u.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_ssd_gradient_matches_jax():
    u, dlog, Bm, Cm = _inputs(2, 24, 3, 16, 8, seed=5)
    w = np.random.default_rng(6).normal(size=u.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jssm.ssd(*a, 8, unroll=True) * w),
                    argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (u, dlog, Bm, Cm)))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (u, dlog, Bm, Cm)]
    out = ops.ssd_scan(*leaves, 8)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def mixer():
    """(JAX cfg, JAX layer-0 mixer params, port cfg, port mixer params) of
    the reduced mamba2-370m with a chunk of 8 (S = 20 takes three)."""
    jcfg = dataclasses.replace(jregistry.get_reduced("mamba2-370m"),
                               ssm_chunk=8)
    tcfg = dataclasses.replace(tregistry.get_reduced("mamba2-370m"),
                               ssm_chunk=8)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = convert.params_from_numpy(tcfg,
                                        jax.tree.map(np.asarray, jparams))
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])
    tp = {k: v[0] for k, v in tparams["layers"]["mixer"].items()}
    return jcfg, jp, tcfg, tp


def test_mamba_block_matches_jax(mixer):
    jcfg, jp, tcfg, tp = mixer
    x = np.random.default_rng(7).normal(size=(2, 20, 64)).astype(np.float32)
    want = jssm.mamba_block(jcfg, jp, jnp.asarray(x), unroll=True)
    got = tssm.mamba_block(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_mamba_decode_matches_jax(mixer):
    jcfg, jp, tcfg, tp = mixer
    rng = np.random.default_rng(8)
    H, P, N = tcfg.ssm_heads, tcfg.ssm_head_dim, tcfg.ssm_state
    conv_dim = tcfg.d_inner + 2 * N
    x = rng.normal(size=(3, 1, 64)).astype(np.float32)
    state = rng.normal(size=(3, H, P, N)).astype(np.float32) * 0.1
    conv = rng.normal(size=(3, tcfg.ssm_conv_width - 1, conv_dim)).astype(
        np.float32)
    want = jssm.mamba_decode(jcfg, jp, *(jnp.asarray(a)
                                         for a in (x, state, conv)))
    got = tssm.mamba_decode(tcfg, tp, *(torch.from_numpy(a)
                                        for a in (x, state, conv)))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
