"""The reference's model settings the port runs since it stopped refusing
them, held against repro/models on the same numpy weights (the
reference's own init, ``convert.params_from_numpy``, which crosses float16
exactly) and the same batch, on the CPU, for the reduced paper-lm-100m
(dense), zamba2-7b (hybrid), mamba2-370m (ssm) and deepseek-moe-16b (moe):

(a) ``dtype="float16"``: the loss (``rtol = 1e-3``), the logits (relative
    error in norm 1e-2) and every gradient (relative error in norm, each
    leaf: 2e-2; zamba2-7b 0.2) of ``loss_fn``, and a teacher-forced decode
    of paper-lm-100m (1e-2 in norm a step).  Half precision rounds at
    other places in the two frameworks (XLA fuses and keeps some
    intermediates in f32); measured on these weights: losses within 3.6e-5,
    logits within 4.8e-3, gradients within 8.5e-3 (mamba2-370m) and 8.3e-2
    (zamba2-7b, whose conv and in_proj gradients are sensitive: in bfloat16,
    a dtype the port has run since its first slice, the two packages'
    gradients there differ by 0.75 in norm).
(b) ``remat_policy="dots"``: the gradients equal full remat's bit for bit
    (the saved products are the values the recompute would give), and the
    reference's own ``"dots"`` run's at the f32 tolerances of
    tests/test_torch_hybrid.py (``rtol = 1e-4`` plus 1e-4 of each leaf's
    largest magnitude); the policy keeps the outputs of the projections
    (``aten.mm``, one a projection) and recomputes the batched products
    (attention's plain version, the experts' einsums: ``aten.bmm``).
(c) ``attn_logits_dtype="bfloat16"``: the probabilities of the
    whole-sequence attention bit for bit the reference's ``_attend_math``
    on the same inputs, its outputs and the decode's within the rounding
    of a sum over the keys taken in another order; the model's
    logits within 3e-2 in norm and the loss within 1e-3 (the rounding to
    bf16 amplifies f32 sums taken in other orders: a logit one side or the
    other of a rounding boundary; measured 3.9e-3 dense, 1.4e-2 hybrid, and
    2.1e-2 moe, where such a flip moves a near-tie of the router), and a
    teacher-forced decode of paper-lm-100m (1e-2 in norm).

``check_supported`` refuses only what neither package runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import attention as jattention
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattention
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel

ARCHS = ["paper-lm-100m", "zamba2-7b", "mamba2-370m", "deepseek-moe-16b"]
ATTENTION_ARCHS = ["paper-lm-100m", "zamba2-7b", "deepseek-moe-16b"]
FP16_GRAD_RTOL = {"zamba2-7b": 0.2}
FP16 = dict(dtype="float16")
DOTS = dict(remat=True, remat_policy="dots")
BF16_LOGITS = dict(attn_logits_dtype="bfloat16")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _models(arch, **settings):
    """The reference's and the port's reduced config with ``settings``,
    the reference's f32 init cast to the config's dtype, both sides'
    parameters, and a batch of 3 x 20 tokens."""
    jcfg = dataclasses.replace(jregistry.get_reduced(arch), **settings)
    tcfg = dataclasses.replace(tregistry.get_reduced(arch), **settings)
    jparams = jmodel.init_params(dataclasses.replace(jcfg, dtype="float32"),
                                 jax.random.PRNGKey(1))
    jparams = jax.tree.map(lambda x: x.astype(jcfg.dtype), jparams)
    tparams = convert.params_from_numpy(tcfg,
                                        jax.tree.map(np.asarray, jparams))
    batch = SyntheticLM(DataConfig(vocab_size=jcfg.vocab_size, seq_len=20,
                                   global_batch=3, seed=2)).batch(0)
    return jcfg, jparams, tcfg, tparams, batch


def _reference(jcfg, jparams, batch, grads=True):
    """The reference's logits, loss and gradients (one jitted call)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(p):
        return (jmodel.loss_fn(jcfg, p, jbatch),
                jmodel.forward(jcfg, p, jbatch))
    if not grads:
        loss, logits = jax.jit(f)(jparams)
        return np.asarray(logits, np.float32), float(loss)
    (loss, logits), g = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)
    return (np.asarray(logits, np.float32), float(loss),
            [np.asarray(x, np.float32) for x in jax.tree.leaves(g)])


def _port(tcfg, tparams, batch, grads=True):
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        logits = tmodel.forward(tcfg, tparams, tbatch).float().numpy()
    if not grads:
        return logits
    leaves = tree.flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tmodel.loss_fn(tcfg, tparams, tbatch)
    got = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return logits, loss.item(), got


def test_check_supported_refuses_only_what_neither_package_runs():
    cfg = tregistry.get_reduced("paper-lm-100m")
    for ok in (FP16, DOTS, BF16_LOGITS, dict(attn_logits_dtype="float16"),
               dict(FP16, **DOTS, **BF16_LOGITS)):
        tmodel.check_supported(dataclasses.replace(cfg, **ok))
    for bad in (dict(dtype="float64"), dict(family="rnn"),
                dict(remat_policy="offload"),
                dict(attn_logits_dtype="float64")):
        with pytest.raises(NotImplementedError, match=next(iter(bad))):
            tmodel.check_supported(dataclasses.replace(cfg, **bad))


@pytest.mark.parametrize("arch", ARCHS)
def test_fp16_loss_logits_and_grads_match_reference(arch):
    jcfg, jparams, tcfg, tparams, batch = _models(arch, **FP16)
    assert all(p.dtype == torch.float16 for p in tree.flatten(tparams))
    for want, got in zip(jax.tree.leaves(jparams), tree.flatten(tparams)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlogits, jloss, jgrads = _reference(jcfg, jparams, batch)
    logits, loss, grads = _port(tcfg, tparams, batch)
    assert np.isfinite(loss) and all(torch.isfinite(g).all() for g in grads)
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    assert _rel(logits, jlogits) <= 1e-2
    rtol = FP16_GRAD_RTOL.get(arch, 2e-2)
    assert len(grads) == len(jgrads)
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.float16 and got.shape == want.shape
        assert _rel(got.float().numpy(), want) <= rtol


@pytest.mark.parametrize("settings", [FP16, BF16_LOGITS],
                         ids=["float16", "bf16_logits"])
def test_teacher_forced_decode_matches_reference(settings):
    """paper-lm-100m, 6 steps of 3 lanes at their own positions, caches in
    the model's dtype: each step's logits within 1e-2 of the reference's in
    norm, and the caches within 1e-2."""
    jcfg, jparams, tcfg, tparams, _ = _models("paper-lm-100m", **settings)
    B, max_seq = 3, 16
    jc = jcache.init_cache(jcfg, B, max_seq)
    tc = tcache.init_cache(tcfg, B, max_seq)
    assert all(t.dtype == tmodel.DTYPES[tcfg.dtype] for t in tc.values())
    step = jax.jit(lambda p, c, t, pos: jcache.decode_step(
        jcfg, p, c, {"token": t}, pos))
    rng = np.random.default_rng(5)
    offsets = np.array([0, 2, 5])
    for t in range(6):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = (t + offsets).astype(np.int32)
        jl, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tcache.decode_step(tcfg, tparams, tc,
                                    {"token": torch.from_numpy(tok).long()},
                                    torch.from_numpy(pos).long())
        assert _rel(tl.float().numpy(), jl) <= 1e-2
        for k in tc:
            assert _rel(tc[k].float().numpy(), jc[k]) <= 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_grads_equal_full_remat_and_match_reference(arch):
    _, _, tcfg, tparams, batch = _models(arch, remat=True)
    _, full_loss, full = _port(tcfg, tparams, batch)
    jcfg, jparams, tcfg, tparams, batch = _models(arch, **DOTS)
    _, loss, dots = _port(tcfg, tparams, batch)
    assert loss == full_loss
    for a, b in zip(dots, full):
        assert torch.equal(a, b)
    _, jloss, jgrads = _reference(jcfg, jparams, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    for got, want in zip(dots, jgrads):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)


def test_dots_in_fp16_equal_full_remat():
    _, _, tcfg, tparams, batch = _models("paper-lm-100m", remat=True, **FP16)
    _, _, full = _port(tcfg, tparams, batch)
    _, _, tcfg, tparams, batch = _models("paper-lm-100m", **FP16, **DOTS)
    _, _, dots = _port(tcfg, tparams, batch)
    for a, b in zip(dots, full):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,saved", [("paper-lm-100m", 7),
                                        ("deepseek-moe-16b", None)])
def test_dots_saves_the_projections_not_the_batched_products(
        arch, saved, monkeypatch):
    """Every op the policy keeps is a 2-D product (``aten.mm``/``addmm``);
    attention's plain forward (``aten.bmm``) and every other op are
    recomputed.  A dense layer keeps its 7 projections (q, k, v, o and the
    MLP's gate, up and down); the moe layers also their router and shared
    experts, and their routed experts' batched products are recomputed."""
    seen = []
    policy = tmodel._dots_policy

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, decision))
        return decision
    monkeypatch.setattr(tmodel, "_dots_policy", spy)
    _, _, tcfg, tparams, batch = _models(arch, **DOTS)
    _port(tcfg, tparams, batch)
    kept = [op for op, d in seen
            if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE]
    assert kept and set(kept) <= set(tmodel.DOTS_SAVED)
    bmm = [d for op, d in seen if op == torch.ops.aten.bmm.default]
    assert bmm and all(
        d == torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
        for d in bmm)
    if saved:
        assert len(kept) == saved * tcfg.num_layers


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_bf16_logits_attention_matches_reference(in_dtype):
    """The whole-sequence causal attention (the CPU path) and the decode's
    attention against the reference's on the same inputs, logits rounded
    to bf16: the probabilities are the reference's bits, and the outputs
    differ only by their f32 sum over the keys taken in another order (in
    f32, 2^-20 of the largest output; bf16 outputs one rounding step)."""
    rng = np.random.default_rng(3)
    B, S, H, KV, hd = 2, 20, 4, 2, 16

    def both(*shape):
        x = rng.normal(size=shape).astype(np.float32)
        return (jnp.asarray(x, in_dtype),
                torch.from_numpy(x).to(getattr(torch, in_dtype)))

    def close(got, want):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        tol = 2.0 ** -20 if in_dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * np.abs(want).max())
    (qj, qt), (kj, kt), (vj, vt) = both(B, S, H, hd), both(B, S, KV, hd), \
        both(B, S, KV, hd)
    jcfg = dataclasses.replace(jregistry.get_reduced("paper-lm-100m"),
                               **BF16_LOGITS)
    tcfg = dataclasses.replace(tregistry.get_reduced("paper-lm-100m"),
                               **BF16_LOGITS)
    close(tattention.causal_attention(tcfg, qt, kt, vt),
          jattention.causal_attention(jcfg, qj, kj, vj, unroll=True))
    pos = np.array([4, 17])
    close(tattention._attend(qt[:, :1].reshape(B, 1, KV, H // KV, hd), kt,
                             vt, torch.from_numpy(pos), torch.bfloat16),
          jattention._attend_math(
              qj[:, :1].reshape(B, 1, KV, H // KV, hd), kj, vj,
              jnp.asarray(pos), kv_len=jnp.asarray(pos + 1),
              logits_dtype=jnp.bfloat16))
    # the probabilities: one-hot values pick them out of the product
    eye = np.zeros((B, S, KV, hd), np.float32)
    eye[:, :hd, :, :] = np.eye(hd, dtype=np.float32)[None, :, None, :]
    vj1, vt1 = jnp.asarray(eye, jnp.float32), torch.from_numpy(eye)
    want = jattention.causal_attention(jcfg, qj.astype(jnp.float32),
                                       kj.astype(jnp.float32), vj1,
                                       unroll=True)
    got = tattention.causal_attention(tcfg, qt.float(), kt.float(), vt1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_bf16_logits_forward_matches_reference(arch):
    jcfg, jparams, tcfg, tparams, batch = _models(arch, **BF16_LOGITS)
    jlogits, jloss = _reference(jcfg, jparams, batch, grads=False)
    logits = _port(tcfg, tparams, batch, grads=False)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with torch.no_grad():
        loss = tmodel.loss_fn(tcfg, tparams, tbatch).item()
    assert _rel(logits, jlogits) <= 3e-2
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)
    # the setting reaches the model: f32 logits give other logits
    f32 = _port(dataclasses.replace(tcfg, attn_logits_dtype="float32"),
                tparams, batch, grads=False)
    assert not np.array_equal(f32, logits)
