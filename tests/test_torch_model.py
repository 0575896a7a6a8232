"""The port's dense LM against repro/models/model.py: the reduced
paper-lm-100m loss and every gradient, from identical parameters
(``convert.params_from_numpy``) and the same batch.

Tolerance ``rtol=1e-4, atol=1e-6`` in f32: XLA and PyTorch sum in different
orders.
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
from repro.models import model as jmodel
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as tmodel


# seq 40: two q chunks, the second ragged; remat: per-layer recompute
@pytest.mark.parametrize("seq,remat", [(16, False), (40, False), (16, True)])
def test_loss_and_grads_match_jax(seq, remat):
    cfg_j = dataclasses.replace(jregistry.get_reduced("paper-lm-100m"),
                                remat=remat)
    cfg_t = dataclasses.replace(tregistry.get_reduced("paper-lm-100m"),
                                remat=remat)
    jparams = jmodel.init_params(cfg_j, jax.random.PRNGKey(1))
    batch = SyntheticLM(DataConfig(vocab_size=cfg_j.vocab_size, seq_len=seq,
                                   global_batch=3, seed=2)).batch(0)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(cfg_j, p, b)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = convert.params_from_numpy(cfg_t,
                                        jax.tree.map(np.asarray, jparams))
    leaves = tree.flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    tloss = tmodel.loss_fn(cfg_t, tparams, tbatch)
    tgrads = torch.autograd.grad(tloss, leaves)

    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for got, want in zip(tgrads, jleaves):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


def test_param_shapes_and_init_rule_match_jax():
    """Same tree and shapes; the seeded init follows the reference's rule
    (zero vectors, matrices with std fan_in^-1/2) in the config dtype."""
    cfg_j = jregistry.get_config("paper-lm-100m")
    cfg_t = tregistry.get_config("paper-lm-100m")
    assert tmodel.param_shapes(cfg_t) == jmodel.param_shapes(cfg_j)
    small = tregistry.get_reduced("paper-lm-100m")
    params = tmodel.init_params(small, torch.Generator().manual_seed(0))
    for (path, shape), p in zip(
            _paths(tmodel.param_shapes(small)), tree.flatten(params)):
        assert tuple(p.shape) == shape and p.dtype == torch.float32, path
        if len(shape) == 1:
            assert not p.any(), path
        else:
            std = float(p.std() * shape[-2] ** 0.5)
            assert 0.8 < std < 1.2, (path, std)


def _paths(t, prefix=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _paths(t[k], f"{prefix}/{k}")]
    return [(prefix, t)]


def test_params_from_numpy_rejects_a_wrong_tree():
    cfg = tregistry.get_reduced("paper-lm-100m")
    good = jax.tree.map(np.asarray, jmodel.init_params(
        jregistry.get_reduced("paper-lm-100m"), jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_numpy(cfg, {k: v for k, v in good.items()
                                        if k != "lm_head"})
    bad = dict(good, final_norm=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(cfg, bad)


def test_bf16_python_float_sites_round_as_jax(monkeypatch):
    """The model's sites where a Python float meets a bf16 tensor: the RMS
    norm's eps and its ``1 + scale``, RoPE's theta and the causal
    attention's ``hd ** -0.5`` compute in f32 in both packages (JAX's weak
    type never rounds them to bf16), so a bf16 activation comes out with
    the reference's bits.  The residuals add tensors, and the embedding
    scale rounds its scalar to bf16 as the reference's does
    (tests/test_torch_layers.py).

    The attention scale is held at the logits, the softmax's input, in
    training and in decode, at a head dim of 128: its ``hd ** -0.5``
    rounded to bf16 would move every logit by 1.1e-4 of itself, and the
    logits agree with the reference's to 2^-20 of the largest (f32 sums
    taken in other orders)."""
    from repro.models import attention as jattention
    from repro.models import layers as jlayers
    from repro_torch.models import attention as tattention
    from repro_torch.models import layers as tlayers
    rng = np.random.default_rng(4)

    def both(*shape, scale=1.0):
        x = (rng.normal(size=shape) * scale).astype(np.float32)
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))

    def bits(j, t):
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(j, jnp.float32)), t.float().numpy())

    (xj, xt), (sj, st) = both(2, 16, 64, scale=3.0), both(64, scale=0.1)
    bits(jlayers.rms_norm(xj, sj, 1e-6), tlayers.rms_norm(xt, st, 1e-6))
    (qj, qt) = both(2, 16, 4, 32)
    pos = np.tile(np.arange(16), (2, 1))
    bits(jlayers.apply_rope(qj, jnp.asarray(pos), 10000.0),
         tlayers.apply_rope(qt, torch.from_numpy(pos), 10000.0))
    cfg_j = dataclasses.replace(jregistry.get_reduced("paper-lm-100m"),
                                dtype="bfloat16")
    cfg_t = dataclasses.replace(tregistry.get_reduced("paper-lm-100m"),
                                dtype="bfloat16")
    seen_j, seen_t = [], []
    softmax_j, softmax_t = jax.nn.softmax, torch.softmax
    monkeypatch.setattr(jax.nn, "softmax", lambda s, axis: (
        seen_j.append(np.asarray(s)), softmax_j(s, axis=axis))[1])
    monkeypatch.setattr(torch, "softmax", lambda s, dim: (
        seen_t.append(s.numpy()), softmax_t(s, dim=dim))[1])
    H, KV, hd = 4, 2, 128
    (qj, qt), (kj, kt), (vj, vt) = (both(2, 16, H, hd), both(2, 16, KV, hd),
                                    both(2, 16, KV, hd))
    jattention.causal_attention(cfg_j, qj, kj, vj, unroll=True)
    tattention.causal_attention(cfg_t, qt, kt, vt)
    pos = np.array([5, 11])
    jattention._attend_math(qj[:, :1].reshape(2, 1, KV, H // KV, hd), kj, vj,
                            jnp.asarray(pos))
    tattention._attend(qt[:, :1].reshape(2, 1, KV, H // KV, hd), kt, vt,
                       torch.from_numpy(pos))
    train_j = seen_j[0].reshape(2, H, 16, 16)      # (B, KV, G, q, k)
    for want, got in ((train_j, seen_t[0]), (seen_j[1], seen_t[1])):
        live = want > -1e29
        tol = 2.0 ** -20 * np.abs(want[live]).max()
        np.testing.assert_array_equal(got > -1e29, live)
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=tol)
        # a scale rounded to bf16 would not pass
        off = float(jnp.asarray(hd ** -0.5, jnp.bfloat16)) / hd ** -0.5
        assert np.abs(want[live] * off - want[live]).max() > 50 * tol
