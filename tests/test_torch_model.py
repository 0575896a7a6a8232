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
