"""One Sketchy training step and a moe checkpoint of the architectures of
ROADMAP.md queue 1 items 13(a) and 13(b), reduced, in f32, against the JAX
package, from the reference's weights (the helpers of
tests/test_torch_families.py):

(a) one step of the port's trainer (rank 8, block 32, ``update_every`` 1:
    a refresh at the step) against the reference's ``make_train_step``:
    loss ``rtol=1e-4``, parameters ``rtol=1e-4`` plus 1e-5 of each leaf's
    largest magnitude;
(b) the reduced deepseek-moe-16b's parameters and Sketchy state crossing
    the packages both ways through ``convert.convert_checkpoint``, every
    parameter bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import ARCHS, _batch, _models
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.core.factory import OptimizerConfig as JOptimizerConfig
from repro.core.factory import make_optimizer as jmake_optimizer
from repro.train import checkpoint as jckpt
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch import convert, tree
from repro_torch.core.factory import OptimizerConfig as TOptimizerConfig
from repro_torch.core.factory import make_optimizer as tmake_optimizer
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import make_train_step as tmake_train_step

OPT = dict(name="sketchy", learning_rate=3e-3, total_steps=10, rank=8,
           block_size=32, update_every=1, weight_decay=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_sketchy_step_matches_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    batch = _batch(jcfg, seed=3)
    jtx = jmake_optimizer(JOptimizerConfig(**OPT))
    jparams_new, _, jmetrics = jax.jit(jmake_train_step(
        jcfg, jtx, donate=False))(
        jparams, jax.jit(jtx.init)(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ttx = tmake_optimizer(TOptimizerConfig(**OPT))
    tparams_new, _, tmetrics = tmake_train_step(tcfg, ttx)(
        tparams, ttx.init(tree.flatten(tparams)),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-4)
    for got, want in zip(tree.flatten(tparams_new),
                         jax.tree.leaves(jparams_new)):
        assert_close_scaled(got.detach().numpy(), want, rtol=1e-4,
                            atol_frac=1e-5)


def test_moe_checkpoint_crosses_the_packages(tmp_path):
    """The reference's checkpoint of the reduced deepseek-moe-16b with its
    Sketchy state, renamed for the port, restores bit for bit into the
    port's template, and the port's renamed for the reference restores bit
    for bit there: the moe leaf paths (``dense_layers``, ``moe_layers``,
    ``router``, ``experts``, ``shared``) cross the name map."""
    arch = "deepseek-moe-16b"
    jcfg, jparams, tcfg, tparams = _models(arch)
    jtx = jmake_optimizer(JOptimizerConfig(**OPT))
    ttx = tmake_optimizer(TOptimizerConfig(**OPT))
    jstate = jax.jit(jtx.init)(jparams)
    tstate = ttx.init(tree.flatten(tparams))
    jckpt.save(str(tmp_path / "ref"), 0, (jparams, jstate))
    convert.convert_checkpoint(str(tmp_path / "ref"), str(tmp_path / "port"),
                               to="port")
    (got, _), step, _ = tckpt.restore(str(tmp_path / "port"),
                                      (tparams, tstate))
    assert step == 0
    for a, b in zip(tree.flatten(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tckpt.save(str(tmp_path / "port2"), 0, (tparams, tstate))
    convert.convert_checkpoint(str(tmp_path / "port2"),
                               str(tmp_path / "ref2"), to="reference")
    (back, _), step, _ = jckpt.restore(str(tmp_path / "ref2"),
                                       (jparams, jstate))
    assert step == 0
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(back)]
    assert any("moe_layers" in n and "experts" in n for n in names)
    for a, b in zip(jax.tree.leaves(back), tree.flatten(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
