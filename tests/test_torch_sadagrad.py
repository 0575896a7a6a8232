"""The port's S-AdaGrad (paper Alg. 2) and the engine features it runs on,
against repro/core/sadagrad.py and repro/core/api.py.

The same numpy gradient stream goes through ``sadagrad_step`` in both
packages; after each step the iterate, the sketch's covariance
``U diag(s) U^T``, its ladder ``s`` and ``rho`` are compared (raw ``U`` is
not: the packages' ``eigh``s may flip eigenvector signs).  The sketch is one
(d, 1) block (``treat_vectors_as_columns``), refreshed every step with no
grafting, through the single-block ``fd_update`` and
``fd_apply_inverse_root``; with two vectors of the same length the pool has
two blocks and the engine loops the per-block methods over the pool dim.

Tolerance as in tests/test_torch_fd.py: ``rtol=1e-4`` plus ``1e-5`` of the
largest magnitude of the compared array (``rho`` of the sketch's ladder).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_close_scaled, ladder,  # noqa: F401
                          torch_one_thread)

from repro.core import api as japi
from repro.core import pool as jpool
from repro.core import sadagrad as jsadagrad
from repro.core import transform as jtransform
from repro_torch.core import api as tapi
from repro_torch.core import pool as tpool
from repro_torch.core import sadagrad as tsadagrad
from repro_torch.core import transform as ttransform


def _cov(U, s):
    U, s = np.asarray(U, np.float64), np.asarray(s, np.float64)
    return (U * s) @ U.T


def _assert_sketch_close(ts, js):
    assert_close_scaled(ts.eigvals.numpy(), js.eigvals)
    assert_close_scaled(ts.rho.numpy(), js.rho, scale=ladder(js))
    assert_close_scaled(_cov(ts.eigvecs, ts.eigvals),
                        _cov(js.eigvecs, js.eigvals))


@pytest.mark.parametrize("d,ell,steps", [(40, 3, 6), (4096, 4, 6)])
def test_sadagrad_steps_match_jax(d, ell, steps):
    rng = np.random.default_rng(d)
    x0 = rng.normal(size=d).astype(np.float32)
    js = jsadagrad.sadagrad_init(d, ell)
    ts = tsadagrad.sadagrad_init(d, ell, device="cpu")
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    for step in range(steps):
        # a drifting low-rank stream plus noise: the sketch fills, deflates
        # and carries escaped mass
        g = (rng.normal(size=(d, 3)) @ rng.normal(size=3)
             + 0.1 * rng.normal(size=d)).astype(np.float32) * (step + 1)
        jx, js = jsadagrad.sadagrad_step(js, jx, jnp.asarray(g), 0.1)
        tx, ts = tsadagrad.sadagrad_step(ts, tx, torch.from_numpy(g), 0.1)
        assert_close_scaled(tx.numpy(), jx)
        _assert_sketch_close(ts.sketch, js.sketch)
    assert float(ts.sketch.rho) > 0.0


def _chains(ell, beta2, lr):
    """The serving adapter's chain (repro/serve/adapt.py) in both
    packages: injected lr and beta2, S-AdaGrad, then -lr."""
    def jbuild(learning_rate, beta2):
        return japi.named_chain(
            ("precond", japi.scale_by_preconditioner(
                jsadagrad.SAdaGradPreconditioner(ell, beta2),
                japi.EngineConfig(block_size=1 << 30, beta2=1.0,
                                  update_every=1, graft="none",
                                  treat_vectors_as_columns=True))),
            ("lr", jtransform.scale(-learning_rate)))

    def tbuild(learning_rate, beta2):
        return tapi.named_chain(
            ("precond", tapi.scale_by_preconditioner(
                tsadagrad.SAdaGradPreconditioner(ell, beta2),
                tsadagrad.ENGINE)),
            ("lr", ttransform.scale(-learning_rate)))

    return (japi.inject_hyperparams(jbuild)(learning_rate=lr, beta2=beta2),
            tapi.inject_hyperparams(tbuild)(learning_rate=lr, beta2=beta2))


def test_pooled_vectors_and_hyperparams_match_jax():
    """Two d-vectors pool into one (d, 1) group of two blocks; the engine
    loops the per-block refresh and apply over them.  ``set_hyperparams``
    takes effect on the next update, in both packages; ``pool_stats``
    reads the two sketches back."""
    d, ell = 24, 4
    rng = np.random.default_rng(3)
    jtx, ttx = _chains(ell, beta2=0.9, lr=0.1)
    params = [np.zeros(d, np.float32), np.zeros(d, np.float32)]
    jst = jtx.init([jnp.asarray(p) for p in params])
    tst = ttx.init([torch.from_numpy(p) for p in params])
    for step in range(4):
        if step == 2:
            jst = japi.set_hyperparams(jst, learning_rate=0.05, beta2=0.5)
            tst = tapi.set_hyperparams(tst, learning_rate=0.05, beta2=0.5)
        gs = [rng.normal(size=d).astype(np.float32) for _ in params]
        jout, jst = jtx.update([jnp.asarray(g) for g in gs], jst)
        tout, tst = ttx.update([torch.from_numpy(g) for g in gs], tst)
        for got, want in zip(tout, jout):
            assert_close_scaled(got.numpy(), want)
    assert {k: float(v) for k, v in tapi.get_hyperparams(tst).items()} == \
        pytest.approx({k: float(v)
                       for k, v in japi.get_hyperparams(jst).items()})
    with pytest.raises(KeyError, match="unknown"):
        tapi.set_hyperparams(tst, nope=1.0)
    jstats = japi.pool_stats(japi.get_stage(jst, "precond"))
    tstats = tapi.pool_stats(tst.inner["precond"])
    assert tstats.eigvecs.shape == (2, d, ell)
    for n in range(2):
        _assert_sketch_close(
            type(tstats)(*(x[n] for x in tstats)),
            jax.tree.map(lambda x: x[n], jstats))


def test_vectors_as_columns_index_matches_jax():
    shapes = ((24,), (24,), (7, 5), (3,))
    for flag in (False, True):
        ij = jpool.build_index(shapes, 1024, vectors_as_columns=flag)
        it = tpool.build_index(shapes, 1024, vectors_as_columns=flag)
        assert [(g.key, g.num_blocks, g.leaf_ids) for g in it.groups] == \
            [(g.key, g.num_blocks, g.leaf_ids) for g in ij.groups]
        assert [(p.group, p.offset) for p in it.leaves] == \
            [(p.group, p.offset) for p in ij.leaves]


def test_graft_none_leaves_no_grafting_state():
    tx = tsadagrad.sadagrad(4)
    state = tx.init([torch.zeros(16)])
    assert all(leaf.graft is None for leaf in state.leaves)
