"""The port's Frequent Directions against repro/core/fd.py.

The same numpy factors go through ``fd_update_batched`` in both packages for
several updates; after each one the sketched covariance ``U diag(s) U^T``,
the ladder ``s``, ``rho`` and the applied inverse-root direction are
compared.  Raw ``U`` is never compared: the two packages call different
LAPACK ``eigh``s, whose eigenvectors may differ in sign.

Tolerance ``rtol=1e-4`` and ``atol=1e-5`` times the compared array's
largest magnitude (tests/torch_parity.py says why); the largest difference
measured was 1.1e-5 of the largest magnitude, on an entry within its rtol.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.core import fd as jfd
from repro_torch.core import fd as tfd


def _jax_state(N, d, ell):
    one = jfd.fd_init(d, ell)
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (N,) + x.shape), one)


def _cov(U, s):
    U, s = np.asarray(U, np.float64), np.asarray(s, np.float64)
    return np.einsum("nde,ne,nfe->ndf", U, s, U)


@pytest.mark.parametrize("N,d,ell,r", [(3, 24, 6, 5), (2, 16, 20, 3),
                                       (4, 40, 8, 40)])
def test_fd_update_and_apply_match_jax(N, d, ell, r):
    rng = np.random.default_rng(d + r)
    beta2 = 0.99
    js, ts = _jax_state(N, d, ell), tfd.fd_init(d, ell, num_blocks=N)
    for step in range(4):
        a = rng.normal(size=(N, d, r)).astype(np.float32) * (step + 1)
        js = jfd.fd_update_batched(js, jnp.asarray(a), beta2)
        ts = tfd.fd_update_batched(ts, torch.from_numpy(a), beta2)
        assert_close_scaled(ts.eigvals.numpy(), js.eigvals)
        assert_close_scaled(ts.rho.numpy(), js.rho)
        assert_close_scaled(_cov(ts.eigvecs, ts.eigvals),
                            _cov(js.eigvecs, js.eigvals))

        g = rng.normal(size=(N, d, 7)).astype(np.float32)
        kw = dict(exponent=-0.25, eps=1e-6)
        want = jfd.fd_apply_inverse_root_batched(js, jnp.asarray(g), **kw)
        got = tfd.fd_apply_inverse_root_batched(ts, torch.from_numpy(g), **kw)
        assert_close_scaled(got.numpy(), want)


def test_inverse_root_coeffs_match_jax():
    """Including the Moore-Penrose edge: no diagonal mass maps the
    complement to 0."""
    rng = np.random.default_rng(0)
    s = np.sort(rng.random((3, 5)).astype(np.float32), axis=1)[:, ::-1].copy()
    s[:, -1] = 0.0
    rho = np.array([0.0, 1e-3, 2.0], np.float32)
    state = lambda mod, conv: mod.FDState(eigvecs=None, eigvals=conv(s),
                                          rho=conv(rho))
    for eps in (0.0, 1e-6):
        jb, jc = jfd.fd_inverse_root_coeffs(state(jfd, jnp.asarray),
                                            exponent=-0.25, eps=eps)
        tb, tc = tfd.fd_inverse_root_coeffs(state(tfd, torch.from_numpy),
                                            exponent=-0.25, eps=eps)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=1e-6)


def test_fd_rank_deficient_blocks_stay_finite():
    """A zero gradient block (an embedding row block no token touched) and
    blocks of tiny gradients refresh to finite sketches on the CPU path."""
    a = np.zeros((3, 32, 36), np.float32)
    a[1, :2] = 1e-9 * np.random.default_rng(1).normal(size=(2, 36))
    a[2, 0, 0] = 1e-20
    ts = tfd.fd_init(32, 4, num_blocks=3)
    for _ in range(2):
        ts = tfd.fd_update_batched(ts, torch.from_numpy(a), 0.999)
    for t in ts:
        assert torch.isfinite(t).all()
    assert float(ts.eigvals[0].abs().max()) == 0.0
