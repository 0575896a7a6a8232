"""The port's Frequent Directions against repro/core/fd.py.

The same numpy factors go through ``fd_update_batched`` (a pool stack) and
``fd_update`` (one unbatched sketch, as the serving path's monitor and
S-AdaGrad run it, up to a tall 4096 x 9 factor) in both packages for
several updates; after each one the sketched covariance ``U diag(s) U^T``,
the ladder ``s``, ``rho`` and the applied inverse-root direction are
compared, and for the single sketch the monitor's read-outs
(``fd_pressure``, ``fd_leading_eigval``, ``fd_subspace_angle``).  Raw ``U``
is never compared: the two packages call different LAPACK ``eigh``s, whose
eigenvectors may differ in sign.

Tolerance ``rtol=1e-4`` and ``atol=1e-5`` times the compared array's
largest magnitude (tests/torch_parity.py says why); the largest difference
measured was 1.1e-5 of the largest magnitude, on an entry within its rtol.
``rho`` takes its slack from the ladder it comes from (the larger of
max|eigvals| and max|rho|): when the stacked factor has rank below ``ell``
it is an eigenvalue at rounding level of a Gram whose other eigenvalues
are of order 10, and a scale of its own largest value (0 in the reference)
would leave it no slack at all.  The subspace angle is
``arccos(sigma_min)``, whose slope 1/sin grows without bound as the angle
goes to 0, so it is held to 1e-3 rad; the subspaces are compared directly
too (their projectors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_close_scaled, ladder,  # noqa: F401
                          torch_one_thread)

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
        # rho is the ell-th eigenvalue of the refresh Gram, at rounding
        # level when the stack has rank below ell (d=16 with ell clipped
        # to 16): its slack scales with the ladder it comes from
        assert_close_scaled(ts.rho.numpy(), js.rho, scale=ladder(js))
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


def _one(state):
    """Block-free view of a JAX or torch single sketch as float64 numpy."""
    return [np.asarray(x, np.float64) for x in state]


@pytest.mark.parametrize("d,ell,r,beta2", [(24, 6, 5, 0.99), (30, 8, 1, 1.0),
                                           (4096, 8, 1, 0.95)])
def test_single_block_fd_matches_jax(d, ell, r, beta2):
    """``fd_update`` / ``fd_apply_inverse_root`` on one unbatched sketch
    (the reference's single-block entries, with the plain Gram and apply),
    and the monitor's read-outs of it."""
    rng = np.random.default_rng(d + ell)
    js, ts = jfd.fd_init(d, ell), tfd.fd_init(d, ell)
    assert ts.eigvecs.shape == (d, ell) and ts.rho.shape == ()
    prev_j = prev_t = None
    for step in range(4):
        a = rng.normal(size=(d, r)).astype(np.float32) * (step + 1)
        js = jfd.fd_update(js, jnp.asarray(a), beta2=beta2)
        ts = tfd.fd_update(ts, torch.from_numpy(a), beta2=beta2)
        assert_close_scaled(ts.eigvals.numpy(), js.eigvals)
        assert_close_scaled(ts.rho.numpy(), js.rho, scale=ladder(js))
        jU, js_, _ = _one(js)
        tU, ts_, _ = _one(ts)
        assert_close_scaled((tU * ts_) @ tU.T, (jU * js_) @ jU.T)

        g = rng.normal(size=(d, 3)).astype(np.float32)
        kw = dict(exponent=-0.5, eps=1e-6)
        want = jfd.fd_apply_inverse_root(js, jnp.asarray(g), **kw)
        got = tfd.fd_apply_inverse_root(ts, torch.from_numpy(g), **kw)
        assert_close_scaled(got.numpy(), want)

        assert_close_scaled(float(tfd.fd_pressure(ts)),
                            float(jfd.fd_pressure(js)), atol_frac=1e-4)
        for comp in (True, False):
            assert_close_scaled(
                float(tfd.fd_leading_eigval(ts, compensated=comp)),
                float(jfd.fd_leading_eigval(js, compensated=comp)))
        if prev_j is not None:
            k = min(3, ell)
            np.testing.assert_allclose(
                float(tfd.fd_subspace_angle(prev_t, ts, k=k)),
                float(jfd.fd_subspace_angle(prev_j, js, k=k)), atol=1e-3)
            pj, pt = jU[:, :k], tU[:, :k]
            np.testing.assert_allclose(pt @ pt.T, pj @ pj.T, atol=1e-4)
        prev_j, prev_t = js, ts
    np.testing.assert_allclose(
        tfd.fd_covariance(ts, include_rho=True).numpy(),
        np.asarray(jfd.fd_covariance(js, include_rho=True)),
        rtol=1e-4, atol=1e-5 * ladder(js))


def test_subspace_angle_extremes():
    """0 for a subspace against itself, pi/2 against an orthogonal one, on
    raw eigenvector tensors and on sketches, batched too."""
    q = np.linalg.qr(np.random.default_rng(0).normal(size=(12, 6)))[0]
    a, b = torch.from_numpy(q[:, :3].copy()), torch.from_numpy(q[:, 3:].copy())
    assert float(tfd.fd_subspace_angle(a, a)) == pytest.approx(0.0, abs=1e-3)
    assert float(tfd.fd_subspace_angle(a, b)) == pytest.approx(np.pi / 2)
    st = tfd.FDState(torch.stack([a, b]), torch.ones(2, 3), torch.zeros(2))
    got = tfd.fd_subspace_angle(st, tfd.FDState(torch.stack([a, a]),
                                                None, None))
    np.testing.assert_allclose(got.numpy(), [0.0, np.pi / 2], atol=1e-3)
