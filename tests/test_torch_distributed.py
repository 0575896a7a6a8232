"""The port's distributed FD against repro/core/fd.py and repro/distributed/,
in this process (no process group; tests/test_torch_distributed_ranks.py
runs the collectives on gloo ranks).

The same numpy inputs go through both packages' ``fd_weighted_factor``,
``fd_merge_factors_batched``, ``fd_merge_batched``, ``fd_merge``, the wire
functions (``pack_wire``, ``unpack_wire``, ``merge_wire``) and
``merge_stack_states``.  Sketches are compared by covariance ``U diag(s)
U^T``, ladder and ``rho``, never by raw eigenvectors (the two LAPACK
``eigh``s may differ in sign, and the eigenvectors of a rank-deficient
merge are not defined), with ``assert_close_scaled`` (tests/torch_parity.py:
``rtol=1e-4`` and 1e-5 of the largest magnitude; ``rho`` against the
ladder's magnitude).  The wire's int8 values and scales of the same f32
factor are equal in both packages (both round to nearest, half to even).
Also: the bytes on the wire per refresh (64,544 B at P 4, d 256, ell 64, as
benchmarks/run.py counts them, and at the full-width paper-lm-100m pools
that chip_smoke.py's sharded phase checks), the sharded engine with no
group bound is the replicated one bit for bit, and "sharded" turns the
fused int8 path off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_close_scaled, chip_smoke,  # noqa: F401
                          ladder, torch_one_thread)

from repro.core import fd as jfd
from repro.distributed import sketch_merge as jwire
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import api as tapi
from repro_torch.core import fd as tfd
from repro_torch.core import pool
from repro_torch.core import sketchy as tsk
from repro_torch.distributed import sketch_merge as twire
from repro_torch.models import model as model_lib


def _state(rng, N, d, ell, rank=None):
    """A sketch stack as numpy arrays: orthonormal U (N, d, ell) with
    columns past ``rank`` zero, a descending ladder deflated to s[-1] = 0
    (zero past ``rank``), and rho > 0."""
    rank = ell if rank is None else rank
    U = np.zeros((N, d, ell), np.float32)
    s = np.zeros((N, ell), np.float32)
    for n in range(N):
        q, _ = np.linalg.qr(rng.normal(size=(d, ell)))
        U[n, :, :rank] = q[:, :rank]
        lad = np.sort(rng.uniform(0.5, 5.0, size=rank))[::-1]
        s[n, :rank] = lad - lad[-1] if rank == ell else lad
    rho = rng.uniform(0.1, 1.0, size=N).astype(np.float32)
    return U, s, rho


def _both(U, s, rho):
    return (jfd.FDState(jnp.asarray(U), jnp.asarray(s), jnp.asarray(rho)),
            tfd.FDState(torch.from_numpy(U), torch.from_numpy(s),
                        torch.from_numpy(rho)))


def _cov(U, s):
    U, s = np.asarray(U, np.float64), np.asarray(s, np.float64)
    return np.einsum("...de,...e,...fe->...df", U, s, U)


def _assert_same_sketch(got, want):
    """Port sketch ``got`` against reference sketch ``want``: covariance,
    ladder, rho (``rho`` is additive through a merge, so this holds the
    sum too)."""
    assert_close_scaled(_cov(got.eigvecs.numpy(), got.eigvals.numpy()),
                        _cov(want.eigvecs, want.eigvals))
    assert_close_scaled(got.eigvals.numpy(), want.eigvals)
    assert_close_scaled(got.rho.numpy(), want.rho, scale=ladder(want))


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_weighted_factor_matches_jax(drop, lead):
    rng = np.random.default_rng(len(lead) + drop)
    U, s, rho = _state(rng, 3, 12, 5)
    if not lead:
        U, s, rho = U[0], s[0], np.asarray(rho[0])
    js, ts = _both(U, s, rho)
    want = jfd.fd_weighted_factor(js, drop_deflated=drop)
    got = tfd.fd_weighted_factor(ts, drop_deflated=drop)
    assert got.shape == want.shape
    assert_close_scaled(got.numpy(), want)


# (N, d, ra, rb, ell, rank of each side): full sides, sides skinnier than
# ell together (padded), and rank-deficient sides (the norm group's case)
MERGE_CASES = [(3, 24, 5, 6, 8, None), (2, 16, 2, 3, 8, None),
               (4, 40, 8, 8, 8, None), (2, 12, 11, 11, 12, 3)]


@pytest.mark.parametrize("N,d,ra,rb,ell,rank", MERGE_CASES)
def test_merge_factors_batched_matches_jax(N, d, ra, rb, ell, rank):
    rng = np.random.default_rng(d + ra)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    Ba, Bb = f32(N, d, ra), f32(N, d, rb)
    if rank is not None:           # factors of rank ``rank``
        Ba = (f32(N, d, rank) @ f32(N, rank, ra)).astype(np.float32)
        Bb = (f32(N, d, rank) @ f32(N, rank, rb)).astype(np.float32)
    rho_a = rng.uniform(0, 1, N).astype(np.float32)
    rho_b = rng.uniform(0, 1, N).astype(np.float32)
    want = jfd.fd_merge_factors_batched(
        jnp.asarray(Ba), jnp.asarray(rho_a), jnp.asarray(Bb),
        jnp.asarray(rho_b), ell=ell)
    got = tfd.fd_merge_factors_batched(
        torch.from_numpy(Ba), torch.from_numpy(rho_a), torch.from_numpy(Bb),
        torch.from_numpy(rho_b), ell=ell)
    assert got.eigvecs.shape == (N, d, ell)
    _assert_same_sketch(got, want)
    # the masses add: rho_a + rho_b + rho_t, rho_t >= 0 the escaped one
    assert np.all(got.rho.numpy() >= rho_a + rho_b - 1e-6)
    assert np.all(got.eigvals.numpy()[:, -1] == 0)


@pytest.mark.parametrize("rank", [None, 2])
def test_merge_batched_and_single_match_jax(rank):
    rng = np.random.default_rng(7)
    a, b = _state(rng, 3, 20, 6, rank), _state(rng, 3, 20, 6, rank)
    (ja, ta), (jb, tb) = _both(*a), _both(*b)
    _assert_same_sketch(tfd.fd_merge_batched(ta, tb),
                        jfd.fd_merge_batched(ja, jb))
    one = lambda st: type(st)(*(x[1] for x in st))
    _assert_same_sketch(tfd.fd_merge(one(ta), one(tb)),
                        jfd.fd_merge(one(ja), one(jb)))


@pytest.mark.parametrize("wire", ["int8", "fp32"])
def test_wire_functions_match_jax(wire):
    rng = np.random.default_rng(11)
    (ja, ta), (jb, tb) = _both(*_state(rng, 3, 24, 7)), \
        _both(*_state(rng, 3, 24, 7))
    jw, tw = jwire.pack_wire(ja, wire), twire.pack_wire(ta, wire)
    for got, want in zip(tw, jw):
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if wire == "int8":
        np.testing.assert_array_equal(tw.values.numpy(), jw.values)
        np.testing.assert_array_equal(tw.scale.numpy(), jw.scale)
    else:
        assert_close_scaled(tw.values.numpy(), jw.values)
    np.testing.assert_array_equal(tw.rho.numpy(), jw.rho)
    for got, want in zip(twire.unpack_wire(tw), jwire.unpack_wire(jw)):
        assert_close_scaled(got.numpy(), want)
    assert twire.wire_bytes(tw) == jwire.wire_bytes(jw)
    jm = jwire.merge_wire(jw, jwire.pack_wire(jb, wire), ell=7)
    tm = twire.merge_wire(tw, twire.pack_wire(tb, wire), ell=7)
    _assert_same_sketch(tm, jm)


def test_merge_stack_states_matches_jax():
    rng = np.random.default_rng(5)
    pairs = [_both(*_state(rng, 2, 16, 5)) for _ in range(3)]
    _assert_same_sketch(twire.merge_stack_states([t for _, t in pairs]),
                        jwire.merge_stack_states([j for j, _ in pairs]))
    with pytest.raises(ValueError):
        twire.merge_stack_states([])
    with pytest.raises(ValueError, match="wire_dtype"):
        twire.pack_wire(pairs[0][1], "fp16")


def _wire_bytes_per_refresh(shapes, P, wire_bytes, pack, state):
    """Bytes one rank sends per refresh: log2(P) rounds, every (N, d, ell)
    sketch stack of ``shapes`` once a round, from zero-filled states."""
    rounds = (P - 1).bit_length()
    return rounds * sum(wire_bytes(pack(state(N, d, ell), "int8"))
                        for N, d, ell in shapes)


def _zeros_jax(N, d, ell):
    return jfd.FDState(jnp.zeros((N, d, ell)), jnp.zeros((N, ell)),
                       jnp.zeros((N,)))


def _pack_abstract(state, wire):
    """The reference's ``pack_wire`` of ``state`` evaluated abstractly
    (``jax.eval_shape``): the wire's shapes and dtypes, without the 6 s
    its eager run takes on the full-width stacks."""
    return jax.eval_shape(lambda st: jwire.pack_wire(st, wire), state)


def _abstract_jax(N, d, ell):
    return jfd.FDState(*(jax.ShapeDtypeStruct(s, jnp.float32)
                         for s in ((N, d, ell), (N, ell), (N,))))


def _zeros_torch(N, d, ell):
    return tfd.fd_init(d, ell, num_blocks=N)


def test_wire_bytes_per_refresh():
    """64,544 B at P 4, d 256, ell 64, both sides of one block (the
    reference's bytes_on_wire_per_refresh row, benchmarks/run.py); and at
    full-width paper-lm-100m with the launcher's defaults (rank 64, block
    1024; both sides of every pool group), the count chip_smoke.py holds
    each rank of its sharded run to: the port's from zero-filled stacks,
    the reference's from its ``pack_wire`` evaluated abstractly."""
    one = [(1, 256, 64)] * 2
    for wb, pack, st in ((jwire.wire_bytes, jwire.pack_wire, _zeros_jax),
                         (twire.wire_bytes, twire.pack_wire, _zeros_torch)):
        assert _wire_bytes_per_refresh(one, 4, wb, pack, st) == 64_544
    cfg = registry.get_config("paper-lm-100m")
    leaf_shapes = tuple(tuple(s) for s in
                        tree.flatten(model_lib.param_shapes(cfg)))
    shapes = [(g.num_blocks, d, min(64, d))
              for g in pool.build_index(leaf_shapes, 1024).groups
              for d in (g.bs_m, g.bs_n)]
    want = _wire_bytes_per_refresh(shapes, 4, jwire.wire_bytes,
                                   _pack_abstract, _abstract_jax)
    got = _wire_bytes_per_refresh(shapes, 4, twire.wire_bytes,
                                  twire.pack_wire, _zeros_torch)
    assert got == want == chip_smoke().SHARDED_WIRE_BYTES


def _sketchy_run(steps=3, **kw):
    """Three Sketchy engine steps (rank 6, block 16, beta2 0.9, a refresh
    every step) on a (16, 16) and a (10,) leaf; every output tensor."""
    rng = np.random.default_rng(3)
    params = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((10,), (16, 16))]
    tx = tsk.sketchy(tsk.SketchyConfig(
        rank_budget=tsk.RankBudget(min_k=6, max_k=6), block_size=16,
        beta2=0.9, update_every=1, **kw))
    state = tx.init(params)
    out = []
    for _ in range(steps):
        grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
                 for p in params]
        dirs, state = tx.update(grads, state, params)
        out += dirs
    return out + tapi._leaves(list(state.pools.values())) + tapi._leaves(
        [leaf.stats for leaf in state.leaves if leaf.stats is not None])


@pytest.mark.parametrize("storage,epilogue", [("fp32", "auto"),
                                              ("int8", "off")])
def test_sharded_with_no_group_bound_is_replicated_bit_for_bit(storage,
                                                               epilogue):
    """With no group bound to the axis the sharded engine takes the
    replicated path.  Under int8 storage "sharded" runs the dequantizing
    path even so (the reference turns the fused path off under "sharded",
    bound or not), so it equals replicated with the epilogue off."""
    kw = dict(second_moment_dtype=storage)
    want = _sketchy_run(quantized_epilogue=epilogue, **kw)
    for wire in ("int8", "fp32"):
        got = _sketchy_run(stats_reduction="sharded", stats_wire_dtype=wire,
                           **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    if storage == "int8":
        fused = _sketchy_run(**kw)      # "auto": the fused path
        assert not all(torch.equal(g, w) for g, w in zip(fused, want))
