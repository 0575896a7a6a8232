"""The port's collectives on four gloo ranks against the reference's
functions, called in this process on one device (no JAX mesh).

A module fixture starts one process group of 4 ranks, each a fresh
interpreter running tests/torch_dist_ranks.py (PyTorch and the port only,
one CPU thread, a file rendezvous in ``tmp_path``; this process never joins
a group), waits at most 120 s for all of them (then kills every rank and
fails) and loads what each saved.  The tests then hold:

  * the butterfly at P 4 against the reference fold ``merge_wire(pack(.),
    pack(.))`` in rank order, under the fp32 and the int8 wire; the fp32
    merge within the FD bound of the exact union covariance and the int8
    ladder within 0.1 of the fp32 one (as
    tests/test_distributed.py::test_butterfly_merge_under_shard_map);
  * the gather-merge at P 3 (the subgroup of ranks 0-2) against the
    reference's ``_gather_shrink`` itself, under ``jax.vmap`` with a named
    axis in place of a mesh;
  * the sharded engine at P 4 (as test_sharded_stats_engine_parity_and_bound):
    its merged sketches within the FD bound of the exact (1/P) sum_i G_i
    G_i^T stream with beta2, and against the reference fold of the
    reference's own ``fd_update_batched`` on the same scaled local
    gradients, refresh by refresh;
  * rank 0 on a group of one: the sharded engine and trainer are the
    replicated ones, bit for bit;
  * the reduced trainer at P 4 (as test_sharded_trainer_end_to_end): its
    losses within ``0.15 |b| + 0.05`` of the port's replicated run;
  * every rank ends every scenario with the same bits.

Sketches are compared by covariance, ladder and rho, never by eigenvectors
(the butterfly's merges are rank-deficient: rank 1 a rank, rank 4 after
two rounds, at ell 6), with ``assert_close_scaled`` (rtol 1e-4, 1e-5 of the
largest magnitude; rho against its ladder's).  The int8 wire is held to the
same tolerance: both packages round the same f32 factors to nearest, so
their int8 grids agree wherever a factor entry lies clear of a rounding
boundary, as every one of these does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as ranks_lib
import torch_ranks
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.core import fd as jfd
from repro.distributed import reduce as jreduce
from repro.distributed import sketch_merge as jwire

LIMIT_S = 120
P = ranks_lib.WORLD


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the 4 ranks saved, by rank."""
    out = tmp_path_factory.mktemp("ranks")
    procs = torch_ranks.start_ranks(ranks_lib.__file__, [], P, out)
    torch_ranks.wait_all(procs, out, LIMIT_S)
    return torch_ranks.load_ranks(out, P)


def _cov(U, s):
    U, s = np.asarray(U, np.float64), np.asarray(s, np.float64)
    return np.einsum("...de,...e,...fe->...df", U, s, U)


def _ladder(state) -> float:
    return max(float(np.abs(np.asarray(state[1])).max()),
               float(np.abs(np.asarray(state[2])).max()))


def _assert_same_sketch(got, want):
    """Port sketch ``got`` (U, s, rho tensors) against reference ``want``."""
    U, s, rho = (x.numpy() for x in got)
    assert_close_scaled(_cov(U, s), _cov(want[0], want[1]))
    assert_close_scaled(s, want[1])
    assert_close_scaled(rho, want[2], scale=_ladder(want))


def _same_bits(results: list) -> None:
    """Every rank's result the same bits as rank 0's."""
    flat = lambda x: [x] if isinstance(x, torch.Tensor) else (
        [t for v in x.values() for t in flat(v)] if isinstance(x, dict)
        else [t for v in x for t in flat(v)]
        if isinstance(x, (list, tuple)) else [torch.tensor(x)])
    first = flat(results[0])
    for other in map(flat, results[1:]):
        assert len(other) == len(first)
        assert all(torch.equal(a, b) for a, b in zip(first, other))


def _fold(states, wire: str, ell: int):
    """The reference's butterfly, written as its fold: merge_wire of the
    packed pairs (0, 1) and (2, 3), then of the two results."""
    pack = lambda st: jwire.pack_wire(st, wire)
    merge = lambda a, b: jwire.merge_wire(pack(a), pack(b), ell=ell)
    return merge(merge(states[0], states[1]), merge(states[2], states[3]))


def _jax_locals(G):
    N, d, ell = (ranks_lib.SKETCH[k] for k in ("N", "d", "ell"))
    zero = jfd.FDState(jnp.zeros((N, d, ell)), jnp.zeros((N, ell)),
                       jnp.zeros((N,)))
    return [jfd.fd_update_batched(zero, jnp.asarray(g)) for g in G]


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_butterfly_p4_matches_the_reference_fold(ranks, wire):
    key = f"butterfly_{wire}"
    _same_bits([r[key] for r in ranks])
    want = _fold(_jax_locals(ranks_lib.butterfly_inputs()), wire,
                 ranks_lib.SKETCH["ell"])
    _assert_same_sketch(ranks[0][key], want)


def test_butterfly_p4_obeys_the_fd_bound(ranks):
    G = ranks_lib.butterfly_inputs()
    U, s, rho = (x.numpy().astype(np.float64) for x in
                 ranks[0]["butterfly_fp32"])
    for n in range(ranks_lib.SKETCH["N"]):
        exact = sum(np.outer(G[i, n, :, 0], G[i, n, :, 0]) for i in range(P))
        err = np.linalg.norm(exact - _cov(U[n], s[n]), 2)
        assert err <= rho[n] * (1 + 1e-4) + 1e-3, (n, err)
    s8 = ranks[0]["butterfly_int8"][1].numpy()
    assert np.abs(s8 - s).max() / (np.abs(s).max() + 1e-9) < 0.1


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_gather_merge_p3_matches_the_reference(ranks, wire):
    size = len(ranks_lib.GATHER_RANKS)
    key = f"gather_{wire}"
    _same_bits([ranks[r][key] for r in ranks_lib.GATHER_RANKS])
    assert all(key not in r for r in ranks[size:])
    states = _jax_locals(ranks_lib.gather_inputs())
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *states)
    merged = jax.vmap(lambda st: jreduce._gather_shrink(
        st, axis="data", axis_size=size, ell=ranks_lib.SKETCH["ell"],
        kernels=None, wire_dtype=wire), axis_name="data")(stacked)
    want = jax.tree.map(lambda x: x[0], merged)
    _assert_same_sketch(ranks[0][key], want)


def _engine_reference():
    """The reference's sharded refreshes of the engine scenario's (16, 16)
    block, written out: each refresh scales the merged state by 1/P,
    FD-updates it on each rank's gradient scaled by 1/sqrt(P) with the
    reference's ``fd_update_batched``, and folds the P sketches in rank
    order over the fp32 wire (left on G, right on G^T).  Also the exact
    (1/P) sum_i G_i G_i^T stream with beta2 of the left side."""
    x = ranks_lib.engine_inputs()
    d, ell, beta2 = (ranks_lib.ENGINE[k] for k in ("d", "rank", "beta2"))
    zero = jfd.FDState(jnp.zeros((1, d, ell)), jnp.zeros((1, ell)),
                       jnp.zeros((1,)))
    G = [jnp.asarray(g[None]) * P ** -0.5 for g in x["gw"]]
    sides = {"left": zero, "right": zero}
    exact = np.zeros((d, d))
    for _ in range(ranks_lib.ENGINE["steps"]):
        for side, factors in (("left", G), ("right", [jnp.swapaxes(g, 1, 2)
                                                       for g in G])):
            st = sides[side]
            scaled = jfd.FDState(st.eigvecs, st.eigvals / P, st.rho / P)
            sides[side] = _fold([jfd.fd_update_batched(scaled, f, beta2)
                                 for f in factors], "fp32", ell)
        exact = beta2 * exact + sum(g @ g.T for g in
                                    x["gw"].astype(np.float64)) / P
    return sides, exact


def test_sharded_engine_p4_matches_the_reference(ranks):
    _same_bits([r["engine"] for r in ranks])
    # handed only the local gradients, the engine forms their mean itself:
    # the same f32 all-reduce, the same bits
    _same_bits([r[key] for r in ranks for key in ("engine", "engine_no_ctx")])
    got = ranks[0]["engine"]
    sides, exact = _engine_reference()
    for side in ("left", "right"):
        _assert_same_sketch(got[side], sides[side])
    U, s, rho = (t.numpy().astype(np.float64) for t in got["left"])
    err = np.linalg.norm(exact - _cov(U[0], s[0]), 2)
    assert err <= rho[0] * (1 + 1e-3) + 1e-2, (err, rho[0])
    assert all(torch.isfinite(t).all() for t in got["dirs"])


def test_sharded_engine_modes_p4_stay_the_same_on_every_rank(ranks):
    """Staggered, async, int8 storage and a rho_greedy budget under
    "sharded": every rank's pools and directions the same bits, finite;
    each block's ladder zero past its active rank after the merge and
    reallocation, the ranks within [2, 4] summing to the budget's 12."""
    _same_bits([r["engine_modes"] for r in ranks])
    got = ranks[0]["engine_modes"]
    assert all(torch.isfinite(t.float()).all() for t in got["dirs"])
    pools = got["pools"]
    k = next(t for t in pools if t.dtype == torch.int32)
    assert int(k.sum()) == 12 and int(k.min()) >= 2 and int(k.max()) <= 4
    ladders = [t for t in pools if t.dtype == torch.float32 and t.ndim == 2]
    for s in ladders:
        cols = torch.arange(s.shape[1])[None, :]
        assert torch.all(s[cols >= k[:, None].long()] == 0)


def test_sharded_on_a_group_of_one_is_replicated_bit_for_bit(ranks):
    for scenario in ("one_engine", "one_trainer"):
        _same_bits([ranks[0][scenario], ranks[0][scenario + "_replicated"]])
    assert all("one_engine" not in r for r in ranks[1:])


def test_sharded_trainer_p4_tracks_replicated(ranks):
    _same_bits([r["trainer"] for r in ranks])
    got = ranks[0]["trainer"]["losses"]
    want = ranks_lib.train()["losses"]
    assert np.all(np.isfinite(got)), got
    for a, b in zip(got, want):
        assert abs(a - b) < 0.15 * abs(b) + 0.05, (got, want)
