"""The port's rank budget (core/sketchy.py ``RankBudget``, core/pool.py's
allocator, core/fd.py's masked ranks) against the JAX package.

(a) ``uniform_ranks`` and ``allocate_ranks`` equal the reference exactly,
ties included (a stable sort: ties break by block index).
(b) ``fd_resize_batched`` on f32 and int8 stacks: the reference's result,
``rho`` gains exactly the dropped eigenvalues (to f32 rounding of the
sum), the dropped columns are zero and the kept ones untouched, and growing
back to capacity changes nothing.
(c) The masked ``fd_update_batched`` (f32 and int8 eigenvectors) against
the reference's at the tolerance of tests/test_torch_fd.py (``rtol=1e-4``
plus ``1e-5`` of the largest magnitude; the covariance, never raw U, whose
column signs differ between LAPACKs); the int8 eigenvectors within one
quantization step of the reference's, column signs aligned; the columns
past each block's active rank exactly zero.
(d) A ``rho_greedy`` budget at full capacity (``min_k == max_k``) runs the
masked path with every column active: it is bitwise the static engine,
for both schedules, both modes and the three storages.
(e) The reference's ``rho_greedy`` migration case
(tests/test_rank_budget.py:185): two same-shape parameters, one fed noise
and one rank-1 gradients; the active ranks equal the reference's at every
step.  The noise block's updates and sketch match at the fp32 tolerance
(int8: ``rtol = atol = 2e-3``, as tests/test_torch_engine.py's fused
path; measured 8e-7 of the largest magnitude).  The rank-1 block keeps up
to 13 columns of ``eigh`` noise: its ``rho`` (3e-5 on a ladder of 58) and
its direction's component outside ``u v^T`` differ between the LAPACKs
(ROADMAP.md queue 3), so its updates are held cosine-aligned, > 0.999 in
fp32 (measured 0.9999994) and > 0.95 in int8, whose 8 rounded columns
read 0.9742 in the first window and > 0.9999 once the budget shrinks the
block to 2.  Both sketches' ``rho`` take the ladder's scale as slack.  The
test prints the smallest relative gap between two pressures the allocator
saw: a gap near f32 rounding could rank two blocks differently in the two
packages.
(f) ``rank_allocation`` equals the reference's; the Fig. 1 rows
``fig1_memory_sketchy_l256_async`` and ``..._rank_budget`` are 25,190,496
B in both packages; the launcher parses ``--rank-budget`` as the
reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_close_scaled, ladder,  # noqa: F401
                          torch_one_thread)

from repro.core import api as japi
from repro.core import fd as jfd
from repro.core import pool as jpool
from repro.core import quantize as jquantize
from repro.core.sketchy import RankBudget as JRankBudget
from repro.core.sketchy import SketchyConfig as JSketchyConfig
from repro.core.sketchy import sketchy as jsketchy
from repro_torch.core import api as tapi
from repro_torch.core import fd as tfd
from repro_torch.core import pool as tpool
from repro_torch.core import quantize as tquantize
from repro_torch.core.sketchy import RankBudget, SketchyConfig, sketchy


@pytest.mark.parametrize("n,total,min_k,max_k", [
    (1, 3, 1, 4), (3, 8, 1, 4), (7, 7, 1, 1), (10, 37, 2, 6),
    (144, 432, 2, 4)])
def test_uniform_ranks_match_jax(n, total, min_k, max_k):
    got = tpool.uniform_ranks(n, total, min_k, max_k)
    want = np.asarray(jpool.uniform_ranks(n, total, min_k, max_k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("ties", [False, True])
def test_allocate_ranks_match_jax(seed, ties):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    min_k = int(rng.integers(1, 5))
    max_k = min_k + int(rng.integers(0, 8))
    pressure = rng.random(n).astype(np.float32)
    if ties:            # a few distinct values, many blocks sharing each
        pressure = rng.choice(pressure[:3], size=n).astype(np.float32)
        pressure[rng.random(n) < 0.3] = 0.0
    total = int(rng.integers(n * min_k, n * max_k + 1))
    got = tpool.allocate_ranks(torch.from_numpy(pressure), total=total,
                               min_k=min_k, max_k=max_k)
    want = np.asarray(jpool.allocate_ranks(
        jnp.asarray(pressure), total=total, min_k=min_k, max_k=max_k))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == total


def _random_sketch(rng, n: int, d: int, ell: int):
    s = np.sort(rng.random((n, ell)).astype(np.float32), axis=-1)[:, ::-1]
    U = rng.normal(size=(n, d, ell)).astype(np.float32)
    rho = rng.random(n).astype(np.float32)
    return U, np.ascontiguousarray(s), rho


@pytest.mark.parametrize("quantized", [False, True])
def test_fd_resize_matches_jax(quantized):
    rng = np.random.default_rng(3)
    n, d, ell = 6, 11, 7
    U, s, rho = _random_sketch(rng, n, d, ell)
    new_k = rng.integers(1, ell + 1, size=n).astype(np.int32)
    new_k[0], new_k[1] = 1, ell
    if quantized:
        tq = tquantize.quantize_stack(torch.from_numpy(U))
        jU = jquantize.QuantizedPool(values=jnp.asarray(tq.values.numpy()),
                                     scale=jnp.asarray(tq.scale.numpy()))
        tU = tq
    else:
        jU, tU = jnp.asarray(U), torch.from_numpy(U)
    jout = jfd.fd_resize_batched(
        jfd.FDState(jU, jnp.asarray(s), jnp.asarray(rho)), jnp.asarray(new_k))
    tout = tfd.fd_resize_batched(
        tfd.FDState(tU, torch.from_numpy(s), torch.from_numpy(rho)),
        torch.from_numpy(new_k))
    np.testing.assert_array_equal(tout.eigvals.numpy(),
                                  np.asarray(jout.eigvals))
    np.testing.assert_allclose(tout.rho.numpy(), np.asarray(jout.rho),
                               rtol=1e-6)
    for b in range(n):
        k = int(new_k[b])
        np.testing.assert_allclose(float(tout.rho[b]),
                                   rho[b] + s[b, k:].sum(), rtol=1e-6,
                                   atol=1e-7)
    if quantized:
        assert torch.equal(tout.eigvecs.scale, tq.scale)
        np.testing.assert_array_equal(tout.eigvecs.values.numpy(),
                                      np.asarray(jout.eigvecs.values))
        vals = tout.eigvecs.values
    else:
        np.testing.assert_array_equal(tout.eigvecs.numpy(),
                                      np.asarray(jout.eigvecs))
        vals = tout.eigvecs
    for b in range(n):
        k = int(new_k[b])
        assert not vals[b, :, k:].any() and not tout.eigvals[b, k:].any()
        assert torch.equal(vals[b, :, :k], tU[0][b, :, :k] if quantized
                           else tU[b, :, :k])
    regrow = tfd.fd_resize_batched(tout, torch.full((n,), ell,
                                                    dtype=torch.int32))
    for x, y in zip(tquantize.second_moment_tensors(regrow),
                    tquantize.second_moment_tensors(tout)):
        assert torch.equal(x, y)


def _cov(U, s):
    U, s = np.asarray(U, np.float64), np.asarray(s, np.float64)
    return np.einsum("nde,ne,nfe->ndf", U, s, U)


@pytest.mark.parametrize("quantized", [False, True])
def test_masked_fd_update_matches_jax(quantized):
    """Four masked updates of a stack of 5 blocks (d 24, capacity 8, 5
    columns of new factor), the active ranks fixed, one at 1 and one at
    capacity."""
    rng = np.random.default_rng(7)
    n, d, ell, r = 5, 24, 8, 5
    k = np.array([1, 3, 8, 5, 6], np.int32)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape),
                      jfd.fd_init(d, ell))
    ts = tfd.fd_init(d, ell, num_blocks=n)
    if quantized:
        js = js._replace(eigvecs=jquantize.quantize_stack(js.eigvecs))
        ts = ts._replace(eigvecs=tquantize.quantize_stack(ts.eigvecs))
    for step in range(4):
        a = rng.normal(size=(n, d, r)).astype(np.float32) * (step + 1)
        js = jfd.fd_update_batched(js, jnp.asarray(a), 0.99,
                                   active_k=jnp.asarray(k))
        ts = tfd.fd_update_batched(ts, torch.from_numpy(a), 0.99,
                                   active_k=torch.from_numpy(k))
        assert_close_scaled(ts.eigvals.numpy(), js.eigvals)
        assert_close_scaled(ts.rho.numpy(), js.rho, scale=ladder(js))
        if quantized:
            got = tquantize.dequantize_stack(*ts.eigvecs).numpy()
            want = np.asarray(jquantize.dequantize_stack(
                js.eigvecs.values, js.eigvecs.scale))
            step_size = np.maximum(ts.eigvecs.scale.numpy(),
                                   np.asarray(js.eigvecs.scale))
            sign = np.where((got * want).sum(axis=1, keepdims=True) < 0,
                            -1.0, 1.0)
            assert (np.abs(got * sign - want) <= step_size).all()
            vals = ts.eigvecs.values
        else:
            got = ts.eigvecs.numpy()
            assert_close_scaled(_cov(got, ts.eigvals), _cov(js.eigvecs,
                                                            js.eigvals))
            vals = ts.eigvecs
        for b in range(n):
            assert not vals[b, :, k[b]:].any(), (step, b)
            assert not ts.eigvals[b, k[b]:].any(), (step, b)


def test_unmasked_update_ignores_a_full_mask():
    """``active_k`` at capacity gives the unmasked update's bits."""
    rng = np.random.default_rng(1)
    st = tfd.fd_init(16, 6, num_blocks=3)
    full = torch.full((3,), 6, dtype=torch.int32)
    a = torch.from_numpy(rng.normal(size=(3, 16, 4)).astype(np.float32))
    plain = tfd.fd_update_batched(st, a, 0.9)
    masked = tfd.fd_update_batched(st, a, 0.9, active_k=full)
    for x, y in zip(plain, masked):
        assert torch.equal(x, y)


PARAMS = {"v": (16, 8), "w": (32, 32)}


def _run(tx, steps: int):
    params = [torch.zeros(s) for _, s in sorted(PARAMS.items())]
    state, outs = tx.init(params), []
    for i in range(steps):
        r = np.random.default_rng(1000 + i)
        g = [torch.from_numpy(r.normal(size=s).astype(np.float32))
             for _, s in sorted(PARAMS.items())]
        u, state = tx.update(g, state, params)
        outs.append(u)
    return outs, state


@pytest.mark.parametrize("schedule", ["synchronized", "staggered"])
@pytest.mark.parametrize("mode", ["inline", "async"])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_budget_at_capacity_is_the_static_engine(schedule, mode, storage):
    common = dict(block_size=16, beta2=0.99, update_every=2,
                  refresh_schedule=schedule, refresh_mode=mode,
                  second_moment_dtype=storage)
    static = sketchy(SketchyConfig(rank_budget=RankBudget(min_k=4, max_k=4),
                                   **common))
    budgeted = sketchy(SketchyConfig(
        rank_budget=RankBudget(min_k=4, max_k=4, policy="rho_greedy"),
        **common))
    outs_s, st_s = _run(static, 7)
    outs_b, st_b = _run(budgeted, 7)
    for x, y in zip(outs_s, outs_b):
        for a, b in zip(x, y):
            assert torch.equal(a, b)
    for key in st_s.pools:
        for side in ("left", "right"):
            for a, b in zip(
                    tquantize.second_moment_tensors(
                        getattr(st_s.pools[key], side)),
                    tquantize.second_moment_tensors(
                        getattr(st_b.pools[key], side))):
                assert torch.equal(a, b)
        assert st_b.pools[key].k.dtype == torch.int32
    assert tapi.second_moment_bytes(st_s) == tapi.second_moment_bytes(st_b)


def _migration_grads(steps: int) -> list:
    """The reference test's gradients (tests/test_rank_budget.py:200), as
    numpy: "hi" full-spectrum noise, "lo" one rank-1 outer product."""
    key = jax.random.PRNGKey(0)
    u = jax.random.normal(jax.random.PRNGKey(7), (32,))
    v = jax.random.normal(jax.random.PRNGKey(8), (32,))
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append({"hi": np.array(jax.random.normal(sub, (32, 32))),
                    "lo": np.array(jnp.outer(u, v))})
    return out


@pytest.mark.parametrize("storage,mode", [("fp32", "inline"),
                                          ("int8", "inline"),
                                          ("fp32", "async")])
def test_rho_greedy_migration_matches_jax(storage, mode, monkeypatch):
    kw = dict(block_size=32, beta2=0.9, update_every=2,
              second_moment_dtype=storage, refresh_mode=mode)
    budget = dict(total=16, min_k=2, max_k=14, policy="rho_greedy",
                  realloc_every=1)
    jtx = jsketchy(JSketchyConfig(rank_budget=JRankBudget(**budget),
                                  quantized_epilogue="on", **kw))
    ttx = sketchy(SketchyConfig(rank_budget=RankBudget(**budget), **kw))
    seen = []
    allocate = tpool.allocate_ranks
    monkeypatch.setattr(tpool, "allocate_ranks", lambda p, **a: (
        seen.append(p.clone()), allocate(p, **a))[1])
    names = ("hi", "lo")
    jp = {n: jnp.zeros((32, 32)) for n in names}
    tp = [torch.zeros(32, 32) for _ in names]
    js, ts = jtx.init(jp), ttx.init(tp)
    for t, g in enumerate(_migration_grads(10)):
        ju, js = jtx.update({n: jnp.asarray(g[n]) for n in names}, js, jp)
        tu, ts = ttx.update([torch.from_numpy(g[n]) for n in names], ts, tp)
        jk = japi.rank_allocation(js)["groups"]["32x32"]["k"]
        tk = tapi.rank_allocation(ts)["groups"]["32x32"]["k"]
        np.testing.assert_array_equal(tk, jk, err_msg=f"step {t}")
        got, want = tu[0].numpy(), np.asarray(ju["hi"])
        if storage == "int8":
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        else:
            assert_close_scaled(got, want)
        got, want = tu[1].numpy().ravel(), np.asarray(ju["lo"]).ravel()
        cos = np.dot(got, want) / (np.linalg.norm(got) * np.linalg.norm(want))
        assert cos > (0.95 if storage == "int8" else 0.999), (t, cos)
    # the noise block's sketch, block 0, against the reference's
    for side in ("left", "right"):
        jside = getattr(js.pools["32x32"], side)
        tside = getattr(tapi.committed_pools(ts)["32x32"], side)
        assert_close_scaled(tside.eigvals[0].numpy(),
                            japi.untag(jside.eigvals)[0])
        assert_close_scaled(tside.rho.numpy(), japi.untag(jside.rho),
                            scale=float(np.abs(japi.untag(
                                jside.eigvals)).max()))
    k = tapi.rank_allocation(ts)["groups"]["32x32"]["k"]
    assert int(k.sum()) == 16 and k[0] > k[1] and k[0] >= 10 and k[1] <= 6
    assert len(seen) == 4                       # counts 2, 4, 6 and 8
    gaps = [float(np.min(np.diff(np.sort(p.numpy())))) / float(p.max())
            for p in seen]
    print(f"smallest relative pressure gap: {min(gaps):.3e}")
    assert min(gaps) > 1e-4


@pytest.mark.parametrize("policy", ["static", "rho_greedy"])
def test_rank_allocation_matches_jax(policy):
    kw = dict(block_size=16, update_every=2)
    budget = dict(min_k=2, max_k=6, policy=policy)
    jtx = jsketchy(JSketchyConfig(rank_budget=JRankBudget(**budget), **kw))
    ttx = sketchy(SketchyConfig(rank_budget=RankBudget(**budget), **kw))
    names = sorted(PARAMS)
    jp = {n: jnp.zeros(PARAMS[n]) for n in names}
    tp = [torch.zeros(PARAMS[n]) for n in names]
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(3):
        r = np.random.default_rng(1000 + i)
        g = {n: r.normal(size=PARAMS[n]).astype(np.float32) for n in names}
        _, js = jtx.update({n: jnp.asarray(x) for n, x in g.items()}, js, jp)
        _, ts = ttx.update([torch.from_numpy(g[n]) for n in names], ts, tp)
    want, got = japi.rank_allocation(js), tapi.rank_allocation(ts)
    assert got["total"] == want["total"]
    assert list(got["groups"]) == list(want["groups"])
    for key, w in want["groups"].items():
        np.testing.assert_array_equal(got["groups"][key]["k"], w["k"])
        np.testing.assert_allclose(got["groups"][key]["budget_share"],
                                   w["budget_share"], rtol=1e-12)
        assert_close_scaled(got["groups"][key]["rho"], w["rho"])


FIG1 = {"attn_o": (1024, 1024), "attn_qkv": (1024, 3072),
        "ffn_in": (1024, 4096), "ffn_out": (4096, 1024)}


@pytest.mark.parametrize("row", ["async", "rank_budget"])
def test_fig1_rows_match_jax(row):
    """benchmarks/run.py::bench_fig1_memory's rows
    ``fig1_memory_sketchy_l256_async`` and ``..._rank_budget``: equal to
    the static rank-256 row, the pending slot and the active ranks
    uncounted."""
    if row == "async":
        jb, tb = (dict(min_k=256, max_k=256), dict(refresh_mode="async"))
    else:
        jb, tb = (dict(min_k=64, max_k=256, policy="rho_greedy"), {})
    jstate = jax.eval_shape(jsketchy(JSketchyConfig(
        rank_budget=JRankBudget(**jb), block_size=1024, **tb)).init,
        {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in FIG1.items()})
    tstate = sketchy(SketchyConfig(
        rank_budget=RankBudget(**jb), block_size=1024, **tb)).init(
        [torch.empty(FIG1[k], device="meta") for k in sorted(FIG1)])
    assert tapi.second_moment_bytes(tstate) == \
        japi.second_moment_bytes(jstate) == 25_190_496
    assert tapi.rank_allocation(tstate)["total"] == \
        japi.rank_allocation(jstate)["total"]


def test_rank_budget_validation_matches_jax():
    for kw, match in ((dict(policy="bogus"), "policy"),
                      (dict(min_k=8, max_k=4), "min_k"),
                      (dict(realloc_every=0), "realloc_every")):
        for cls in (RankBudget, JRankBudget):
            with pytest.raises(ValueError, match=match):
                cls(**kw)
    for cls in (RankBudget, JRankBudget):
        b = cls(total=100, min_k=2, max_k=8)
        with pytest.raises(ValueError, match="infeasible"):
            b.resolve_total(4)
        assert b.resolve_total(20) == 100
        assert cls(min_k=2, max_k=8).resolve_total(5) == 40


def test_launcher_parses_the_rank_budget():
    """``--rank-budget`` as the reference's launcher reads it: key=value
    pairs of RankBudget's fields, ``every`` for ``realloc_every``; a bad
    key or an invalid budget stops the parse."""
    from repro_torch.launch import train
    args = train.parse_args(["--rank-budget",
                             "total=432,min_k=2,max_k=4,every=2,"
                             "policy=rho_greedy", "--refresh-mode", "async",
                             "--refresh-schedule", "staggered"])
    assert args.rank_budget == RankBudget(total=432, min_k=2, max_k=4,
                                          realloc_every=2,
                                          policy="rho_greedy")
    assert (args.refresh_mode, args.refresh_schedule) == ("async",
                                                          "staggered")
    assert train.parse_args([]).rank_budget is None
    for spec in ("realloc_every=2", "min_k=9,max_k=4", "policy=bogus"):
        with pytest.raises(SystemExit):
            train.parse_args(["--rank-budget", spec])
