"""The port's refresh schedules and modes (core/api.py) against the JAX
package and against themselves.

(a) Sketchy with ``refresh_schedule="staggered"`` and/or
``refresh_mode="async"`` gives the reference's updates, update for update,
over nine steps (refresh cadence 4) on a toy tree with two pool groups:
24 blocks of 16 x 16 and 3 of 12 x 16, so the second group has no due
block at every fourth count.  Tolerances of tests/test_torch_engine.py's
docstring: fp32 ``rtol=1e-4`` plus ``1e-5`` of the largest magnitude, bf16
``rtol=2^-8`` plus 1e-3 of it, int8 on the fused path ("on" and "auto"
against the reference's "on") ``rtol = atol = 2e-3``; the int8 tree has
no vector leaf (its diagonal accumulator is rounded stochastically, with
different draws in the two packages).
(b) Shampoo staggered and async against the reference, its roots every 5
steps on square blocks: the steps before every block's second root lands
(each block's phase, plus one under async) at 5e-3 of the largest
magnitude, the later ones at the fp32 tolerance
(tests/test_torch_optimizers.py's docstring says why).
(c) Within the port, bit for bit: ``committed_pools`` of the async engine
after each of 8 steps equals the inline engine's pools, with the same
per-leaf residue, for both schedules and the three storages, for a
``rho_greedy`` rank budget (the reallocation lands in the pending slot),
and for Shampoo; the async direction differs from the inline one at some
step (it is one refresh stale); the pending slot counts in no byte and
holds tensors of its own at init; the profiling spans change no bit.
(d) The staggered refresh: every stats leaf of a due block (int8 values
and scales, the active ranks) is the full refresh's, every other block's
is untouched, and a group launches only when a block is due; at full
width the schedule gives 78 launches of the Gram over 12 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.core.shampoo import ShampooConfig as JShampooConfig
from repro.core.shampoo import shampoo as jshampoo
from repro.core.sketchy import RankBudget as JRankBudget
from repro.core.sketchy import SketchyConfig as JSketchyConfig
from repro.core.sketchy import sketchy as jsketchy
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.core import api as tapi
from repro_torch.core import pool as tpool
from repro_torch.core import quantize as tquantize
from repro_torch.core.shampoo import ShampooConfig, shampoo
from repro_torch.core.sketchy import (RankBudget, SketchyConfig,
                                      SketchyPreconditioner, sketchy)
from repro_torch.models import model as tmodel

# two pool groups at block 16: "a" and "c" give 24 blocks of 16 x 16, "b"
# 3 of 12 x 16; "v" takes the diagonal fallback
SHAPES = {"a": (64, 48), "b": (12, 40), "c": (96, 32), "v": (10,)}
MATRIX_SHAPES = {k: s for k, s in SHAPES.items() if len(s) == 2}
COMMON = dict(block_size=16, beta2=0.95, update_every=4)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if x is None or isinstance(x, (bool, int)):
        return []
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _tensors(x[k])]
    return [t for item in x for t in _tensors(item)]


def _bitwise(a, b, msg: str) -> None:
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb), msg
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y), msg


def _grads(t: int, shapes: dict, scale: float = 1.0) -> dict:
    r = np.random.default_rng(100 + t)
    return {k: (r.normal(size=s) * scale).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _against_jax(jtx, ttx, shapes: dict, steps: int, scale: float = 1.0):
    """Both transforms over ``steps`` steps of the same numpy gradients:
    the (got, want) update pairs per step."""
    keys = sorted(shapes)
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=shapes[k]).astype(np.float32) for k in keys}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k]) for k in keys]
    js, ts = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    pairs = []
    for t in range(steps):
        g = _grads(t, shapes, scale)
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = ttx.update([torch.from_numpy(g[k]) for k in keys], ts, tp)
        pairs.append([(got.numpy(), np.asarray(ju[k]))
                      for k, got in zip(keys, tu)])
    return pairs, ts


SKETCHY_CASES = [
    # schedule, mode, storage, the port's quantized_epilogue
    ("staggered", "inline", "fp32", "auto"),
    ("synchronized", "async", "fp32", "auto"),
    ("staggered", "async", "fp32", "auto"),
    ("staggered", "async", "bf16", "auto"),
    ("staggered", "inline", "int8", "on"),
    ("staggered", "async", "int8", "auto"),
    ("synchronized", "async", "int8", "on")]


@pytest.mark.parametrize("schedule,mode,storage,epilogue", SKETCHY_CASES)
def test_sketchy_refresh_modes_match_jax(schedule, mode, storage, epilogue):
    kw = dict(COMMON, refresh_schedule=schedule, refresh_mode=mode,
              second_moment_dtype=storage)
    jtx = jsketchy(JSketchyConfig(
        rank_budget=JRankBudget(min_k=6, max_k=6, policy="static"),
        quantized_epilogue="on", **kw))
    ttx = sketchy(SketchyConfig(rank_budget=RankBudget(min_k=6, max_k=6),
                                quantized_epilogue=epilogue, **kw))
    shapes = MATRIX_SHAPES if storage == "int8" else SHAPES
    pairs, ts = _against_jax(jtx, ttx, shapes, 9)
    tol = {"fp32": {}, "bf16": dict(rtol=2.0 ** -8, atol_frac=1e-3)}
    for step in pairs:
        for got, want in step:
            if storage == "int8":
                np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
            else:
                assert_close_scaled(got, want, **tol[storage])
    assert (ts.pending is None) == (mode == "inline")


SQUARE_SHAPES = {"a_m": (64, 32), "b_w": (32, 32), "c_w2": (32, 64),
                 "d_bias": (24,)}


@pytest.mark.parametrize("schedule,mode", [("staggered", "inline"),
                                           ("synchronized", "async"),
                                           ("staggered", "async")])
def test_shampoo_refresh_modes_match_jax(schedule, mode):
    kw = dict(block_size=32, root_every=5, refresh_schedule=schedule,
              refresh_mode=mode)
    pairs, _ = _against_jax(jshampoo(JShampooConfig(**kw)),
                            shampoo(ShampooConfig(**kw)), SQUARE_SHAPES, 12,
                            0.05)
    # every block has its second root by step 5 (staggered phases 1-5; 5
    # synchronized), one step later under async
    settled = 5 + (mode == "async")
    for t, step in enumerate(pairs):
        tol = dict(atol_frac=5e-3) if t < settled else {}
        for got, want in step:
            assert_close_scaled(got, want, **tol)


def _pair(make, shapes: dict, steps: int = 8):
    """The inline and async transforms ``make(mode)`` over ``steps`` steps
    of the same gradients: per step the two directions and states."""
    keys = sorted(shapes)
    params = [torch.full(shapes[k], 0.1) for k in keys]
    txs = {mode: make(mode) for mode in ("inline", "async")}
    states = {mode: tx.init(params) for mode, tx in txs.items()}
    out = []
    for t in range(steps):
        g = [torch.from_numpy(x) for x in _grads(t, shapes, 0.5).values()]
        step = {}
        for mode, tx in txs.items():
            d, states[mode] = tx.update(g, states[mode], params)
            step[mode] = (d, states[mode])
        out.append(step)
    return out


def _assert_step_shifted(steps: list) -> None:
    for t, step in enumerate(steps):
        (_, s_i), (_, s_a) = step["inline"], step["async"]
        _bitwise(tapi.committed_pools(s_a), s_i.pools,
                 f"committed != inline at step {t}")
        _bitwise(s_a.leaves, s_i.leaves, f"leaf residue at step {t}")
        assert all(slot.valid for slot in s_a.pending.values()), t


@pytest.mark.parametrize("schedule", ["synchronized", "staggered"])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_async_committed_equals_inline_bitwise(schedule, storage):
    shapes = MATRIX_SHAPES if storage == "int8" else SHAPES
    _assert_step_shifted(_pair(lambda mode: sketchy(SketchyConfig(
        rank_budget=RankBudget(min_k=6, max_k=6), block_size=16, beta2=0.95,
        update_every=3, refresh_schedule=schedule, refresh_mode=mode,
        second_moment_dtype=storage)), shapes))


def test_async_committed_equals_inline_with_rank_budget():
    """The reallocation (steps 3 and 6) rides the refresh into the slot."""
    _assert_step_shifted(_pair(lambda mode: sketchy(SketchyConfig(
        rank_budget=RankBudget(min_k=2, max_k=6, total=100,
                               policy="rho_greedy"),
        block_size=16, beta2=0.95, update_every=3, refresh_mode=mode,
        refresh_schedule="staggered", second_moment_dtype="int8")),
        MATRIX_SHAPES))


@pytest.mark.parametrize("schedule", ["synchronized", "staggered"])
def test_async_shampoo_committed_equals_inline_bitwise(schedule):
    _assert_step_shifted(_pair(lambda mode: shampoo(ShampooConfig(
        block_size=16, beta2=0.95, root_every=3, refresh_schedule=schedule,
        refresh_mode=mode)), SHAPES, steps=7))


def test_async_direction_is_one_refresh_stale():
    """At a refresh step the async direction still comes from the stats
    before it (so differs from inline's); the first step's does not."""
    steps = _pair(lambda mode: sketchy(SketchyConfig(
        rank_budget=RankBudget(min_k=6, max_k=6), block_size=16,
        update_every=3, refresh_mode=mode)), SHAPES, steps=4)
    same = [all(torch.equal(x, y) for x, y in zip(step["inline"][0],
                                                  step["async"][0]))
            for step in steps]
    assert not all(same), "async directions never lagged inline"


def test_pending_slot_counts_no_byte_and_owns_its_tensors():
    params = [torch.zeros(s) for _, s in sorted(SHAPES.items())]
    for storage in ("fp32", "int8"):
        mk = lambda mode: sketchy(SketchyConfig(
            rank_budget=RankBudget(min_k=6, max_k=6), block_size=16,
            refresh_mode=mode, second_moment_dtype=storage))
        s_i, s_a = mk("inline").init(params), mk("async").init(params)
        assert tapi.second_moment_bytes(s_i) == \
            tapi.second_moment_bytes(s_a) > 0
        live = {t.data_ptr() for t in _tensors(s_a.pools)}
        slot = _tensors({k: s.stats for k, s in s_a.pending.items()})
        assert not live & {t.data_ptr() for t in slot}
        assert all(not t.any() for t in slot)
        assert not any(s.valid for s in s_a.pending.values())


@pytest.mark.parametrize("mode", ["inline", "async"])
def test_profile_annotations_change_no_bit(mode):
    def make(spans):
        return lambda m: sketchy(SketchyConfig(
            rank_budget=RankBudget(min_k=6, max_k=6), block_size=16,
            update_every=2, refresh_mode=mode, profile_annotations=spans))
    plain, spanned = _pair(make(False), SHAPES, 4), _pair(make(True),
                                                          SHAPES, 4)
    for a, b in zip(plain, spanned):
        _bitwise(a, b, f"annotations changed the {mode} run")


def test_profile_annotations_record_the_engine_spans():
    from torch.profiler import ProfilerActivity, profile
    params = [torch.zeros(s) for _, s in sorted(SHAPES.items())]
    tx = sketchy(SketchyConfig(
        rank_budget=RankBudget(min_k=6, max_k=6), block_size=16,
        update_every=2, refresh_mode="async", profile_annotations=True))
    state = tx.init(params)
    g = [torch.from_numpy(x) for x in _grads(0, SHAPES).values()]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tx.update(g, state, params)
    names = {e.key for e in prof.key_averages()}
    assert {"precond/commit", "precond/precondition",
            "precond/refresh_launch"} <= names


def _gram_sizes(monkeypatch) -> list:
    """Records the pool dim N of every batched (mixed) Gram the FD refresh
    calls, on the CPU."""
    from repro_torch.kernels import registry as kreg
    sizes = []

    def route(t, on_card, on_cpu):
        def record(*args):
            if on_card.__name__ in ("batched_gram", "batched_gram_mixed"):
                sizes.append(args[0].shape[0])
            return on_cpu(*args)
        return record

    monkeypatch.setattr(kreg, "_route", route)
    return sizes


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_staggered_refresh_touches_only_due_blocks(storage, monkeypatch):
    """One staggered step (count 5 of cadence 4: blocks 3, 7, ... of the
    16 x 16 group; none of the 12 x 16 group's 3) against the full
    refresh of the same budgeted stacks: the due blocks' leaves (int8
    values and scales, the active ranks) are the full refresh's, the
    others untouched."""
    budget = RankBudget(min_k=2, max_k=6, total=100, policy="rho_greedy")
    cfg = SketchyConfig(rank_budget=budget, block_size=16, beta2=0.95,
                        update_every=4, refresh_schedule="staggered",
                        second_moment_dtype=storage)
    tx = sketchy(cfg)
    params = [torch.zeros(s) for _, s in sorted(MATRIX_SHAPES.items())]
    state = tx.init(params)
    for t in range(5):
        g = [torch.from_numpy(x) for x in
             _grads(t, MATRIX_SHAPES).values()]
        _, state = tx.update(g, state, params)
    assert state.count == 5
    g = [torch.from_numpy(x) for x in _grads(5, MATRIX_SHAPES).values()]
    index = tpool.build_index(tuple(tuple(p.shape) for p in params), 16)
    packed = tpool.pack(index, g)
    sizes = _gram_sizes(monkeypatch)
    _, after = tx.update(g, state, params)
    due = {grp.key: tpool.due_blocks(grp, 5, 4) for grp in index.groups}
    assert due == {"12x16": [], "16x16": [3, 7, 11, 15, 19, 23]}
    assert sizes == [6, 6]                  # one group, both sides
    precond = SketchyPreconditioner(cfg)
    for grp in index.groups:
        before = state.pools[grp.key]
        full = precond.refresh_batched(tquantize.compute_view(before),
                                       packed[grp.key])
        got = after.pools[grp.key]
        for b in range(grp.num_blocks):
            want = full if b in due[grp.key] else before
            for x, y in zip(_tensors(got), _tensors(want)):
                assert torch.equal(x[b], y[b]), (grp.key, b)


def test_staggered_launches_at_full_width():
    """The staggered schedule's Gram launches over the 12-step main path
    (cadence 10) at full width: 8 at count 0 (4 groups, 2 sides), then 2
    for each group with a due block: 78.  Host arithmetic only."""
    cfg = tregistry.get_config("paper-lm-100m")
    shapes = tuple(tuple(s) for s in tree.flatten(tmodel.param_shapes(cfg)))
    index = tpool.build_index(shapes, 1024)
    launches = 2 * len(index.groups)
    for count in range(1, 12):
        launches += 2 * sum(bool(tpool.due_blocks(grp, count, 10))
                            for grp in index.groups)
    assert launches == 78
    small = [grp for grp in index.groups if grp.key == "12x768"][0]
    assert [c for c in range(1, 12) if tpool.due_blocks(small, c, 10)] == \
        [9, 10]


def test_due_blocks_cover_each_block_once_a_window():
    grp = tpool.PoolGroup(key="k", bs_m=1, bs_n=1, num_blocks=23,
                          leaf_ids=(0,))
    for k in (2, 3, 10, 30):
        seen = sorted(b for c in range(5, 5 + k)
                      for b in tpool.due_blocks(grp, c, k))
        assert seen == list(range(23))


def test_engine_config_takes_the_refresh_options():
    for kw in (dict(refresh_schedule="staggered"),
               dict(refresh_mode="async"), dict(realloc_every=1),
               dict(profile_annotations=True)):
        tapi.EngineConfig(**kw)
    tapi.EngineConfig(stats_reduction="sharded")
    with pytest.raises(ValueError, match="stats_wire_dtype"):
        SketchyConfig(stats_reduction="sharded", stats_wire_dtype="bogus")
    for field in ("refresh_schedule", "refresh_mode", "stats_reduction"):
        with pytest.raises(ValueError, match=field):
            tapi.EngineConfig(**{field: "bogus"})
    with pytest.raises(ValueError, match="realloc_every"):
        tapi.EngineConfig(realloc_every=-1)
