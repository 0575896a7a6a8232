"""The port's pools and optimizer chain against the JAX package.

(a) ``pool.build_index`` over the full-width paper-lm-100m parameter shapes
equals JAX's: group keys, sizes, member leaves and offsets (shapes only).
(b) ``make_optimizer`` gives the same updates on the reduced model, update
for update, over six steps, at the launcher's options and at every other
value of an option the port accepts (the refresh schedules and modes and a
``rho_greedy`` rank budget among them).  Tolerance as in
tests/test_torch_fd.py (``rtol=1e-4``, ``atol=1e-5`` of the largest
magnitude); the largest difference measured was 1.1e-6 of it.
(c) ``second_moment_bytes`` equals JAX's, reduced and full width.
(d) Blocking, schedules and ``transform.chain`` match their references.
(e) Second-moment storage: bf16 gives the reference's bf16 updates on the
reduced model, update for update (``rtol`` one bf16 step, 2^-8, and
``atol`` 1e-3 of the largest magnitude; measured 3.2e-5 of it).  int8 on
the fused path ("auto" and "on") gives the reference's fused ("on") updates
on a toy tree of matrices at ``rtol = atol = 2e-3``, the tolerance the
reference holds its own backends to (tests/test_autotune.py:399), with the
stored int8 eigenvectors within one quantization step (column signs
aligned: ``eigh`` may flip them); measured 6.3e-5 absolute and 7.4e-4 of a
step.  int8 with the fused path off stays cosine-aligned (> 0.999) with the
reference's "off" (the stored eigenvectors are rounded stochastically, with
different draws).  The toy tree has no vector leaf (its diagonal
accumulator would be rounded stochastically) and no block of rank below the
sketch's: there ``rho`` is ``eigh`` noise and the block's direction int8
rounding noise (ROADMAP.md queue 3), which differs between the packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.core import blocking as jblocking
from repro.core import factory as jfactory
from repro.core import pool as jpool
from repro.core import quantize as jquantize
from repro.core import schedules as jschedules
from repro.core import transform as jtransform
from repro.core.sketchy import RankBudget as JRankBudget
from repro.core.sketchy import SketchyConfig as JSketchyConfig
from repro.core.sketchy import sketchy as jsketchy
from repro.models import model as jmodel
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.core import api as tapi
from repro_torch.core import blocking as tblocking
from repro_torch.core import factory as tfactory
from repro_torch.core import pool as tpool
from repro_torch.core import quantize as tquantize
from repro_torch.core import schedules as tschedules
from repro_torch.core import transform as ttransform
from repro_torch.core.sketchy import RankBudget
from repro_torch.core.sketchy import SketchyConfig as TSketchyConfig
from repro_torch.core.sketchy import sketchy as tsketchy
from repro_torch.models import model as tmodel


def _jax_shapes(cfg):
    return [tuple(s) for s in jax.tree.leaves(
        jmodel.param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple))]


def test_build_index_full_width_matches_jax():
    cfg_j = jregistry.get_config("paper-lm-100m")
    cfg_t = tregistry.get_config("paper-lm-100m")
    shapes_t = [tuple(s) for s in tree.flatten(tmodel.param_shapes(cfg_t))]
    assert shapes_t == _jax_shapes(cfg_j)
    ij = jpool.build_index(tuple(shapes_t), 1024)
    it = tpool.build_index(tuple(shapes_t), 1024)
    assert [(g.key, g.bs_m, g.bs_n, g.num_blocks, g.leaf_ids)
            for g in it.groups] == \
        [(g.key, g.bs_m, g.bs_n, g.num_blocks, g.leaf_ids) for g in ij.groups]
    assert [(p.group, p.offset, p.info.num_blocks) for p in it.leaves] == \
        [(p.group, p.offset, p.info.num_blocks) for p in ij.leaves]
    assert {g.key: g.num_blocks for g in it.groups} == {
        "1024x768": 68, "12x768": 2, "768x1024": 104, "768x768": 48}


OPT = dict(name="sketchy", learning_rate=3e-3, total_steps=20, rank=4,
           block_size=32, update_every=2, weight_decay=1e-4)


def _updates_match_jax(opt: dict, **tol) -> None:
    """Six updates of both factories' chains on the reduced model, from the
    same weights and gradients, compared update for update
    (``assert_close_scaled`` with ``tol``)."""
    cfg = jregistry.get_reduced("paper-lm-100m")
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tree.flatten(jax.tree.map(
        lambda x: torch.from_numpy(np.array(x)), jparams))
    budget = opt.get("rank_budget")      # a dict: each package's RankBudget
    jtx = jfactory.make_optimizer(jfactory.OptimizerConfig(**dict(
        opt, rank_budget=budget and JRankBudget(**budget))))
    ttx = tfactory.make_optimizer(tfactory.OptimizerConfig(**dict(
        opt, rank_budget=budget and RankBudget(**budget))))
    js, ts = jtx.init(jparams), ttx.init(tparams)
    jupdate = jax.jit(jtx.update)
    rng = np.random.default_rng(0)
    for step in range(6):                 # refreshes at steps 0, 2 and 4
        grads = [rng.normal(size=p.shape).astype(np.float32) * 0.05
                 for p in tparams]
        ju, js = jupdate(
            jax.tree.unflatten(jax.tree.structure(jparams),
                               [jnp.asarray(g) for g in grads]),
            js, jparams)
        tu, ts = ttx.update([torch.from_numpy(g) for g in grads], ts, tparams)
        for got, want in zip(tu, jax.tree.leaves(ju)):
            assert_close_scaled(got.numpy(), want, **tol)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tparams = [p + u for p, u in zip(tparams, tu)]


def test_make_optimizer_matches_jax_update_for_update():
    _updates_match_jax(OPT)


@pytest.mark.parametrize("options", [
    # no clip stage, no weight-decay stage, constant lr
    dict(grad_clip=None, weight_decay=0.0, schedule="constant"),
    # grafted (unpreconditioned) directions for the first 3 steps, a longer
    # warmup and other EMA decays
    dict(start_preconditioning_step=3, warmup_frac=0.3, beta1=0.5,
         beta2=0.99, grad_clip=0.5),
    # the refresh schedules and modes (refreshes at steps 0 and 3, the
    # staggered blocks each at its phase) and a rho_greedy budget of half
    # the reduced model's capacity (144 blocks at rank 4), reallocated at
    # step 3
    dict(update_every=3, refresh_schedule="staggered"),
    dict(update_every=3, refresh_mode="async"),
    dict(update_every=3, refresh_schedule="staggered", refresh_mode="async"),
    dict(update_every=3, rank_budget=dict(total=288, min_k=1, max_k=4,
                                          policy="rho_greedy"))])
def test_make_optimizer_options_match_jax(options):
    """Every other OptimizerConfig field the port accepts, against JAX."""
    _updates_match_jax(dict(OPT, **options))


@pytest.mark.parametrize("reduced", [True, False])
def test_second_moment_bytes_matches_jax(reduced):
    get_j = jregistry.get_reduced if reduced else jregistry.get_config
    get_t = tregistry.get_reduced if reduced else tregistry.get_config
    opt = dict(OPT, rank=4, block_size=32) if reduced \
        else dict(OPT, rank=64, block_size=1024)
    cfg_j = get_j("paper-lm-100m")
    structs = jmodel.param_struct(cfg_j)
    jstate = jax.eval_shape(
        jfactory.make_optimizer(jfactory.OptimizerConfig(**opt)).init,
        structs)
    # meta tensors: shapes and dtypes without allocation
    tparams = [torch.empty(s, device="meta") for s in tree.flatten(
        tmodel.param_shapes(get_t("paper-lm-100m")))]
    tstate = tfactory.make_optimizer(
        tfactory.OptimizerConfig(**opt)).init(tparams)
    assert tapi.second_moment_bytes(tstate) == \
        japi.second_moment_bytes(jstate) > 0


@pytest.mark.parametrize("shape", [(), (1,), (5,), (70,), (1, 5), (12, 768),
                                   (70, 30), (3, 40, 24), (2, 3, 33, 65)])
@pytest.mark.parametrize("columns", [False, True])
def test_blocking_matches_jax(shape, columns):
    """analyze_leaf and the to_blocks/from_blocks round trip (block 32)."""
    want = jblocking.analyze_leaf(shape, 32, vectors_as_columns=columns)
    got = tblocking.analyze_leaf(shape, 32, vectors_as_columns=columns)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if got.kind == "matrix" and len(shape) >= 2:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        tb = tblocking.to_blocks(torch.from_numpy(x), got)
        np.testing.assert_array_equal(
            tb.numpy(), np.asarray(jblocking.to_blocks(jnp.asarray(x), want)))
        np.testing.assert_array_equal(
            tblocking.from_blocks(tb, got).numpy(), x)


def test_schedules_match_jax():
    pairs = [(jschedules.warmup_cosine(3e-3, 12, 0.05),
              tschedules.warmup_cosine(3e-3, 12, 0.05)),
             (jschedules.warmup_cosine(1e-2, 200, 0.1, end_value=1e-4),
              tschedules.warmup_cosine(1e-2, 200, 0.1, end_value=1e-4)),
             (jschedules.constant(3e-4), tschedules.constant(3e-4))]
    for want, got in pairs:
        for count in (0, 1, 2, 5, 11, 12, 19, 20, 150, 250):
            assert got(count).dtype == torch.float32
            np.testing.assert_allclose(float(got(count)),
                                       float(want(jnp.asarray(count))),
                                       rtol=1e-6)


def test_chain_matches_jax():
    """clip -> momentum -> weight decay -> scale as a positional chain."""
    rng = np.random.default_rng(3)
    params = [rng.normal(size=s).astype(np.float32) for s in [(4, 3), (5,)]]
    jtx = jtransform.chain(jtransform.clip_by_global_norm(0.5),
                           jtransform.momentum(0.9),
                           jtransform.add_decayed_weights(1e-2),
                           jtransform.scale(-0.1))
    ttx = ttransform.chain(ttransform.clip_by_global_norm(0.5),
                           ttransform.momentum(0.9),
                           ttransform.add_decayed_weights(1e-2),
                           ttransform.scale(-0.1))
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        g = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        ju, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        tu, ts = ttx.update([torch.from_numpy(x) for x in g], ts, tp)
        for got, want in zip(tu, ju):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_bf16_storage_matches_jax_update_for_update():
    _updates_match_jax(dict(OPT, second_moment_dtype="bf16"),
                       rtol=2.0 ** -8, atol_frac=1e-3)


TOY_SHAPES = {"m": (64, 24), "w": (48, 20), "w2": (48, 20)}


def _toy_engines(jepilogue: str, tepilogue: str, steps: int = 5):
    """Both packages' Sketchy engines with int8 storage on a tree of
    matrices (rank 8, block 32, a refresh every 2 steps): the updates of
    ``steps`` steps and the final states."""
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in TOY_SHAPES.items()}
    keys = sorted(params)
    jtx = jsketchy(JSketchyConfig(
        rank_budget=JRankBudget(min_k=8, max_k=8, policy="static"),
        block_size=32, update_every=2,
        second_moment_dtype="int8", quantized_epilogue=jepilogue))
    ttx = tsketchy(TSketchyConfig(
        rank_budget=RankBudget(max_k=8), block_size=32, update_every=2,
        second_moment_dtype="int8", quantized_epilogue=tepilogue))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k]) for k in keys]
    js, ts = jtx.init(jp), ttx.init(tp)
    updates = []
    for t in range(steps):
        r = np.random.default_rng(100 + t)
        g = {k: r.normal(size=s).astype(np.float32)
             for k, s in sorted(TOY_SHAPES.items())}
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        tu, ts = ttx.update([torch.from_numpy(g[k]) for k in keys], ts, tp)
        updates.append([(got.numpy(), np.asarray(ju[k]))
                        for k, got in zip(keys, tu)])
    return updates, js, ts


@pytest.mark.parametrize("epilogue", ["auto", "on"])
def test_fused_int8_engine_matches_jax(epilogue):
    updates, js, ts = _toy_engines("on", epilogue)
    for step in updates:
        for got, want in step:
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert list(ts.pools) == list(js.pools)
    for key in ts.pools:
        for side in ("left", "right"):
            tu = getattr(ts.pools[key], side).eigvecs
            ju = getattr(js.pools[key], side).eigvecs
            assert isinstance(tu, tquantize.QuantizedPool)
            assert tu.values.dtype == torch.int8
            got = tquantize.dequantize_stack(*tu).numpy()
            want = np.asarray(jquantize.dequantize_stack(
                japi.untag(ju.values), japi.untag(ju.scale)))
            step = np.maximum(tu.scale.numpy(),
                              np.asarray(japi.untag(ju.scale)))
            sign = np.where((got * want).sum(axis=1, keepdims=True) < 0,
                            -1.0, 1.0)
            assert (np.abs(got * sign - want) <= step).all()


def test_int8_off_tracks_jax_off():
    updates, _, ts = _toy_engines("off", "off")
    for t, step in enumerate(updates):
        for got, want in step:
            got, want = got.ravel(), want.ravel()
            cos = np.dot(got, want) / (np.linalg.norm(got)
                                       * np.linalg.norm(want) + 1e-30)
            assert cos > 0.999, (t, cos)
    pools = next(iter(ts.pools.values()))
    assert isinstance(pools.left.eigvecs, tquantize.QuantizedPool)


def test_int8_path_hands_the_kernels_row_major_tensors(monkeypatch):
    """The card's kernels read their inputs row-major and raise otherwise;
    on the CPU, hold every tensor the int8 path hands an entry of the kernel
    set to that (eigh returns column-major eigenvectors)."""
    from repro_torch.kernels import registry as tregistry
    seen = []

    def route(t, on_card, on_cpu):
        def checked(*args):
            seen.append(on_card.__name__)
            for x in args:
                assert x.is_contiguous(), (on_card.__name__, x.stride())
            return on_cpu(*args)
        return checked

    monkeypatch.setattr(tregistry, "_route", route)
    _toy_engines("on", "auto", steps=3)
    assert {"batched_gram_mixed", "batched_project_quantize",
            "_fold_quantized_apply"} <= set(seen)


@pytest.mark.parametrize("field,value", [("second_moment_dtype", "int4"),
                                         ("quantized_epilogue", "maybe")])
def test_engine_config_rejects_unknown_storage(field, value):
    with pytest.raises(ValueError, match=field):
        tapi.EngineConfig(**{field: value})
    with pytest.raises(ValueError, match=field):
        japi.EngineConfig(**{field: value})
