"""The port's baselines, Adam and blocked Shampoo, against the JAX package
(repro/core/adam.py, repro/core/shampoo.py; not ``seed_shampoo``, whose own
JAX tests fail).

Shampoo's tolerance.  Its roots come from each package's LAPACK ``eigh``
of L + eps I (eps 1e-6), so an eigenvalue within f32 rounding of ``||L||``
of eps takes a different root in each: after the first step a block's L is
built from one gradient, rank-deficient for a non-square block (a (32, 24)
block's L has rank 24) and ill-conditioned for a square one, and the
steps that precondition with those roots differ by up to 3.1e-3 of the
largest magnitude on the toy tree at gradients of size 0.05 (3.6e-4 with
square blocks; 0.31 at gradients of size 1, where ``||L||``'s rounding
passes eps).  From the second root on (L from five gradients) the
difference is 2.0e-6 of it at most.  So:

(a) The direction transforms, update for update over 12 steps on a toy
tree of matrix and vector leaves.  Adam at ``rtol=1e-5`` (elementwise f32
in the same order; measured 1e-6).  Shampoo (roots at steps 0, 5 and 10,
gradients of size 0.05) at the Sketchy tolerance of tests/test_torch_fd.py,
``rtol=1e-4`` plus ``1e-5`` of the largest magnitude, except steps 0-4 at
``5e-3`` of it, on a tree of square blocks and on one of rank-deficient
ones.
(b) ``make_optimizer``'s chains for ``adam`` and ``shampoo`` on the reduced
model, 6 updates (Shampoo's roots at steps 0, 2, 4): fp32 at ``rtol=1e-4``
plus ``1e-5`` (Adam) or ``1e-4`` (Shampoo, measured 3.1e-5) of the largest
magnitude; bf16 storage at one bf16 step (``rtol=2^-8``, ``atol`` 1e-3 of
the largest magnitude; Shampoo measured 7.0e-4), as
tests/test_torch_engine.py holds Sketchy.  Adam takes no second-moment
storage option (its state is f32 in both).
(c) Shampoo with int8 storage of L and R: stochastic rounding draws
differently in the two packages, so each update stays cosine-aligned with
the reference's (> 0.995; measured 0.99875 at the first step with the
roots of int8 statistics, 0.9999 after) and the stored L and R within six
quantization steps of the reference's (one a stochastic requantization:
measured 3.08); the roots stay f32.
(d) ``second_moment_bytes`` equal to JAX's, computed from shapes (meta
tensors, ``jax.eval_shape``): the fig1 layer set of benchmarks/run.py
(50,331,648 B Adam, 100,663,296 B Shampoo) and full-width paper-lm-100m at
block 1024 (Adam 654,388,224; Shampoo fp32 1,358,434,432, bf16 679,217,216,
int8 339,610,388; Sketchy rank 64 unchanged at 98,292,176).
(e) ``transform.momentum`` on f32 and on bf16 parameters, against the
reference: f32 at ``rtol=1e-6``; a bf16 state at
``rtol=2^-7`` plus a bf16 step (2^-8) of the largest magnitude (the port
rounds each product of the EMA to bf16, XLA's fused CPU loop only the sum:
an entry that is a near-cancellation of two products differs by a bf16
step of the products; measured 4.9e-4 at a largest magnitude of 0.34).
(f) A reduced ``repro_torch.launch.train`` run with each optimizer gives
the loss curve of the reference's launch/train path from the same weights
(``rtol=1e-4``) and its final parameters at ``rtol=1e-3`` and ``atol``
1e-5 (Adam, as tests/test_torch_train.py; measured 1.3e-6) or 1e-4
(Shampoo; measured 6.0e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.core import factory as jfactory
from repro.core import quantize as jquantize
from repro.core import transform as jtransform
from repro.core.adam import AdamConfig as JAdamConfig
from repro.core.adam import adam as jadam
from repro.core.shampoo import ShampooConfig as JShampooConfig
from repro.core.shampoo import shampoo as jshampoo
from repro.models import model as jmodel
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.core import api as tapi
from repro_torch.core import factory as tfactory
from repro_torch.core import quantize as tquantize
from repro_torch.core import transform as ttransform
from repro_torch.core.adam import AdamConfig, adam
from repro_torch.core.shampoo import ShampooBlockStats, ShampooConfig, shampoo
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel

# matrix leaves in two pool groups (blocks (32, 24), (32, 20), (16, 20)) and
# vector leaves (Shampoo's diagonal fallback)
TOY_SHAPES = {"a_m": (64, 24), "b_w": (48, 20), "c_w2": (48, 20),
              "d_bias": (24,), "e_scale": (7,)}


def _toy(jtx, ttx, steps: int, scale: float, shapes: dict = TOY_SHAPES):
    """Both transforms over ``steps`` steps of the same numpy gradients (of
    size ``scale``) on a tree of ``shapes``: the (got, want) update pairs
    per step and the final states."""
    rng = np.random.default_rng(0)
    keys = sorted(shapes)
    params = {k: rng.normal(size=shapes[k]).astype(np.float32)
              for k in keys}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k]) for k in keys]
    js, ts = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    pairs = []
    for t in range(steps):
        r = np.random.default_rng(100 + t)
        g = {k: (r.normal(size=shapes[k]) * scale).astype(np.float32)
             for k in keys}
        ju, js = jupdate({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = ttx.update([torch.from_numpy(g[k]) for k in keys], ts, tp)
        pairs.append([(got.numpy(), np.asarray(ju[k]))
                      for k, got in zip(keys, tu)])
    return pairs, js, ts


def test_adam_matches_jax_update_for_update():
    pairs, js, ts = _toy(jadam(JAdamConfig()), adam(AdamConfig()), 12, 1.0)
    for step in pairs:
        for got, want in step:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert ts.pools == {} and ts.count == 12


# every block square, so L and R have full rank from the first step
SQUARE_SHAPES = {"a_m": (64, 32), "b_w": (32, 32), "c_w2": (32, 64),
                 "d_bias": (24,), "e_scale": (7,)}


@pytest.mark.parametrize("shapes", ["square", "rank_deficient"])
def test_shampoo_matches_jax_update_for_update(shapes):
    """Roots at steps 0, 5 and 10, gradients of size 0.05; the steps that
    precondition with the roots of the one-gradient step-0 statistics (0-4)
    at 5e-3 of the largest magnitude, the others at the Sketchy tolerance
    (the module docstring)."""
    cfg = dict(block_size=32, root_every=5)
    pairs, js, ts = _toy(
        jshampoo(JShampooConfig(**cfg)), shampoo(ShampooConfig(**cfg)), 12,
        0.05, SQUARE_SHAPES if shapes == "square" else TOY_SHAPES)
    for t, step in enumerate(pairs):
        tol = dict(atol_frac=5e-3) if t < 5 else {}
        for got, want in step:
            assert_close_scaled(got, want, **tol)
    assert list(ts.pools) == list(js.pools)
    for key, stats in ts.pools.items():
        for field in ("L", "R"):
            assert_close_scaled(getattr(stats, field).numpy(),
                                japi.untag(getattr(js.pools[key], field)))


def test_shampoo_engine_runs_update_stats_every_step(monkeypatch):
    """L and R accumulate on every step, the roots only at the refresh."""
    from repro_torch.core import shampoo as shampoo_lib
    calls = []
    monkeypatch.setattr(shampoo_lib, "_inv_root",
                        lambda m, eps, p: calls.append("root") or
                        torch.eye(m.shape[-1]).expand_as(m).clone())
    tx = shampoo(ShampooConfig(block_size=32, root_every=3))
    params = [torch.zeros(32, 16)]
    state = tx.init(params)
    Ls = []
    for t in range(4):
        _, state = tx.update([torch.ones(32, 16)], state, params)
        Ls.append(float(state.pools["32x16"].L[0, 0, 0]))
    # two roots (L and R) at steps 0 and 3; L[0, 0] = sum_t 0.999^t * 16
    assert calls == ["root"] * 4
    np.testing.assert_allclose(Ls, [16 * sum(0.999 ** i for i in range(t + 1))
                                    for t in range(4)], rtol=1e-6)


OPT = dict(learning_rate=3e-3, total_steps=20, rank=4, block_size=32,
           update_every=2, weight_decay=1e-4)


@pytest.mark.parametrize("name", ["adam", "shampoo"])
@pytest.mark.parametrize("storage", ["fp32", "bf16"])
def test_make_optimizer_matches_jax(name, storage):
    tol = dict(rtol=2.0 ** -8, atol_frac=1e-3) if storage == "bf16" \
        else dict(atol_frac=1e-4) if name == "shampoo" else {}
    opt = dict(OPT, name=name, second_moment_dtype=storage)
    cfg = jregistry.get_reduced("paper-lm-100m")
    jparams = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tparams = tree.flatten(jax.tree.map(
        lambda x: torch.from_numpy(np.array(x)), jparams))
    jtx = jfactory.make_optimizer(jfactory.OptimizerConfig(**opt))
    ttx = tfactory.make_optimizer(tfactory.OptimizerConfig(**opt))
    js, ts = jtx.init(jparams), ttx.init(tparams)
    assert list(ts.inner) == list(js.inner)     # the chains' stages
    jupdate = jax.jit(jtx.update)
    rng = np.random.default_rng(0)
    for step in range(6):
        grads = [rng.normal(size=p.shape).astype(np.float32) * 0.05
                 for p in tparams]
        ju, js = jupdate(jax.tree.unflatten(
            jax.tree.structure(jparams), [jnp.asarray(g) for g in grads]),
            js, jparams)
        tu, ts = ttx.update([torch.from_numpy(g) for g in grads], ts, tparams)
        for got, want in zip(tu, jax.tree.leaves(ju)):
            assert_close_scaled(got.numpy(), want, **tol)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        tparams = [p + u for p, u in zip(tparams, tu)]


def test_shampoo_int8_tracks_jax():
    cfg = dict(block_size=32, root_every=2, second_moment_dtype="int8")
    # matrices only: a vector leaf's diagonal accumulator would be rounded
    # stochastically too
    shapes = {k: s for k, s in TOY_SHAPES.items() if len(s) == 2}
    pairs, js, ts = _toy(jshampoo(JShampooConfig(**cfg)),
                         shampoo(ShampooConfig(**cfg)), 6, 0.3, shapes)
    for step in pairs:
        for got, want in step:
            cos = np.dot(got.ravel(), want.ravel()) / (
                np.linalg.norm(got) * np.linalg.norm(want))
            assert cos > 0.995, cos
    for key, stats in ts.pools.items():
        assert isinstance(stats, ShampooBlockStats)
        assert stats.PL.dtype == stats.PR.dtype == torch.float32
        for field in ("L", "R"):
            got, jgot = getattr(stats, field), getattr(js.pools[key], field)
            assert isinstance(got, tquantize.QuantizedPool)
            assert got.values.dtype == torch.int8
            want = np.asarray(jquantize.dequantize_stack(
                japi.untag(jgot.values), japi.untag(jgot.scale)))
            step = np.maximum(got.scale.numpy(),
                              np.asarray(japi.untag(jgot.scale)))
            # each of the 6 stochastic requantizations moves an entry by
            # under one step, in each package
            assert (np.abs(tquantize.dequantize_stack(*got).numpy() - want)
                    <= 6 * step).all()


def test_shampoo_int8_takes_the_dequantized_path(monkeypatch):
    """Shampoo declares no quantized compute, so under int8 storage its
    methods get f32 tensors whatever ``quantized_epilogue`` says (a
    ``QuantizedPool`` would break its root solve)."""
    from repro_torch.core import shampoo as shampoo_lib
    seen = []
    inner = shampoo_lib.ShampooPreconditioner.update_stats_batched

    def spy(self, state, G):
        seen.append(type(state.L))
        return inner(self, state, G)

    monkeypatch.setattr(shampoo_lib.ShampooPreconditioner,
                        "update_stats_batched", spy)
    tx = shampoo(ShampooConfig(block_size=32, second_moment_dtype="int8"))
    params = [torch.zeros(32, 16)]
    state = tx.init(params)
    tx.update([torch.randn(32, 16)], state, params)
    assert seen == [torch.Tensor]


FIG1 = {"attn_o": (1024, 1024), "attn_qkv": (1024, 3072),
        "ffn_in": (1024, 4096), "ffn_out": (4096, 1024)}


@pytest.mark.parametrize("name,want", [("adam", 50_331_648),
                                       ("shampoo", 100_663_296)])
def test_second_moment_bytes_fig1_matches_jax(name, want):
    """benchmarks/run.py::bench_fig1_memory's layer set and transforms."""
    jtx = jadam(JAdamConfig()) if name == "adam" \
        else jshampoo(JShampooConfig(block_size=1024))
    ttx = adam(AdamConfig()) if name == "adam" \
        else shampoo(ShampooConfig(block_size=1024))
    jstate = jax.eval_shape(jtx.init, {k: jax.ShapeDtypeStruct(s, jnp.float32)
                                       for k, s in FIG1.items()})
    tstate = ttx.init([torch.empty(FIG1[k], device="meta")
                       for k in sorted(FIG1)])
    assert tapi.second_moment_bytes(tstate) == \
        japi.second_moment_bytes(jstate) == want


@pytest.mark.parametrize("name,storage,want", [
    ("adam", "fp32", 654_388_224),
    ("shampoo", "fp32", 1_358_434_432),
    ("shampoo", "bf16", 679_217_216),
    ("shampoo", "int8", 339_610_388),
    ("sketchy", "fp32", 98_292_176)])
def test_second_moment_bytes_full_width_matches_jax(name, storage, want):
    opt = dict(OPT, name=name, rank=64, block_size=1024,
               second_moment_dtype=storage)
    jstate = jax.eval_shape(
        jfactory.make_optimizer(jfactory.OptimizerConfig(**opt)).init,
        jmodel.param_struct(jregistry.get_config("paper-lm-100m")))
    tparams = [torch.empty(s, device="meta") for s in tree.flatten(
        tmodel.param_shapes(tregistry.get_config("paper-lm-100m")))]
    tstate = tfactory.make_optimizer(
        tfactory.OptimizerConfig(**opt)).init(tparams)
    assert tapi.second_moment_bytes(tstate) == \
        japi.second_moment_bytes(jstate) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_momentum_matches_jax(dtype):
    """The EMA momentum on parameters of ``dtype``: a bf16 state takes the
    Python scalars as JAX's weak type does, rounded to bf16."""
    rng = np.random.default_rng(5)
    params = [rng.normal(size=s).astype(np.float32) for s in [(4, 3), (5,)]]
    jtx, ttx = jtransform.momentum(0.9), ttransform.momentum(0.9)
    jp = [jnp.asarray(p, getattr(jnp, dtype)) for p in params]
    tp = [torch.from_numpy(p).to(getattr(torch, dtype)) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(4):
        g = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        ju, js = jtx.update([jnp.asarray(x, getattr(jnp, dtype)) for x in g],
                            js, jp)
        tu, ts = ttx.update([torch.from_numpy(x).to(getattr(torch, dtype))
                             for x in g], ts, tp)
        for got, want, m in zip(tu, ju, ts.momentum):
            assert m.dtype == got.dtype == getattr(torch, dtype)
            if dtype == "bfloat16":
                assert_close_scaled(got.float().numpy(),
                                    np.asarray(want, np.float32),
                                    rtol=2.0 ** -7, atol_frac=2.0 ** -8)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["sketchy", "shampoo", "adam"])
def test_optimizer_config_takes_every_optimizer(name):
    assert tfactory.OptimizerConfig(name=name).name == name
    assert name in tlaunch.parse_args(["--optimizer", name]).optimizer
    with pytest.raises(ValueError, match="unknown optimizer"):
        tfactory.OptimizerConfig(name="lion")


@pytest.mark.parametrize("name", ["adam", "shampoo"])
def test_reduced_training_matches_jax(name):
    from test_torch_train import ARGV, _jax_run
    args = tlaunch.parse_args(ARGV + ["--optimizer", name])
    init, jlosses, jfinal = _jax_run(args)
    cfg = tregistry.get_reduced(args.arch)
    run, log = tlaunch.train(args,
                             params=convert.params_from_numpy(cfg, init))
    np.testing.assert_allclose([r["loss"] for r in log], jlosses, rtol=1e-4)
    atol = 1e-4 if name == "shampoo" else 1e-5
    for got, want in zip(tree.flatten(run.params), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3,
                                   atol=atol)
