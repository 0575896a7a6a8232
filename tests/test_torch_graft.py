"""The engine's grafting variants and the diagonal fallback's damping
against the reference (repro/core/api.py ``graft_direction`` :480,
``diag_eps`` :581, :898; repro/core/factory.py :64, :98, :111).

On a small tree of two matrices (blocked at 16) and two vectors (the
diagonal fallback), the same numpy gradients go through both packages'
Sketchy transforms for six steps (refreshes at steps 0, 2 and 4) with
``graft`` each of "rmsprop_normalized", "rmsprop" and "none" and
``diag_eps`` None or 1e-3, and through both factories' chains with
``OptimizerConfig(diag_eps=...)``.  Every direction (Shampoo's: of its
vectors, which ``diag_eps`` damps; its matrix roots of one-gradient
statistics carry ``eigh`` noise, held at looser tolerances by
tests/test_torch_optimizers.py) is held to the
reference's at the engine tests' f32 tolerance (tests/test_torch_engine.py:
``rtol`` 1e-4, ``atol`` 1e-5 of the largest magnitude).  A vector's
direction with ``diag_eps`` 1e-3 must differ from the default's: the
damping reaches the fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.core import factory as jfactory
from repro.core.sketchy import RankBudget as JRankBudget
from repro.core.sketchy import SketchyConfig as JSketchyConfig
from repro.core.sketchy import sketchy as jsketchy
from repro_torch.core import api as tapi
from repro_torch.core import factory as tfactory
from repro_torch.core.sketchy import RankBudget, SketchyConfig, sketchy

SHAPES = [(40, 24), (24,), (16, 16), (7,)]
STEPS = 6


def _gradients(seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * 0.05).astype(np.float32) for s in SHAPES]
            for _ in range(STEPS)]


def _run(jtx, ttx) -> list:
    """Both transforms over the same gradients; each step's directions
    (reference, port) as numpy, every leaf."""
    params = [np.zeros(s, np.float32) for s in SHAPES]
    js = jtx.init([jnp.asarray(p) for p in params])
    ts = ttx.init([torch.from_numpy(p) for p in params])
    jupdate = jax.jit(jtx.update)
    out = []
    for grads in _gradients():
        ju, js = jupdate([jnp.asarray(g) for g in grads], js,
                         [jnp.asarray(p) for p in params])
        tu, ts = ttx.update([torch.from_numpy(g) for g in grads], ts,
                            [torch.from_numpy(p) for p in params])
        out.append([(np.asarray(j), t.numpy()) for j, t in zip(ju, tu)])
    return out


def _engine(graft: str, diag_eps):
    kw = dict(block_size=16, update_every=2, graft=graft, diag_eps=diag_eps)
    jtx = jsketchy(JSketchyConfig(
        rank_budget=JRankBudget(min_k=4, max_k=4, policy="static"), **kw))
    ttx = sketchy(SketchyConfig(rank_budget=RankBudget(min_k=4, max_k=4),
                                **kw))
    return _run(jtx, ttx)


@pytest.mark.parametrize("diag_eps", [None, 1e-3])
@pytest.mark.parametrize("graft", ["rmsprop_normalized", "rmsprop", "none"])
def test_engine_grafting_matches_reference(graft, diag_eps):
    for step in _engine(graft, diag_eps):
        for want, got in step:
            assert_close_scaled(got, want)


def test_rmsprop_grafting_is_not_normalized():
    """The un-normalized direction's scale follows the gradient's, the
    normalized one's does not: their matrix directions differ."""
    a = _engine("rmsprop", None)[-1][0][1]
    b = _engine("rmsprop_normalized", None)[-1][0][1]
    assert not np.allclose(a, b, rtol=1e-2)


def test_diag_eps_reaches_the_fallback():
    default = _engine("rmsprop_normalized", None)
    damped = _engine("rmsprop_normalized", 1e-3)
    for i, shape in enumerate(SHAPES):
        same = np.array_equal(default[0][i][1], damped[0][i][1])
        assert same == (len(shape) == 2), shape


@pytest.mark.parametrize("name", ["sketchy", "shampoo"])
def test_factory_diag_eps_matches_reference(name):
    opt = dict(name=name, learning_rate=3e-3, total_steps=20, rank=4,
               block_size=16, update_every=2, diag_eps=1e-3)
    jtx = jfactory.make_optimizer(jfactory.OptimizerConfig(**opt))
    ttx = tfactory.make_optimizer(tfactory.OptimizerConfig(**opt))
    for step in _run(jtx, ttx):
        for (want, got), shape in zip(step, SHAPES):
            if name == "sketchy" or len(shape) == 1:
                assert_close_scaled(got, want)


def test_engine_config_refuses_an_unknown_graft():
    with pytest.raises(ValueError, match="graft"):
        tapi.EngineConfig(graft="adagrad")
