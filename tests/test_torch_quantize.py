"""The port's quantized storage (repro_torch/core/quantize.py) against the
JAX package's (repro/core/quantize.py).

(a) Rounding to nearest (no key): ``quantize_stack``, ``dequantize_stack``
and ``quantize_like`` give JAX's int8 values and scales bit for bit (both
divide in IEEE f32 and round half to even).  (b) ``requantize_pool`` of an
unchanged dequantized stack is a fixed point, and an already-quantized
stack passes through it.  (c) Stochastic rounding cannot give
``jax.random``'s bits, so it is held as ``tests/test_quantize.py`` holds
JAX's: every value within one scale step of its input, and unbiased (the
mean over many keys within 6 standard errors of the input per element, and
the mean error over all elements within 4).  (d) ``second_moment_bytes``
equals JAX's for fp32, bf16 and int8 storage, reduced and full width.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.core import api as japi
from repro.core import factory as jfactory
from repro.core import quantize as jquantize
from repro.models import model as jmodel
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.core import api as tapi
from repro_torch.core import factory as tfactory
from repro_torch.core import quantize as tquantize
from repro_torch.core.fd import FDState
from repro_torch.core.sketchy import SketchyBlockStats
from repro_torch.models import model as tmodel

SHAPES = [(1, 1, 1), (3, 20, 6), (4, 64, 16), (2, 12, 12), (5, 7, 33)]


def _stack(shape, log_scale, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x *= np.float32(2.0 ** log_scale)
    if shape[0] > 1:
        x[0] = 0.0                      # an all-zero block: scale 1
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("log_scale", [-20, 0, 9])
def test_quantize_stack_bitwise_matches_jax(shape, log_scale):
    x = _stack(shape, log_scale, seed=sum(shape) + 100 + log_scale)
    want = jquantize.quantize_stack(jnp.asarray(x))
    got = tquantize.quantize_stack(torch.from_numpy(x))
    assert got.values.dtype == torch.int8 and got.scale.shape == \
        (shape[0], 1, 1)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        tquantize.dequantize_stack(got.values, got.scale).numpy(),
        np.asarray(jquantize.dequantize_stack(want.values, want.scale)))


def test_round_half_to_even_matches_jax():
    """Scaled values on the .5 boundaries round to even in both packages."""
    x = np.array([[[127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -127.0]]],
                 np.float32)
    want = jquantize.quantize_stack(jnp.asarray(x))
    got = tquantize.quantize_stack(torch.from_numpy(x))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.values.tolist() == [[[127, 0, 2, 2, -2, 0, 126, -127]]]


@pytest.mark.parametrize("shape", [(10,), (1, 5), (12, 768), (3, 4, 5)])
def test_quantize_like_whole_leaf_matches_jax(shape):
    """The diagonal-fallback layout: one scale of shape (1,) * ndim."""
    x = np.abs(_stack(shape, -3, seed=len(shape)))
    scale_shape = (1,) * len(shape)
    want = jquantize.quantize_like(jnp.asarray(x), scale_shape)
    got = tquantize.quantize_like(torch.from_numpy(x), scale_shape)
    assert tuple(got.scale.shape) == scale_shape
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def _pool_stats(seed):
    rng = np.random.default_rng(seed)
    side = lambda d, ell: FDState(
        eigvecs=torch.from_numpy(rng.normal(size=(3, d, ell)).astype(
            np.float32)),
        eigvals=torch.from_numpy(rng.random((3, ell)).astype(np.float32)),
        rho=torch.from_numpy(rng.random(3).astype(np.float32)))
    return SketchyBlockStats(left=side(16, 8), right=side(20, 8))


def test_requantize_pool_is_idempotent_and_passes_quantized_through():
    stored = tquantize.quantize_pool(_pool_stats(0), "int8")
    left = stored.left
    assert isinstance(left.eigvecs, tquantize.QuantizedPool)
    assert left.eigvals.dtype == torch.float32        # ladder stays f32
    again = tquantize.requantize_pool(stored,
                                      tquantize.dequantize_pool(stored))
    for x, y in zip(tapi._leaves(again), tapi._leaves(stored)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the fused path's write-back arrives quantized and is kept as it is
    view = tquantize.compute_view(stored)
    assert view.left.eigvecs is stored.left.eigvecs
    kept = tquantize.requantize_pool(stored, view, key=(1, 2))
    assert kept.right.eigvecs is stored.right.eigvecs


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_leaves_that_are_no_second_moment_keep_their_dtype(storage):
    """The rank budget's int32 active ranks (a field outside the stats
    NamedTuple's ``second_moments``) pass the storage boundary as they are,
    as the reference passes leaves of other roles (repro/core/quantize.py
    :195-210); the sketches take the storage's layout."""
    from repro_torch.core.sketchy import BudgetedSketchStats
    pair = _pool_stats(0)
    k = torch.tensor([3, 1, 4], dtype=torch.int32)
    stats = BudgetedSketchStats(left=pair.left, right=pair.right, k=k)
    stored = tquantize.quantize_pool(stats, storage)
    assert stored.k is k
    for view in (tquantize.dequantize_pool(stored),
                 tquantize.compute_view(stored)):
        assert view.k.dtype == torch.int32 and torch.equal(view.k, k)
        assert view.left.eigvals.dtype == torch.float32
    back = tquantize.requantize_pool(
        stored, tquantize.dequantize_pool(stored), key=(1, 2))
    assert back.k.dtype == torch.int32 and torch.equal(back.k, k)
    ids = lambda ts: [id(t) for t in ts]
    assert ids(tquantize.second_moment_tensors(back)) == ids(
        tquantize.second_moment_tensors(back.left)
        + tquantize.second_moment_tensors(back.right))


def test_stochastic_rounding_within_one_step_and_unbiased():
    x = _stack((2, 32, 16), 0, seed=5)
    xt = torch.from_numpy(x)
    draws = 400
    total = np.zeros_like(x, np.float64)
    scale = None
    for k in range(draws):
        qp = tquantize.quantize_stack(xt, key=(7, k))
        back = tquantize.dequantize_stack(qp.values, qp.scale).numpy()
        scale = qp.scale.numpy()
        assert (np.abs(back - x) <= scale * (1 + 1e-6)).all()
        total += back
    # each draw's error is uniform-like with std <= scale / 2
    stderr = 0.5 * scale / np.sqrt(draws)
    err = total / draws - x
    assert (np.abs(err) <= 6 * stderr).all()
    assert abs(err.mean()) <= 4 * float(stderr.max()) / np.sqrt(err[1].size)
    # the same key gives the same draw; another key another one
    a = tquantize.quantize_stack(xt, key=(7, 0)).values
    b = tquantize.quantize_stack(xt, key=(7, 0)).values
    c = tquantize.quantize_stack(xt, key=(7, 1)).values
    assert torch.equal(a, b) and not torch.equal(a, c)


FULL_WIDTH_BYTES = {"fp32": 98_292_176, "bf16": 49_146_088,
                    "int8": 24_661_092}


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("reduced", [True, False])
def test_second_moment_bytes_matches_jax_per_dtype(reduced, dtype):
    get_j = jregistry.get_reduced if reduced else jregistry.get_config
    get_t = tregistry.get_reduced if reduced else tregistry.get_config
    opt = dict(name="sketchy", second_moment_dtype=dtype,
               rank=4 if reduced else 64, block_size=32 if reduced else 1024)
    jstate = jax.eval_shape(
        jfactory.make_optimizer(jfactory.OptimizerConfig(**opt)).init,
        jmodel.param_struct(get_j("paper-lm-100m")))
    # meta tensors: shapes and dtypes without allocation
    tparams = [torch.empty(s, device="meta") for s in tree.flatten(
        tmodel.param_shapes(get_t("paper-lm-100m")))]
    tstate = tfactory.make_optimizer(
        tfactory.OptimizerConfig(**opt)).init(tparams)
    got = tapi.second_moment_bytes(tstate)
    assert got == japi.second_moment_bytes(jstate) > 0
    if not reduced:
        assert got == FULL_WIDTH_BYTES[dtype]
