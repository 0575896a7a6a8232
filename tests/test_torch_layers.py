"""The port's bf16 activations against the reference's jitted graph, bit
for bit on the CPU: ``layers.silu`` and ``layers.gelu_tanh`` against
``jax.jit(jax.nn.silu)`` and ``jax.jit(jax.nn.gelu(approximate=True))``
(XLA rounds every op of them to bf16, the GELU's constants too; ``F.silu``
and ``F.gelu`` differ in the last bit on about two inputs in five),
``gated_mlp`` (SwiGLU and GeGLU) against ``repro.models.layers.gated_mlp``,
and gemma's embedding scale (sqrt(d_model) rounded to bf16 first).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel


def _both(shape, seed, scale=3.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _bits(j, t):
    np.testing.assert_array_equal(np.asarray(jnp.asarray(j, jnp.float32)),
                                  t.float().numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_activations_match_jitted_jax_bit_for_bit(seed):
    xj, xt = _both((8192,), seed)
    _bits(jax.jit(jax.nn.silu)(xj), tlayers.silu(xt))
    _bits(jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(xj),
          tlayers.gelu_tanh(xt))
    # the one-rounding versions would not pass
    assert not torch.equal(torch.nn.functional.silu(xt), tlayers.silu(xt))


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_bf16_gated_mlp_matches_jitted_jax_bit_for_bit(act):
    cfg_j = dataclasses.replace(jregistry.get_reduced("paper-lm-100m"),
                                dtype="bfloat16", mlp_act=act)
    cfg_t = dataclasses.replace(tregistry.get_reduced("paper-lm-100m"),
                                dtype="bfloat16", mlp_act=act)
    D, F = cfg_t.d_model, cfg_t.d_ff
    xj, xt = _both((2, 8, D), 3, 1.0)
    pj, pt = {}, {}
    for i, (name, shape) in enumerate((("w_gate", (D, F)), ("w_up", (D, F)),
                                       ("w_down", (F, D)))):
        pj[name], pt[name] = _both(shape, 10 + i, D ** -0.5)
    _bits(jax.jit(lambda p, x: jlayers.gated_mlp(cfg_j, p, x))(pj, xj),
          tlayers.gated_mlp(cfg_t, pt, xt))


def test_bf16_embed_scale_matches_jax_bit_for_bit():
    cfg_j = dataclasses.replace(jregistry.get_reduced("gemma-2b"),
                                dtype="bfloat16")
    cfg_t = dataclasses.replace(tregistry.get_reduced("gemma-2b"),
                                dtype="bfloat16")
    ej, et = _both((cfg_t.vocab_size, cfg_t.d_model), 5, 1.0)
    toks = np.random.default_rng(6).integers(0, cfg_t.vocab_size, (2, 9))
    _bits(jax.jit(lambda e, t: jmodel.embed_tokens(
        cfg_j, {"embed": e}, {"tokens": t}))(ej, jnp.asarray(toks)),
        tmodel.embed_tokens(cfg_t, {"embed": et},
                            {"tokens": torch.from_numpy(toks)}))
