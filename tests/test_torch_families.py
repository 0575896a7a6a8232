"""The architectures of ROADMAP.md queue 1 items 13(a) and 13(b) against the
JAX package, reduced, in f32, from the reference's weights
(``convert.params_from_numpy``): the dense phi3-mini-3.8b, qwen2.5-32b
(``qkv_bias``), qwen3-32b (``qk_norm``) and gemma-2b (``embed_scale``, tied
embeddings, GeGLU, one KV head), and the moe deepseek-moe-16b and
kimi-k2-1t-a32b (a dense first layer, then moe layers).

(a) The configs field for field, their block pattern and parameter counts,
    and the parameter tree's shapes; the tree crosses the packages and
    back bit for bit.
(b) Loss and every gradient against ``repro.models.model.loss_fn``.
(c) Decode: the port's ``decode_step`` with per-lane positions against
    ``repro.models.cache.decode_step`` (logits and caches), and the port's
    teacher-forced decode against its own forward (as
    tests/test_models.py:72 holds the reference).
(d) The vlm and audio architectures still raise, naming items 13(c) and
    13(d).

tests/test_torch_families_step.py holds one Sketchy step of each and a
moe checkpoint across the packages.  Tolerances in f32: logits, loss and
decode ``rtol=1e-4, atol=1e-4`` (sums in another order); gradients
``rtol=1e-4`` plus 1e-5 of each leaf's largest magnitude
(``torch_parity``); the reduced configs' capacity factor of 8.0 drops no
token, so decode equals the forward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel

ARCHS = ["phi3-mini-3.8b", "qwen2.5-32b", "qwen3-32b", "gemma-2b",
         "deepseek-moe-16b", "kimi-k2-1t-a32b"]
MAX_SEQ = 16


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    cfg = jregistry.get_reduced(arch)
    return jax.jit(lambda key: jmodel.init_params(cfg, key))(
        jax.random.PRNGKey(1))


def _models(arch):
    """(jcfg, jax params, tcfg, fresh port params from the same weights)."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    jparams = _jax_params(arch)
    return jcfg, jparams, tcfg, convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams))


def _batch(cfg, seq=12, seed=2):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=2, seed=seed)).batch(0)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_tree_match_jax(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    jcfg = getattr(jregistry, get)(arch)
    tcfg = getattr(tregistry, get)(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.block_pattern() == jcfg.block_pattern()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    want = jmodel.param_shapes(jcfg)
    got = tmodel.param_shapes(tcfg)
    assert tree.structure(got) == jax.tree.map(
        lambda _: None, want, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s) for s in tree.flatten(got)] == \
        [tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, tuple))]
    if reduced:      # the tree crosses to the port and back bit for bit
        jparams = jax.tree.map(np.asarray, _jax_params(arch))
        back = [p.numpy() for p in tree.flatten(
            convert.params_from_numpy(tcfg, jparams))]
        for a, b in zip(back, jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_grads_match_jax(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    np.testing.assert_allclose(
        tmodel.forward(tcfg, tparams, tbatch).detach().numpy(),
        np.asarray(jax.jit(lambda p: jmodel.forward(jcfg, p, jbatch))(
            jparams)), rtol=1e-4, atol=1e-4)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jbatch)))(jparams)
    leaves = [p.requires_grad_(True) for p in tree.flatten(tparams)]
    tloss = tmodel.loss_fn(tcfg, tparams, tbatch)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for got, want in zip(tgrads, jleaves):
        assert got.shape == want.shape
        assert_close_scaled(got.numpy(), want, rtol=1e-4, atol_frac=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax_and_forward(arch):
    jcfg, jparams, tcfg, tparams = _models(arch)
    B = 3
    jc = jcache.init_cache(jcfg, B, MAX_SEQ)
    tc = tcache.init_cache(tcfg, B, MAX_SEQ)
    assert tcache.cache_shapes(tcfg, B, MAX_SEQ) == \
        jcache.cache_shapes(jcfg, B, MAX_SEQ)
    rng = np.random.default_rng(1)
    offsets = np.array([0, 3, 1])
    step = jax.jit(lambda p, c, t, pos: jcache.decode_step(
        jcfg, p, c, {"token": t}, pos))
    for t in range(5):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = (t + offsets).astype(np.int32)
        jl, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tcache.decode_step(tcfg, tparams, tc,
                                    {"token": torch.from_numpy(tok).long()},
                                    torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-4, atol=1e-4)

    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, size=(2, 10)))
    want = tmodel.forward(tcfg, tparams, {"tokens": toks})
    cache = tcache.init_cache(tcfg, 2, MAX_SEQ)
    for t in range(toks.shape[1]):
        got, cache = tcache.decode_step(tcfg, tparams, cache,
                                        {"token": toks[:, t:t + 1]}, t)
        torch.testing.assert_close(got[:, 0], want[:, t], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch,item", [("qwen2-vl-72b", r"13\(c\)"),
                                       ("musicgen-large", r"13\(d\)")])
def test_vlm_and_audio_still_raise(arch, item):
    for get in (tregistry.get_config, tregistry.get_reduced):
        with pytest.raises(NotImplementedError, match=item):
            get(arch)
    with pytest.raises(NotImplementedError, match=item):
        tmodel.check_supported(jregistry.get_reduced(arch))
