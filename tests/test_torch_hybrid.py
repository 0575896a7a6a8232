"""The port's ssm (mamba2-370m) and hybrid (zamba2-7b) families against
repro/models/model.py and repro/models/cache.py, reduced, in f32, from the
reference's weights (``convert.params_from_numpy``):

(a) logits and loss, with and without per-layer recomputation;
(b) every gradient, the tied ``embed`` among them (what the serving
    adapter differentiates: it flows back through every layer, the SSD
    scan's and the attention's ``autograd.Function``s included);
(c) decode steps with per-lane positions against the reference's
    ``decode_step``, and the port's decode against its own forward;
(d) cache shapes and dtypes (the SSM state in f32), and ``reset_lanes``
    wiping every layout;
(e) a reused engine lane leaks no SSM or conv state (mirrors
    tests/test_serve.py::test_slot_reuse_wipes_ssm_state).

Tolerances in f32: logits, loss and decode ``rtol = 1e-4, atol = 1e-4``;
gradients ``rtol = 1e-4`` plus 1e-4 of each leaf's largest magnitude
(``torch_parity.assert_close_scaled``).  Both packages run the SSD scan and
the dt path in f32 whatever the model dtype, so neither is exact: on the
reduced zamba2-7b with the weights of (a), the reference's own f32 logits
are 4.1e-5 from its float64 run and the port's 1.0e-5 (magnitude 2.3),
and the two packages' gradients differ by up to 6.1e-5 of a leaf's
largest magnitude beyond ``rtol`` (1.3e-6 on mamba2-370m; the dense
model's, with the same attention gradient, within tests/test_torch_model's
1e-6).  Greedy tokens are compared exactly.
"""
import dataclasses

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
from repro_torch import convert, serve as tserve, tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel

ARCHS = ["mamba2-370m", "zamba2-7b"]
MAX_SEQ = 24


def _models(arch, remat=False, seed=0):
    jcfg = dataclasses.replace(jregistry.get_reduced(arch), remat=remat)
    tcfg = dataclasses.replace(tregistry.get_reduced(arch), remat=remat)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.params_from_numpy(tcfg,
                                        jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _batch(cfg, seq=20, seed=2):
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=3, seed=seed)).batch(0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_logits_and_grads_match_jax(arch, remat):
    jcfg, jparams, tcfg, tparams = _models(arch, remat, seed=1)
    assert "lm_head" not in tparams
    batch = _batch(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}

    jlogits = jmodel.forward(jcfg, jparams, jbatch)
    tlogits = tmodel.forward(tcfg, tparams, tbatch)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, jbatch))(jparams)
    leaves = tree.flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tloss = tmodel.loss_fn(tcfg, tparams, tbatch)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(tgrads)
    for got, want in zip(tgrads, jleaves):
        assert got.shape == want.shape
        assert_close_scaled(got.numpy(), want, rtol=1e-4, atol_frac=1e-4)
    assert float(np.abs(np.asarray(jgrads["embed"])).max()) > 0


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ["paper-lm-100m"] + ARCHS)
def test_config_properties_match_jax(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    jcfg = getattr(jregistry, get)(arch)
    tcfg = getattr(tregistry, get)(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.block_pattern() == jcfg.block_pattern()
    assert tcfg.shared_attn_layers() == jcfg.shared_attn_layers()
    assert (tcfg.is_attention_free, tcfg.d_inner, tcfg.ssm_heads) == \
        (jcfg.is_attention_free, jcfg.d_inner, jcfg.ssm_heads)


def test_cache_shapes_and_dtypes_match_jax(models):
    jcfg, _, tcfg, _ = models
    jc = jcache.init_cache(jcfg, 3, MAX_SEQ)
    tc = tcache.init_cache(tcfg, 3, MAX_SEQ)
    assert tcache.cache_shapes(tcfg, 3, MAX_SEQ) == \
        jcache.cache_shapes(jcfg, 3, MAX_SEQ)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tc.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()}
    assert tc["ssm"].dtype == torch.float32
    if tcfg.family == "hybrid":
        assert tc["k"].shape[0] == len(tcfg.shared_attn_layers()) == 2


def test_decode_steps_match_jax_and_reset_lanes(models):
    jcfg, jparams, tcfg, tparams = models
    B = 3
    jc = jcache.init_cache(jcfg, B, MAX_SEQ)
    tc = tcache.init_cache(tcfg, B, MAX_SEQ)
    rng = np.random.default_rng(1)
    offsets = np.array([0, 3, 1])
    step = jax.jit(lambda p, c, t, pos: jcache.decode_step(
        jcfg, p, c, {"token": t}, pos))
    for t in range(7):
        if t == 4:       # wipe lane 1 and restart it at position 0
            mask = np.array([False, True, False])
            jc = jcache.reset_lanes(jc, jnp.asarray(mask))
            tc = tcache.reset_lanes(tc, torch.from_numpy(mask))
            for k in tc:
                np.testing.assert_array_equal(tc[k][:, 1].numpy(), 0.0)
            offsets[1] = -t
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


def test_decode_matches_forward(models):
    _, _, tcfg, tparams = models
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, tcfg.vocab_size, size=(2, 10)))
    want = tmodel.forward(tcfg, tparams, {"tokens": toks})
    cache = tcache.init_cache(tcfg, 2, 16)
    for t in range(toks.shape[1]):
        got, cache = tcache.decode_step(tcfg, tparams, cache,
                                        {"token": toks[:, t:t + 1]}, t)
        torch.testing.assert_close(got[:, 0], want[:, t], rtol=1e-4,
                                   atol=1e-4)


def test_slot_reuse_wipes_ssm_state(models):
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(3)
    p0, p1 = (rng.integers(0, tcfg.vocab_size, size=(n,), dtype=np.int32)
              for n in (6, 4))
    eng = tserve.Engine(tcfg, tparams, tserve.ServeConfig(batch=1,
                                                          max_seq=MAX_SEQ))
    eng.submit(tserve.Request(p0, max_new_tokens=4))
    eng.drain()
    h1 = eng.submit(tserve.Request(p1, max_new_tokens=5))
    eng.drain()
    fresh = tserve.Engine(tcfg, tparams, tserve.ServeConfig(batch=1,
                                                            max_seq=MAX_SEQ))
    ref = fresh.submit(tserve.Request(p1, max_new_tokens=5))
    fresh.drain()
    assert h1.tokens == ref.tokens
