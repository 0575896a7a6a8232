"""The vlm and audio architectures (ROADMAP.md queue 1 items 13(c) and
13(d)) against the JAX package, reduced, in f32 unless stated, from the
reference's weights (``convert.params_from_numpy``;
tests/test_torch_families.py's ``_models``): qwen2-vl-72b
(precomputed embeddings in place of tokens, M-RoPE, QKV bias, an
``lm_head`` and no ``embed``) and musicgen-large (4 codebooks: ``embed``
(K, V, D), ``lm_head`` (K, D, V), tokens and labels (B, S, K)).

(a) The configs field for field, their parameter counts, and the parameter
    tree's shapes, full and reduced; the tree crosses the packages and back
    bit for bit.
(b) ``apply_rope`` with three different position streams against the
    reference's, in f32 and bf16 (bf16 bit for bit), and equal to plain
    RoPE when the streams coincide (qwen2-vl's head dim 128: sections 16,
    24, 24; the reduced 16: 2, 3, 3).
(c) Logits, loss and every gradient on the reference pipeline's batches,
    and for the vlm with explicit, distinct (3, B, S) positions; a dense
    forward with explicit positions (the forward used to ignore them).
(d) Decode with per-lane positions against ``repro.models.cache``'s
    (logits and caches), and the port's teacher-forced decode against its
    own forward.
(e) In bf16, the codebook embedding sum bit for bit against the jitted
    reference (each add rounds to bf16, as XLA's graph does) and the
    codebook head within one bf16 step of it (``_bf16_head_slack``).
(f) ``SyntheticLM`` with 4 codebooks and with embeddings, bit for bit the
    reference's at steps 0 and 1 (the embeddings table drawn in chunks of 7
    rows here, the same stream of normals), and the launcher moving
    ``embeds`` to the device as f32.
(g) Two steps of ``repro_torch.launch.train`` (Sketchy, rank 8, block 32,
    ``update_every`` 1: a refresh at each step; the warmup gives step 0 a
    learning rate of 0, so the second step is the first that moves the
    weights) against the reference launcher's path.

Tolerances as tests/test_torch_families.py states them: logits, loss and
decode ``rtol=1e-4, atol=1e-4``; gradients and parameters ``rtol=1e-4``
plus 1e-5 of each leaf's largest magnitude (``torch_parity``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _models
from torch_parity import (assert_close_scaled, chip_smoke,  # noqa: F401
                          torch_one_thread)

from repro.configs import registry as jregistry
from repro.core.factory import OptimizerConfig as JOptimizerConfig
from repro.core.factory import make_optimizer as jmake_optimizer
from repro.data import pipeline as jpipeline
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import cache as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel

ARCHS = ["qwen2-vl-72b", "musicgen-large"]
MAX_SEQ = 16


def _bf16_head_slack(got, want, scale):
    """How far over its tolerance the bf16 codebook head ``bsd,kdv->bskv``
    is against the jitted reference's (<= 0 passes).  Both sum the D exact
    products in f32 and round once, in other orders: an entry may round
    the other way, one bf16 step (2^-7 of the larger magnitude's power of
    two), and where the sum cancels the f32 sums differ by up to its unit
    roundoff 2^-24 of ``scale``, the sum of the products' magnitudes.
    Measured on 12 draws: 2-9 of 122,880 entries differ, three by more
    than a step, by at most 2^-26.4 of their scale."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    big = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-300))) - 7)
    return float(np.max(np.abs(got - want) - step - 2.0 ** -24 * scale))


def _data(cfg, seq, batch, seed, pipeline=jpipeline):
    """The reference launcher's data for ``cfg`` (repro/launch/train.py
    :122-127)."""
    return pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed, num_codebooks=cfg.num_codebooks,
        embed_dim=0 if cfg.embed_inputs else cfg.d_model))


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).float()
            if np.asarray(v).dtype.kind == "f"
            else torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _mrope_positions(rng, B, S):
    """Three different streams: time 0..S-1, and a height and a width
    that wander as an image patch grid's would."""
    t = np.tile(np.arange(S), (B, 1))
    h = rng.integers(0, 6, size=(B, S))
    w = rng.integers(0, 9, size=(B, S))
    return np.stack([t, h, w]).astype(np.int32)


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
    tmodel.check_supported(tcfg)
    want = jmodel.param_shapes(jcfg)
    got = tmodel.param_shapes(tcfg)
    assert tree.structure(got) == jax.tree.map(
        lambda _: None, want, is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s) for s in tree.flatten(got)] == \
        [tuple(s) for s in jax.tree.leaves(
            want, is_leaf=lambda x: isinstance(x, tuple))]
    assert ("embed" in got) == jcfg.embed_inputs
    if reduced:      # the tree crosses to the port and back bit for bit
        jparams = jax.tree.map(np.asarray, _models(arch)[1])
        back = [p.numpy() for p in tree.flatten(
            convert.params_from_numpy(tcfg, jparams))]
        for a, b in zip(back, jax.tree.leaves(jparams)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 128])
def test_mrope_matches_jax(hd, dtype):
    """Distinct streams against the reference (f32 ``rtol=1e-6``: the
    same f32 ops; bf16 bit for bit), and coinciding streams equal to
    plain RoPE bit for bit."""
    rng = np.random.default_rng(hd)
    B, S, H = 2, 11, 3
    x = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    pos = _mrope_positions(rng, B, S)
    xj = jnp.asarray(x, jnp.dtype(dtype))
    xt = torch.from_numpy(x).to(tmodel.DTYPES[dtype])
    want = np.asarray(jnp.asarray(jlayers.apply_rope(
        xj, jnp.asarray(pos), 1e6), jnp.float32))
    got = tlayers.apply_rope(xt, torch.from_numpy(pos).long(), 1e6)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the sections matter: the height and width streams move the result
    plain = tlayers.apply_rope(xt, torch.from_numpy(pos[0]).long(), 1e6)
    assert not torch.equal(got, plain)
    same = torch.from_numpy(np.broadcast_to(pos[:1], pos.shape).copy())
    torch.testing.assert_close(tlayers.apply_rope(xt, same.long(), 1e6),
                               plain, rtol=0, atol=0)


def _check_loss_and_grads(jcfg, jparams, tcfg, tparams, batch):
    jbatch, tbatch = _jax(batch), _torch(batch)
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
    return tloss


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_logits_and_grads_match_jax(arch):
    """On the reference pipeline's batch; the audio loss averages over B, S
    and the K codebooks (held against the mean of per-codebook losses)."""
    jcfg, jparams, tcfg, tparams = _models(arch)
    batch = _data(jcfg, 12, 2, 2).batch(0)
    assert ("embeds" in batch) == (arch == "qwen2-vl-72b")
    tloss = _check_loss_and_grads(jcfg, jparams, tcfg, tparams, batch)
    if tcfg.num_codebooks:
        with torch.no_grad():
            logits = tmodel.forward(tcfg, tparams, _torch(batch)).float()
        labels = torch.from_numpy(batch["labels"]).long()
        assert logits.shape == labels.shape + (tcfg.vocab_size,)
        per_codebook = [torch.nn.functional.cross_entropy(
            logits[:, :, i].reshape(-1, tcfg.vocab_size),
            labels[:, :, i].reshape(-1)) for i in range(tcfg.num_codebooks)]
        torch.testing.assert_close(tloss.detach(),
                                   torch.stack(per_codebook).mean(),
                                   rtol=1e-5, atol=1e-6)


def test_vlm_with_distinct_positions_matches_jax():
    jcfg, jparams, tcfg, tparams = _models("qwen2-vl-72b")
    batch = dict(_data(jcfg, 12, 2, 4).batch(0))
    batch["positions"] = _mrope_positions(np.random.default_rng(3), 2, 12)
    _check_loss_and_grads(jcfg, jparams, tcfg, tparams, batch)
    # and the positions reached the model
    with torch.no_grad():
        default = tmodel.forward(tcfg, tparams, _torch(
            {k: v for k, v in batch.items() if k != "positions"}))
        given = tmodel.forward(tcfg, tparams, _torch(batch))
    assert not torch.allclose(default, given, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["paper-lm-100m", "qwen2.5-32b"])
def test_forward_takes_explicit_positions(arch):
    """A dense forward with ``batch["positions"]`` (B, S) follows them, as
    the reference's does (repro/models/model.py:241-243)."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    jparams = jax.jit(lambda key: jmodel.init_params(jcfg, key))(
        jax.random.PRNGKey(2))
    tparams = convert.params_from_numpy(tcfg,
                                        jax.tree.map(np.asarray, jparams))
    batch = dict(_data(jcfg, 10, 2, 5).batch(0))
    batch["positions"] = np.array([np.arange(10) + 7,
                                   np.arange(10)[::-1] * 2], np.int32)
    want = np.asarray(jax.jit(lambda p, b: jmodel.forward(jcfg, p, b))(
        jparams, _jax(batch)))
    with torch.no_grad():
        got = tmodel.forward(tcfg, tparams, _torch(batch))
        default = tmodel.forward(tcfg, tparams, _torch(
            {k: v for k, v in batch.items() if k != "positions"}))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert not np.allclose(default.numpy(), want, rtol=1e-3, atol=1e-3)


def _decode_input(cfg, rng, B):
    if not cfg.embed_inputs:
        return "embed", (rng.normal(size=(B, 1, cfg.d_model)) * 0.1
                         ).astype(np.float32)
    shape = (B, 1, cfg.num_codebooks) if cfg.num_codebooks else (B, 1)
    return "token", rng.integers(0, cfg.vocab_size, size=shape
                                 ).astype(np.int32)


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
    step = jax.jit(lambda p, c, b, pos: jcache.decode_step(jcfg, p, c, b,
                                                           pos))
    for t in range(5):
        key, value = _decode_input(tcfg, rng, B)
        pos = (t + offsets).astype(np.int32)
        jl, jc = step(jparams, jc, {key: jnp.asarray(value)},
                      jnp.asarray(pos))
        tl, tc = tcache.decode_step(tcfg, tparams, tc, _torch({key: value}),
                                    torch.from_numpy(pos).long())
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-4, atol=1e-4)

    batch = _torch(_data(tcfg, 10, 2, 6, tpipeline).batch(0))
    inputs = batch["embeds"] if "embeds" in batch else batch["tokens"]
    with torch.no_grad():
        want = tmodel.forward(tcfg, tparams, batch)
    key = "embed" if "embeds" in batch else "token"
    cache = tcache.init_cache(tcfg, 2, MAX_SEQ)
    for t in range(inputs.shape[1]):
        got, cache = tcache.decode_step(tcfg, tparams, cache,
                                        {key: inputs[:, t:t + 1]}, t)
        torch.testing.assert_close(got[:, 0], want[:, t], rtol=1e-4,
                                   atol=1e-4)


def test_bf16_codebook_embedding_and_head_match_jax():
    """musicgen's reduced model in bf16: the sum of the 4 tables' rows bit
    for bit the jitted reference's (each add rounded to bf16; a sum in f32
    rounded once differs in a third of the entries), the (B, S, K, V) head
    within one bf16 step (``_bf16_head_slack``)."""
    arch = "musicgen-large"
    jcfg = dataclasses.replace(jregistry.get_reduced(arch), dtype="bfloat16")
    tcfg = dataclasses.replace(tregistry.get_reduced(arch), dtype="bfloat16")
    jparams = jax.jit(lambda key: jmodel.init_params(jcfg, key))(
        jax.random.PRNGKey(1))
    tparams = convert.params_from_numpy(tcfg,
                                        jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, size=(3, 40, 4)).astype(np.int32)
    want = jax.jit(lambda p, t: jmodel.embed_tokens(
        jcfg, p, {"tokens": t}))(jparams, jnp.asarray(toks))
    got = tmodel.embed_tokens(tcfg, tparams,
                              {"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    x = torch.from_numpy(rng.normal(size=(3, 40, jcfg.d_model)).astype(
        np.float32)).bfloat16()
    want = np.asarray(jax.jit(lambda p, v: jmodel.project_logits(
        jcfg, p, v))(jparams, jnp.asarray(x.float().numpy(), jnp.bfloat16)
                     ).astype(jnp.float32))
    got = tmodel.project_logits(tcfg, tparams, x)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = torch.einsum("bsd,kdv->bskv", x.double().abs(),
                         tparams["lm_head"].double().abs()).numpy()
    assert _bf16_head_slack(got.float().numpy(), want, scale) <= 0


@pytest.mark.parametrize("kind", [dict(num_codebooks=4),
                                  dict(embed_dim=48)],
                         ids=["codebooks", "embeds"])
def test_synthetic_batches_match_jax(kind, monkeypatch):
    monkeypatch.setattr(tpipeline, "TABLE_CHUNK_ROWS", 7)
    tpipeline.embedding_table.cache_clear()
    kw = dict(vocab_size=300, seq_len=24, global_batch=3, seed=5, **kind)
    want = jpipeline.SyntheticLM(jpipeline.DataConfig(**kw))
    got = tpipeline.SyntheticLM(tpipeline.DataConfig(**kw))
    for step in (0, 1):
        a, b = got.batch(step), want.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    tpipeline.embedding_table.cache_clear()


def test_launcher_moves_embeds_as_float():
    """``Run.step`` hands the step function f32 embeddings and long labels
    (a cast of every leaf to long would truncate the embeddings to 0)."""
    args = tlaunch.parse_args(["--arch", "qwen2-vl-72b", "--reduced",
                               "--steps", "1", "--seq", "8", "--batch", "2",
                               "--device", "cpu"])
    run = tlaunch.start(args)
    seen = {}

    def step_fn(params, opt_state, batch):
        seen.update(batch)
        return params, opt_state, {}

    run.step_fn = step_fn
    run.step(0)
    want = run.data.batch(0)
    assert seen["embeds"].dtype == torch.float32
    assert seen["labels"].dtype == torch.long
    np.testing.assert_array_equal(seen["embeds"].numpy(), want["embeds"])
    assert float(seen["embeds"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_sketchy_steps_through_launcher_match_jax(arch):
    args = tlaunch.parse_args([
        "--arch", arch, "--reduced", "--steps", "2", "--seq", "16",
        "--batch", "4", "--rank", "8", "--block-size", "32",
        "--update-every", "1", "--log-every", "1", "--device", "cpu"])
    jcfg, jparams, tcfg, tparams = _models(arch)
    tx = jmake_optimizer(JOptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, total_steps=args.steps,
        rank=args.rank, block_size=args.block_size,
        update_every=args.update_every, weight_decay=1e-4))
    step_fn = jax.jit(jmake_train_step(jcfg, tx, donate=False))
    data = _data(jcfg, args.seq, args.batch, args.seed)
    params, opt_state, jlosses = jparams, jax.jit(tx.init)(jparams), []
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             _jax(data.batch(step)))
        jlosses.append(float(metrics["loss"]))
    run, log = tlaunch.train(args, params=tparams)
    np.testing.assert_allclose([r["loss"] for r in log], jlosses, rtol=1e-4)
    moved = False
    for got, want, init in zip(tree.flatten(run.params),
                               jax.tree.leaves(params),
                               jax.tree.leaves(jparams)):
        assert_close_scaled(got.detach().numpy(), want, rtol=1e-4,
                            atol_frac=1e-5)
        moved |= not np.array_equal(np.asarray(want), np.asarray(init))
    assert moved


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_the_packages(arch, tmp_path):
    """The reference's checkpoint of the reduced model with its Sketchy
    state (the 3-D codebook ``embed`` and ``lm_head``; a tree without
    ``embed``) restores bit for bit into the port's template through
    ``convert.convert_checkpoint``, and the port's into the reference's."""
    from repro.train import checkpoint as jckpt
    from repro_torch.core.factory import OptimizerConfig as TOptimizerConfig
    from repro_torch.core.factory import make_optimizer as tmake_optimizer
    from repro_torch.train import checkpoint as tckpt
    opt = dict(name="sketchy", learning_rate=3e-3, total_steps=10, rank=8,
               block_size=32, update_every=1, weight_decay=1e-4)
    jcfg, jparams, tcfg, tparams = _models(arch)
    jtx = jmake_optimizer(JOptimizerConfig(**opt))
    ttx = tmake_optimizer(TOptimizerConfig(**opt))
    jstate = jax.jit(jtx.init)(jparams)
    tstate = ttx.init(tree.flatten(tparams))
    jckpt.save(str(tmp_path / "ref"), 0, (jparams, jstate))
    convert.convert_checkpoint(str(tmp_path / "ref"), str(tmp_path / "port"),
                               to="port")
    (got, _), step, _ = tckpt.restore(str(tmp_path / "port"),
                                      (tparams, tstate))
    assert step == 0
    for a, b in zip(tree.flatten(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tckpt.save(str(tmp_path / "port2"), 0, (tparams, tstate))
    convert.convert_checkpoint(str(tmp_path / "port2"),
                               str(tmp_path / "ref2"), to="reference")
    (back, _), step, _ = jckpt.restore(str(tmp_path / "ref2"),
                                       (jparams, jstate))
    assert step == 0
    for a, b in zip(jax.tree.leaves(back), tree.flatten(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())



@pytest.mark.parametrize("arch", ARCHS)
def test_card_run_second_moment_bytes_are_the_references(arch):
    """chip_smoke.py's phase 9a holds its full-width runs (the depth cut)
    to second-moment bytes written into it as constants: they are the
    reference's at that depth with the launcher's defaults (``jax.eval_shape``
    of its ``tx.init``, no allocation), and the port's on meta tensors, and
    its pool group count is the port's."""
    from repro.core import api as japi
    from repro_torch.core import api as tapi
    from repro_torch.core import pool as tpool
    from repro_torch.core.factory import OptimizerConfig as TOptimizerConfig
    from repro_torch.core.factory import make_optimizer as tmake_optimizer
    smoke = chip_smoke()
    (layers, groups, nbytes), = [rest for a, *rest in smoke.TRAIN_FULL
                                 if a == arch]
    args = tlaunch.parse_args(["--arch", arch])
    opt = dict(name=args.optimizer, rank=args.rank,
               block_size=args.block_size)
    jcfg = dataclasses.replace(jregistry.get_config(arch), num_layers=layers)
    jstate = jax.eval_shape(jmake_optimizer(JOptimizerConfig(**opt)).init,
                            jmodel.param_struct(jcfg))
    assert japi.second_moment_bytes(jstate) == nbytes
    tcfg = dataclasses.replace(tregistry.get_config(arch), num_layers=layers)
    shapes = tree.flatten(tmodel.param_shapes(tcfg))
    tstate = tmake_optimizer(TOptimizerConfig(**opt)).init(
        [torch.empty(s, device="meta") for s in shapes])
    assert tapi.second_moment_bytes(tstate) == nbytes
    index = tpool.build_index(tuple(tuple(s) for s in shapes),
                              args.block_size)
    assert len(index.groups) == groups
