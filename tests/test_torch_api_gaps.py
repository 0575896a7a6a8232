"""The reference's public API that the port first left out, against the
JAX package on the CPU from the same numpy inputs (made from a seed):

(a) ``models/model.py::loss_fn`` with ``batch["mask"]`` (repro/models/
model.py:298-304): a (B, S) mask, a (B,) mask broadcast up to the NLL's
rank, an all-zero mask (the sum over ``max(sum, 1)``), a bool mask, a
(B, S) mask over four codebooks, and none; the loss in f32 ``rtol=1e-4``
(tests/test_torch_model.py's), every gradient ``rtol=1e-4`` plus 1e-5 of
the leaf's largest magnitude (a (B,) mask that keeps 2 of 3 rows divides
by 2 instead of 36, so the gradients and their rounding are 18x the
mean's).
(b) ``transform.momentum(beta1, ema=..., dtype=...)`` (repro/core/
transform.py:89-115) over 3 steps, EMA and heavy-ball, in the parameters'
dtype and in a bf16 buffer; f32 ``rtol=1e-6``, bf16 as
tests/test_torch_optimizers.py holds bf16 momentum (``rtol=2^-7`` plus
``2^-8`` of the largest magnitude: XLA may round a bf16 expression once).
(c) Adam's ``state_dtype`` (repro/core/adam.py:22,40-42,67) in bf16 over 3
steps: the moments' dtype and values and the updates, at the bf16
tolerance of (b) for the moments and ``rtol=2^-6`` plus ``2^-7`` of the
largest magnitude for the update (two bf16 moments in a quotient).
(d) ``SketchyConfig(rank=r)``, the deprecated alias (repro/core/sketchy.py
:57,103,157-167): the reference's warning, equality with the
``rank_budget`` spelling, the error when both disagree.
(e) The launcher carries a loss mask to the device in the dtype
``jnp.asarray`` gives it; reduced mamba2-370m trains through
``launch.train`` with a mask leaf in every batch and matches the
reference's jitted step on the same masked batches (losses ``rtol=1e-4``).
(f) ``launch.serve``'s full-width mamba2-370m (48 layers, d_model 1024,
vocab 50,280) on the meta device: the reference's parameter shapes, the
forward's logits shape and the adapter's tied-embedding width.
"""
import dataclasses
import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.core import transform as jtransform
from repro.core.adam import AdamConfig as JAdamConfig, adam as jadam
from repro.core.factory import OptimizerConfig, make_optimizer
from repro.core.sketchy import (RankBudget as JRankBudget,
                                SketchyConfig as JSketchyConfig)
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.train.trainer import make_train_step
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.core import transform as ttransform
from repro_torch.core.adam import AdamConfig, adam
from repro_torch.core.sketchy import RankBudget, SketchyConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel

BF16 = dict(rtol=2.0 ** -7, atol_frac=2.0 ** -8)


def _mask(kind: str, b: int, s: int):
    rng = np.random.default_rng(7)
    if kind == "bs":
        return (rng.random((b, s)) < 0.6).astype(np.float32)
    if kind == "b":
        return np.array([1.0, 0.0, 1.0][:b], np.float32)
    if kind == "zero":
        return np.zeros((b, s), np.float32)
    if kind == "bool":
        return rng.random((b, s)) < 0.5
    return None


@pytest.mark.parametrize("arch,kind", [
    ("paper-lm-100m", "bs"), ("paper-lm-100m", "b"),
    ("paper-lm-100m", "zero"), ("paper-lm-100m", "bool"),
    ("paper-lm-100m", None), ("musicgen-large", "bs")])
def test_loss_mask_matches_jax(arch, kind):
    cfg_j, cfg_t = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    jparams = jmodel.init_params(cfg_j, jax.random.PRNGKey(3))
    batch = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=cfg_j.vocab_size, seq_len=12, global_batch=3, seed=4,
        num_codebooks=cfg_j.num_codebooks)).batch(0)
    mask = _mask(kind, 3, 12)
    if mask is not None:
        batch["mask"] = mask
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(cfg_j, p, b)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = convert.params_from_numpy(cfg_t,
                                        jax.tree.map(np.asarray, jparams))
    leaves = tree.flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tbatch = {k: tlaunch.batch_leaf(k, v, torch.device("cpu"))
              for k, v in batch.items()}
    tloss = tmodel.loss_fn(cfg_t, tparams, tbatch)
    tgrads = torch.autograd.grad(tloss, leaves, allow_unused=True)
    assert tloss.dtype == torch.float32
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-4,
                               atol=1e-7)
    if kind == "zero":
        assert tloss.item() == 0.0
    for got, want in zip(tgrads, jax.tree.leaves(jgrads)):
        got = torch.zeros(want.shape) if got is None else got
        assert_close_scaled(got.numpy(), np.asarray(want), rtol=1e-4,
                            atol_frac=1e-5)


@pytest.mark.parametrize("ema", [True, False])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_momentum_ema_and_dtype_match_jax(ema, dtype):
    rng = np.random.default_rng(11)
    params = [rng.normal(size=s).astype(np.float32) for s in [(4, 3), (5,)]]
    jtx = jtransform.momentum(0.9, ema=ema,
                              dtype=dtype and getattr(jnp, dtype))
    ttx = ttransform.momentum(0.9, ema=ema,
                              dtype=dtype and getattr(torch, dtype))
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        g = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        ju, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        tu, ts = ttx.update([torch.from_numpy(x) for x in g], ts, tp)
        for got, want, m, jm in zip(tu, ju, ts.momentum,
                                    jax.tree.leaves(js.momentum)):
            assert got.dtype == torch.float32
            assert str(m.dtype).split(".")[-1] == str(jm.dtype)
            if dtype:
                assert_close_scaled(got.numpy(), np.asarray(want), **BF16)
                assert_close_scaled(m.float().numpy(),
                                    np.asarray(jm, np.float32), **BF16)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)


def test_heavy_ball_momentum_accumulates():
    """ema=False is ``beta1 * mu + g``: a constant gradient sums to
    ``(1 - beta1^t) / (1 - beta1)`` of itself."""
    tx = ttransform.momentum(0.5, ema=False)
    p = [torch.zeros(3)]
    s = tx.init(p)
    for _ in range(3):
        u, s = tx.update([torch.ones(3)], s, p)
    torch.testing.assert_close(u[0], torch.full((3,), 1.75))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adam_state_dtype_matches_jax(state_dtype):
    rng = np.random.default_rng(13)
    shapes = [(6, 5), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jtx = jadam(JAdamConfig(state_dtype=getattr(jnp, state_dtype)))
    ttx = adam(AdamConfig(state_dtype=getattr(torch, state_dtype)))
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p) for p in params]
    js, ts = jtx.init(jp), ttx.init(tp)
    for _ in range(3):
        g = [rng.normal(size=s).astype(np.float32) for s in shapes]
        ju, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        tu, ts = ttx.update([torch.from_numpy(x) for x in g], ts, tp)
        jstats = [leaf.stats for leaf in js.leaves]
        for got, want, leaf, jst in zip(tu, ju, ts.leaves, jstats):
            assert got.dtype == torch.float32
            for t, j in ((leaf.stats.mu, jst.mu.value),
                         (leaf.stats.nu, jst.nu.value)):
                assert t.dtype == getattr(torch, state_dtype)
                assert str(j.dtype) == state_dtype
                if state_dtype == "float32":
                    np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                               rtol=1e-6, atol=1e-9)
                else:
                    assert_close_scaled(t.float().numpy(),
                                        np.asarray(j, np.float32), **BF16)
            if state_dtype == "float32":
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-7)
            else:
                assert_close_scaled(got.numpy(), np.asarray(want),
                                    rtol=2.0 ** -6, atol_frac=2.0 ** -7)


def _warned(make):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = make()
    return cfg, [(w.category, str(w.message)) for w in caught]


def test_sketchy_rank_alias_warns_as_the_reference():
    cfg, got = _warned(lambda: SketchyConfig(rank=8))
    _, want = _warned(lambda: JSketchyConfig(rank=8))
    assert got == want and got and got[0][0] is DeprecationWarning
    assert cfg.rank == 8
    assert cfg.rank_budget == RankBudget(min_k=8, max_k=8, policy="static")
    assert cfg == SketchyConfig(rank_budget=RankBudget(min_k=8, max_k=8))
    assert dataclasses.astuple(cfg.rank_budget) == dataclasses.astuple(
        JSketchyConfig(rank=8).rank_budget)


@pytest.mark.parametrize("kw,ok", [
    (dict(rank=8, rank_budget=(4, 4)), False),
    (dict(rank=4, rank_budget=(2, 4)), True),
    (dict(rank_budget=(2, 4)), True),
    ({}, True)])
def test_sketchy_rank_and_budget_resolve_as_the_reference(kw, ok):
    def build(cls, budget_cls):
        args = dict(kw)
        if "rank_budget" in args:
            lo, hi = args["rank_budget"]
            args["rank_budget"] = budget_cls(min_k=lo, max_k=hi)
        return cls(**args)

    if not ok:
        with pytest.raises(ValueError, match="not both"):
            build(SketchyConfig, RankBudget)
        with pytest.raises(ValueError, match="not both"):
            build(JSketchyConfig, JRankBudget)
        return
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, want = (build(SketchyConfig, RankBudget),
                     build(JSketchyConfig, JRankBudget))
    assert got.rank == want.rank
    assert dataclasses.astuple(got.rank_budget) == dataclasses.astuple(
        want.rank_budget)


@pytest.mark.parametrize("value,dtype", [
    (np.ones((2, 3), np.float64), torch.float32),
    (np.ones((2, 3), np.float32), torch.float32),
    (np.ones((2,), np.int64), torch.int32),
    (np.ones((2, 3), bool), torch.bool)])
def test_launcher_carries_the_mask_in_the_reference_dtype(value, dtype):
    assert jnp.asarray(value).dtype == np.dtype(str(dtype).split(".")[-1])
    got = tlaunch.batch_leaf("mask", value, torch.device("cpu"))
    assert got.dtype == dtype and got.shape == value.shape
    assert tlaunch.batch_leaf("labels", value.astype(np.int32),
                              torch.device("cpu")).dtype == torch.long


def _masked(batch: dict) -> dict:
    b, s = batch["labels"].shape
    keep = np.arange(s)[None, :] < (s - 3 * np.arange(b))[:, None]
    return dict(batch, mask=keep.astype(np.float32))


def test_reduced_mamba2_trains_with_a_mask_as_the_reference():
    argv = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
            "--steps", "3", "--seq", "16", "--batch", "4", "--rank", "4",
            "--block-size", "32", "--update-every", "2", "--lr", "3e-3",
            "--log-every", "3"]
    args = tlaunch.parse_args(argv)
    cfg = jregistry.get_reduced(args.arch)
    tx = make_optimizer(OptimizerConfig(
        name="sketchy", learning_rate=args.lr, total_steps=args.steps,
        rank=args.rank, block_size=args.block_size,
        update_every=args.update_every, weight_decay=1e-4))
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    params = jmodel.init_params(cfg, jax.random.PRNGKey(args.seed))
    init = jax.tree.map(np.asarray, params)
    state = tx.init(params)
    step = jax.jit(make_train_step(cfg, tx))
    want = []
    for i in range(args.steps):
        batch = _masked(data.batch(i))
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()})
        want.append(float(metrics["loss"]))
    seen = []
    plain = SyntheticLM.batch

    def masked(self, step, *a, **k):
        batch = _masked(plain(self, step, *a, **k))
        seen.append(batch["mask"].dtype)
        return batch

    with mock.patch.object(SyntheticLM, "batch", masked):
        _, log = tlaunch.train(args, params=convert.params_from_numpy(
            tregistry.get_reduced(args.arch), init))
    assert seen == [np.float32] * args.steps
    got = [r["loss"] for r in log]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(got).all()


def test_full_width_mamba2_shapes_on_meta():
    """The served full-width config's shapes without allocating: the
    parameters as the reference's ``param_shapes``, a (1, 128) forward's
    logits and the adapter's flat width (the tied embedding)."""
    from repro_torch.serve.adapt import OnlineAdapter

    cfg_t = tregistry.get_config("mamba2-370m")
    cfg_j = jregistry.get_config("mamba2-370m")
    assert (cfg_t.num_layers, cfg_t.d_model, cfg_t.vocab_size,
            cfg_t.ssm_state, cfg_t.ssm_head_dim) == (48, 1024, 50280, 128, 64)
    shapes = tmodel.param_shapes(cfg_t)
    assert shapes == jmodel.param_shapes(cfg_j)
    dtype = tmodel.DTYPES[cfg_t.dtype]
    params = _meta(shapes, dtype)
    n = sum(p.numel() for p in tree.flatten(params))
    assert 3.6e8 < n < 4.0e8, n
    tokens = torch.zeros((1, 128), dtype=torch.long, device="meta")
    logits = tmodel.forward(cfg_t, params, {"tokens": tokens})
    assert tuple(logits.shape) == (1, 128, 50280)
    assert logits.device.type == "meta"
    assert OnlineAdapter(cfg_t, params).d == 50280 * 1024


def _meta(shapes, dtype):
    if isinstance(shapes, dict):
        return {k: _meta(v, dtype) for k, v in shapes.items()}
    return torch.empty(shapes, dtype=dtype, device="meta")


def test_card_run_of_full_width_mamba2_is_predicted_from_the_code():
    """chip_smoke.py's full-width mamba2-370m runs (phases 9a and 9c): the
    whole model, its second-moment bytes the reference's at the launcher's
    defaults (``jax.eval_shape``, nothing allocated), its pool groups the
    port's, and the launches a training step predicts: kernel 8 twice a
    layer (the forward and the remat recompute), no attention; the serve
    run the launcher's full-width mamba2-370m with SERVE_ARGV's traffic."""
    from repro.core import api as japi
    from repro_torch.core import pool as tpool
    from torch_parity import chip_smoke
    smoke = chip_smoke()
    (layers, groups, nbytes), = [rest for a, *rest in smoke.TRAIN_FULL
                                 if a == "mamba2-370m"]
    cfg_j = jregistry.get_config("mamba2-370m")
    assert layers == cfg_j.num_layers == 48
    args = tlaunch.parse_args(["--arch", "mamba2-370m"])
    jstate = jax.eval_shape(make_optimizer(OptimizerConfig(
        name=args.optimizer, rank=args.rank,
        block_size=args.block_size)).init, jmodel.param_struct(cfg_j))
    assert japi.second_moment_bytes(jstate) == nbytes
    cfg_t = tregistry.get_config("mamba2-370m")
    shapes = tree.flatten(tmodel.param_shapes(cfg_t))
    assert len(tpool.build_index(tuple(tuple(s) for s in shapes),
                                 args.block_size).groups) == groups
    assert smoke.per_step(cfg_t) == dict(flash_attention=0, ssd_scan=96)
    serve = smoke.serve_lib.parse_args(smoke.MAMBA_SERVE_ARGV)
    assert (serve.arch, serve.reduced) == ("mamba2-370m", False)
    assert smoke.per_gradient(cfg_t) == dict(flash_attention=0, ssd_scan=96)
    assert float(smoke.TRAIN_FULL_LR["mamba2-370m"]) > 0


def test_mamba2_gradient_is_finite_where_the_references_overflows():
    """The reference's SSD chunk takes ``exp(A_cs[q] - A_cs[s])`` above the
    diagonal too and zeroes it with ``jnp.where`` (repro/models/ssm.py:57),
    so where that overflows its gradient is ``0 * inf``: NaN in every layer
    but the last of reduced mamba2-370m at chunk 256 and S 64 (and of the
    full-width model at the launcher's S 128, whose step 1 is NaN).  The
    port masks before the exponential: its gradient at chunk 256 is finite
    and equals the reference's at chunk 16 (the same scan cut into other
    chunks, where nothing overflows), ``rtol=1e-4`` plus 1e-5 of each leaf's
    largest magnitude."""
    base_j = jregistry.get_reduced("mamba2-370m")
    batch = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=base_j.vocab_size, seq_len=64, global_batch=2,
        seed=0)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    long_j = dataclasses.replace(base_j, ssm_chunk=256)
    jparams = jmodel.init_params(long_j, jax.random.PRNGKey(0))
    grad = jax.jit(jax.grad(lambda p, c: jmodel.loss_fn(c, p, jb)),
                   static_argnums=1)
    nan = grad(jparams, long_j)
    assert not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(nan))
    want = grad(jparams, dataclasses.replace(base_j, ssm_chunk=16))
    cfg_t = dataclasses.replace(tregistry.get_reduced("mamba2-370m"),
                                ssm_chunk=256)
    tparams = convert.params_from_numpy(cfg_t,
                                        jax.tree.map(np.asarray, jparams))
    leaves = tree.flatten(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tmodel.loss_fn(cfg_t, tparams, {
        k: torch.from_numpy(v).long() for k, v in batch.items()})
    for got, w in zip(torch.autograd.grad(loss, leaves),
                      jax.tree.leaves(want)):
        assert torch.isfinite(got).all()
        assert_close_scaled(got.numpy(), np.asarray(w), rtol=1e-4,
                            atol_frac=1e-5)
