"""Checkpoints across the packages, through ``convert.convert_checkpoint``.

(a) The manifests: the port's checkpoint of an optimizer state at init,
renamed for the reference, equals the reference's own checkpoint of its
state at init (names, dtypes, shapes, roles, ``blocked`` and
``param_index``), and renamed back equals the port's; for Sketchy at every
storage, async (fp32 and int8), with a ``rho_greedy`` budget, Shampoo and
Adam.
A leaf with no counterpart raises.
(a'') A reference checkpoint from before pooling (its engine state in the
per-leaf layout, built as tests/test_pool.py builds it), converted, restores
in the port to the reference's leaves bit for bit, at fp32 and int8
storage; into another optimizer family it raises in both packages.
(a') The migration shims: the reference saves a Sketchy state (random
statistics) at one storage or with fixed ranks; ``repro.train.checkpoint.
restore`` and the port's ``restore`` of the renamed checkpoint load it into
a template of another storage (quantized to nearest or dequantized) or with
a rank budget (the template's uniform ranks kept), and every leaf agrees
bit for bit.
(b) Both directions on the reduced model: the reference runs 3 updates and
saves with ``repro.train.checkpoint.save``; the port restores the renamed
checkpoint (every leaf bit for bit equal to the reference's) and its next
update matches the reference's next update.  Then the reverse: the port
saves after 3 updates, ``repro.train.checkpoint.restore`` loads the renamed
checkpoint (bit for bit) and the reference's next update matches the
port's.  The next update is at count 3, where no refresh is due (cadence
2), so it preconditions from the restored statistics alone.  Tolerances of
tests/test_torch_engine.py and tests/test_torch_optimizers.py: fp32 and
int8 ``rtol=1e-4`` plus 1e-5 of the largest magnitude (int8 on the fused
path, the reference's "on"), bf16 ``rtol=2^-8`` plus 1e-3 of it, Shampoo
``rtol=1e-4`` plus 1e-4 of it.
"""
import collections
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.core import api as japi, pool as jpool
from repro.core import factory as jfactory
from repro.core.sketchy import RankBudget as JRankBudget
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro_torch import convert, tree
from repro_torch.core import factory as tfactory
from repro_torch.core.sketchy import RankBudget
from repro_torch.train import checkpoint as tckpt

OPT = dict(learning_rate=3e-3, total_steps=20, rank=4, block_size=32,
           update_every=2, weight_decay=1e-4)
BUDGET = dict(total=432, min_k=2, max_k=4, policy="rho_greedy")
FP32 = dict(rtol=1e-4, atol_frac=1e-5)
BF16 = dict(rtol=2.0 ** -8, atol_frac=1e-3)
CONFIGS = {
    "sketchy-fp32": (dict(name="sketchy"), FP32),
    "sketchy-bf16": (dict(name="sketchy", second_moment_dtype="bf16"), BF16),
    "sketchy-int8": (dict(name="sketchy", second_moment_dtype="int8"), FP32),
    "sketchy-fp32-async": (dict(name="sketchy", refresh_mode="async"), FP32),
    "sketchy-int8-async": (dict(name="sketchy", second_moment_dtype="int8",
                                refresh_mode="async"), FP32),
    "sketchy-rho-greedy": (dict(name="sketchy", rank_budget=BUDGET), FP32),
    "shampoo": (dict(name="shampoo"), dict(rtol=1e-4, atol_frac=1e-4)),
    "adam": (dict(name="adam"), FP32),
}


def _txs(opt: dict):
    """Both packages' chains for ``opt`` (int8: the reference's fused
    path, the port's "auto")."""
    budget = opt.get("rank_budget")
    jopt = dict(OPT, **dict(opt, rank_budget=budget
                            and JRankBudget(**budget)))
    if opt.get("second_moment_dtype") == "int8":
        jopt["quantized_epilogue"] = "on"
    topt = dict(OPT, **dict(opt, rank_budget=budget and RankBudget(**budget)))
    return (jfactory.make_optimizer(jfactory.OptimizerConfig(**jopt)),
            tfactory.make_optimizer(tfactory.OptimizerConfig(**topt)))


@functools.lru_cache(maxsize=None)
def _jparams():
    cfg = jregistry.get_reduced("paper-lm-100m")
    return jmodel.init_params(cfg, jax.random.PRNGKey(0))


def _params():
    jparams = _jparams()
    tparams = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jparams)
    return jparams, tparams


def _manifest(path: str) -> list:
    with open(os.path.join(path, "manifest.json")) as f:
        return [(r["name"], r["dtype"], r["shape"], r["meta"])
                for r in json.load(f)["leaves"]]


@pytest.mark.parametrize("config", list(CONFIGS))
def test_manifests_match_through_the_name_map(tmp_path, config):
    jtx, ttx = _txs(CONFIGS[config][0])
    jparams, tparams = _params()
    jckpt.save(str(tmp_path / "ref"), 0, (jparams, jtx.init(jparams)))
    tckpt.save(str(tmp_path / "port"), 0,
               (tparams, ttx.init(tree.flatten(tparams))))
    to_ref = convert.convert_checkpoint(str(tmp_path / "port"),
                                        str(tmp_path / "as_ref"),
                                        to="reference")
    assert _manifest(to_ref) == _manifest(str(tmp_path / "ref" / "step-0"))
    back = convert.convert_checkpoint(str(tmp_path / "as_ref"),
                                      str(tmp_path / "back"), to="port")
    assert _manifest(back) == _manifest(str(tmp_path / "port" / "step-0"))


def test_leaf_without_counterpart_raises(tmp_path):
    _, ttx = _txs(dict(name="sketchy"))
    _, tparams = _params()
    path = tckpt.save(str(tmp_path / "port"), 0,
                      (tparams, ttx.init(tree.flatten(tparams))))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["leaves"][-1]["name"] = "1::.inner::precond::.pending::x"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="no counterpart"):
        convert.convert_checkpoint(str(tmp_path / "port"),
                                   str(tmp_path / "out"), to="reference")
    with pytest.raises(ValueError, match="no counterpart"):
        # a reference name is not a port name
        convert.convert_checkpoint(str(tmp_path / "port"),
                                   str(tmp_path / "out"), to="port")


def _grads(rng, tparams: list) -> list:
    return [rng.normal(size=p.shape).astype(np.float32) * 0.05
            for p in tparams]


def _same_leaves(jstate, tstate) -> None:
    """The reference's and the port's leaves (transient ones excepted),
    in manifest order, bit for bit."""
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    tleaves = [leaf.value for leaf in tckpt.leaves(tstate)
               if not leaf.transient]
    jnames = [n for n, _ in jckpt._flatten_with_names(jstate)[0]]
    trans = jckpt._transient_flags(jstate)
    jleaves = [x for x, t in zip(jleaves, trans) if not t]
    assert len(jleaves) == len(tleaves), (len(jleaves), len(tleaves))
    for name, a, b in zip(jnames, jleaves, tleaves):
        b = np.asarray(b) if not isinstance(b, torch.Tensor) else \
            b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
        np.testing.assert_array_equal(np.asarray(a, b.dtype), b,
                                      err_msg=name)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_next_update_after_restore_matches_both_ways(tmp_path, config):
    opt, tol = CONFIGS[config]
    jtx, ttx = _txs(opt)
    jparams0, tparams0 = _params()
    like = tparams0
    jupdate = jax.jit(jtx.update)
    treedef = jax.tree.structure(jparams0)
    rng = np.random.default_rng(0)
    grads = [_grads(rng, tree.flatten(tparams0)) for _ in range(4)]

    def jax_steps(jparams, js, steps):
        for g in steps:
            ju, js = jupdate(jax.tree.unflatten(
                treedef, [jnp.asarray(x) for x in g]), js, jparams)
            jparams = jax.tree.map(lambda p, u: p + u, jparams, ju)
        return jparams, js, ju

    def port_steps(tparams, ts, steps):
        flat = tree.flatten(tparams)
        for g in steps:
            tu, ts = ttx.update([torch.from_numpy(x) for x in g], ts, flat)
            flat = [p + u for p, u in zip(flat, tu)]
        return tree.unflatten(like, flat), ts, tu

    # the reference saves, the port restores
    jparams, js, _ = jax_steps(jparams0, jtx.init(jparams0), grads[:3])
    jckpt.save(str(tmp_path / "ref"), 3, (jparams, js))
    convert.convert_checkpoint(str(tmp_path / "ref"), str(tmp_path / "port"),
                               to="port")
    (tparams, ts), step, _ = tckpt.restore(
        str(tmp_path / "port"), (tparams0, ttx.init(tree.flatten(tparams0))))
    assert step == 3 and type(ts.count) is int and ts.count == 3
    _same_leaves((jparams, js), (tparams, ts))
    (jparams_r, js_r), _, _ = jckpt.restore(
        str(tmp_path / "ref"), (jparams0, jtx.init(jparams0)))
    _, _, ju = jax_steps(jparams_r, js_r, grads[3:])
    _, _, tu = port_steps(tparams, ts, grads[3:])
    for got, want in zip(tu, jax.tree.leaves(ju)):
        assert_close_scaled(got.numpy(), want, **tol)

    # the port saves, the reference restores
    tparams, ts, _ = port_steps(tparams0, ttx.init(tree.flatten(tparams0)),
                                grads[:3])
    tckpt.save(str(tmp_path / "port2"), 3, (tparams, ts))
    convert.convert_checkpoint(str(tmp_path / "port2"),
                               str(tmp_path / "ref2"), to="reference")
    (jparams, js), step, _ = jckpt.restore(
        str(tmp_path / "ref2"), (jparams0, jtx.init(jparams0)))
    assert step == 3
    _same_leaves((jparams, js), (tparams, ts))
    (tparams_r, ts_r), _, _ = tckpt.restore(
        str(tmp_path / "port2"), (tparams0, ttx.init(tree.flatten(tparams0))))
    _, _, ju = jax_steps(jparams, js, grads[3:])
    _, _, tu = port_steps(tparams_r, ts_r, grads[3:])
    for got, want in zip(tu, jax.tree.leaves(ju)):
        assert_close_scaled(got.numpy(), want, **tol)


SHIMS = {
    "fp32-into-int8": ({}, dict(second_moment_dtype="int8")),
    "bf16-into-int8": (dict(second_moment_dtype="bf16"),
                       dict(second_moment_dtype="int8")),
    "int8-into-fp32": (dict(second_moment_dtype="int8"), {}),
    "int8-into-bf16": (dict(second_moment_dtype="int8"),
                       dict(second_moment_dtype="bf16")),
    "fixed-rank-into-budget": ({}, dict(rank_budget=BUDGET)),
    "fixed-rank-into-budget-int8": ({}, dict(rank_budget=BUDGET,
                                             second_moment_dtype="int8")),
}


def _noise(rng, x):
    """A leaf of the same dtype and shape with random values (counts and
    ranks, int32, kept)."""
    x = np.asarray(x)
    if x.dtype == np.int8:
        return jnp.asarray(rng.integers(-127, 128, x.shape), jnp.int8)
    if not jnp.issubdtype(x.dtype, jnp.floating):
        return jnp.asarray(x)
    return jnp.asarray(rng.normal(size=x.shape), x.dtype)


@pytest.mark.parametrize("shim", list(SHIMS))
def test_migration_shims_match_the_reference(tmp_path, shim):
    src, dst = (dict(name="sketchy", **o) for o in SHIMS[shim])
    jsrc, _ = _txs(src)
    jdst, tdst = _txs(dst)
    jparams, tparams = _params()
    rng = np.random.default_rng(1)
    js = jax.tree.map(lambda x: _noise(rng, x), jsrc.init(jparams))
    jckpt.save(str(tmp_path / "ref"), 3, (jparams, js))
    convert.convert_checkpoint(str(tmp_path / "ref"), str(tmp_path / "port"),
                               to="port")
    want, _, _ = jckpt.restore(str(tmp_path / "ref"),
                               (jparams, jdst.init(jparams)))
    got, _, _ = tckpt.restore(str(tmp_path / "port"),
                              (tparams, tdst.init(tree.flatten(tparams))))
    _same_leaves(want, got)


def _synthesize_pre_pool_state(state, params, block_size):
    """Re-slice a pooled reference engine state into the per-leaf layout it
    had before pooling (tagged), as an old checkpoint stored it (a copy of
    tests/test_pool.py's helper)."""
    OldState = collections.namedtuple("OldState", ["count", "leaves"])
    OldLeaf = collections.namedtuple("OldLeaf", ["stats", "graft"])
    index = jpool.build_index(
        tuple(tuple(p.shape) for p in jax.tree.leaves(params)), block_size)
    leaves = []
    for i, plan in enumerate(index.leaves):
        leaf = state.leaves[i]
        if plan.group is None:
            leaves.append(OldLeaf(stats=leaf.stats, graft=None))
            continue
        key = index.groups[plan.group].key
        sliced = jax.tree.map(
            lambda t: japi.Tagged(
                t.value[plan.offset:plan.offset + plan.info.num_blocks],
                t.meta),
            state.pools[key], is_leaf=lambda x: isinstance(x, japi.Tagged))
        leaves.append(OldLeaf(stats=sliced, graft=leaf.graft))
    return OldState(count=state.count, leaves=tuple(leaves))


def _pre_pool_checkpoint(tmp_path, opt: dict):
    """The reference's ``(params, opt_state)`` of ``opt`` (random
    statistics) with its engine state in the pre-pool layout, saved by the
    reference and converted for the port; returns the reference's pooled
    state and both packages' parameters."""
    jtx, _ = _txs(opt)
    jparams, tparams = _params()
    rng = np.random.default_rng(2)
    js = jax.tree.map(lambda x: _noise(rng, x), jtx.init(jparams))
    old = _synthesize_pre_pool_state(js.inner["precond"], jparams,
                                     OPT["block_size"])
    jold = js._replace(inner=dict(js.inner, precond=old))
    jckpt.save(str(tmp_path / "ref"), 5, (jparams, jold))
    convert.convert_checkpoint(str(tmp_path / "ref"), str(tmp_path / "port"),
                               to="port")
    return js, jparams, tparams


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_pre_pool_checkpoint_restores_as_the_reference(tmp_path, storage):
    """A reference checkpoint from before pooling restores in the port to
    the reference's leaves, bit for bit (reference train/checkpoint.py
    :191, tests/test_pool.py:309)."""
    opt = dict(name="sketchy", second_moment_dtype=storage)
    js, jparams, tparams = _pre_pool_checkpoint(tmp_path, opt)
    jtx, ttx = _txs(opt)
    want, step, _ = jckpt.restore(str(tmp_path / "ref"),
                                  (jparams, jtx.init(jparams)))
    got, tstep, _ = tckpt.restore(str(tmp_path / "port"),
                                  (tparams, ttx.init(tree.flatten(tparams))))
    assert step == tstep == 5
    _same_leaves(want, got)
    _same_leaves((jparams, js), got)


def test_pre_pool_checkpoint_of_another_family_raises(tmp_path):
    """A pre-pool Sketchy checkpoint restored into Shampoo fails loudly in
    both packages (tests/test_pool.py:330)."""
    _, jparams, tparams = _pre_pool_checkpoint(tmp_path,
                                               dict(name="sketchy"))
    jtx, ttx = _txs(dict(name="shampoo"))
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path / "ref"), (jparams, jtx.init(jparams)))
    with pytest.raises(ValueError):
        tckpt.restore(str(tmp_path / "port"),
                      (tparams, ttx.init(tree.flatten(tparams))))
