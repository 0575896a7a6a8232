"""The port's mixture-of-experts block (repro_torch/models/moe.py) against
repro/models/moe.py, in f32, on the reduced deepseek-moe-16b and
kimi-k2-1t-a32b, from the reference's weights and numpy inputs:

(a) ``_route``: the same experts picked, and their gate weights;
(b) ``_slot_tables``: the same slot-to-token table and slot weights, and
    at ``capacity_factor`` 1.25 the same tokens dropped;
(c) ``moe_block``, with and without drops;
(d) router logits with forced ties (pairs of equal router columns): the
    same experts picked, the lower index first, as ``jax.lax.top_k``;
(e) the gradients of a weighted sum of ``moe_block`` with respect to x,
    the router and the experts, against ``jax.grad``;
(f) in bf16, against the jitted reference: the same experts picked; the
    combine (``_combine``) bit for bit against the reference's scatter-add
    on the same contributions and slot table, drops included; and the
    whole block within 2^-8 of its largest output.  The block is not
    always bit for bit: the router's f32 logits sum in another order in
    the two packages' CPU matmuls, which moves a gate weight by up to
    2.4e-7, and where that flips a bf16 rounding an output moves by a few
    of its own bf16 steps.  Measured over eight draws of each case below:
    24 of 32 draws bit for bit, the rest at most 1.5e-3 of the largest
    output.
Tolerances in f32: gate weights ``rtol=1e-5, atol=1e-6``; outputs
``rtol=1e-5`` plus 1e-6 of the largest magnitude (an output near 0 is a
difference of terms near 10 once the inputs share a direction);
gradients ``rtol=1e-4`` plus 1e-5 of each leaf's largest magnitude (sums
in another order); expert choices and slot tables exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.models import moe as jmoe
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import moe as tmoe

ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]


def _setup(arch, capacity_factor=None, seed=0, B=2, S=16, ties=False):
    """(jcfg, tcfg, jax params, torch params, x as numpy (B, S, D))."""
    jcfg, tcfg = jregistry.get_reduced(arch), tregistry.get_reduced(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    rng = np.random.default_rng(seed)
    shapes = tmoe.moe_params_shape(tcfg)
    leaves = [rng.normal(size=s).astype(np.float32) * s[-2] ** -0.5
              for s in tree.flatten(shapes)]
    params = tree.unflatten(shapes, leaves)
    if ties:      # experts 1, 3 and 5 route exactly as 0, 2 and 4
        r = params["router"]
        r[:, 1], r[:, 3], r[:, 5] = r[:, 0], r[:, 2], r[:, 4]
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    if capacity_factor is not None:
        # a direction every token shares crowds the same experts, so the
        # capacity drops some tokens
        x += 2 * rng.normal(size=tcfg.d_model).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = tree.unflatten(shapes, [torch.from_numpy(a.copy())
                                      for a in tree.flatten(params)])
    return jcfg, tcfg, jparams, tparams, x


def _tables(jcfg, tcfg, jparams, tparams, x):
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    xt = x.reshape(T, D)
    jw, ji = jmoe._route(jcfg, jparams["router"], jnp.asarray(xt))
    tw, ti = tmoe._route(tcfg, tparams["router"], torch.from_numpy(xt))
    E, k = tcfg.num_experts, tcfg.experts_per_token
    capacity = int(tcfg.capacity_factor * T * k / E) + 1
    jtok, jsw = jmoe._slot_tables(E, k, capacity, jw, ji, T)
    ttok, tsw, token_slots = tmoe._slot_tables(E, k, capacity, tw, ti, T)
    return (jw, ji, jtok, jsw), (tw, ti, ttok, tsw, token_slots)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_route_slot_tables_and_block_match_jax(arch, capacity_factor):
    jcfg, tcfg, jparams, tparams, x = _setup(arch, capacity_factor)
    (jw, ji, jtok, jsw), (tw, ti, ttok, tsw, token_slots) = \
        _tables(jcfg, tcfg, jparams, tparams, x)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tsw.numpy(), np.asarray(jsw), rtol=1e-5,
                               atol=1e-6)
    T, k = x.shape[0] * x.shape[1], tcfg.experts_per_token
    # every kept assignment is in the slot table once, and a dropped one
    # reads the overflow slot
    kept = int((np.asarray(jtok) < T).sum())
    assert int((token_slots < ttok.shape[0]).sum()) == kept
    assert sorted(token_slots[token_slots < ttok.shape[0]].tolist()) == \
        np.flatnonzero(np.asarray(jtok) < T).tolist()
    if capacity_factor is None:
        assert kept == T * k            # the reduced configs' 8.0 drops none
    else:
        assert kept < T * k             # 1.25 drops some

    want = jmoe.moe_block(jcfg, jparams, jnp.asarray(x))
    got = tmoe.moe_block(tcfg, tparams, torch.from_numpy(x))
    assert_close_scaled(got.numpy(), want, rtol=1e-5, atol_frac=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_ties_pick_the_reference_experts(arch):
    """Equal router columns give bitwise-equal probabilities; the lower
    expert of a tied pair comes first in both packages."""
    jcfg, tcfg, jparams, tparams, x = _setup(arch, ties=True, seed=3)
    (jw, ji, jtok, _), (tw, ti, ttok, _, _) = \
        _tables(jcfg, tcfg, jparams, tparams, x)
    probs = torch.softmax(torch.matmul(
        torch.from_numpy(x.reshape(-1, x.shape[2])), tparams["router"]), -1)
    assert torch.equal(probs[:, 0], probs[:, 1])
    # the tie decides the choice: tokens whose top-2 is a tied pair
    pair = (ti[:, 1] - ti[:, 0] == 1) & (ti[:, 0] % 2 == 0) & (ti[:, 0] < 6)
    assert int(pair.sum()) > 0
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    want = jmoe.moe_block(jcfg, jparams, jnp.asarray(x))
    got = tmoe.moe_block(tcfg, tparams, torch.from_numpy(x))
    assert_close_scaled(got.numpy(), want, rtol=1e-5, atol_frac=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_gradients_match_jax(arch, capacity_factor):
    jcfg, tcfg, jparams, tparams, x = _setup(arch, capacity_factor, seed=5)
    w = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jmoe.moe_block(jcfg, p, xx) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, jnp.asarray(x))
    leaves = [p.requires_grad_(True) for p in tree.flatten(tparams)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmoe.moe_block(tcfg, tree.unflatten(tparams, leaves), xt)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                leaves + [xt])
    want = jax.tree.leaves(jgp) + [jgx]
    assert len(grads) == len(want)
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape
        assert_close_scaled(got.numpy(), ref, rtol=1e-4, atol_frac=1e-5)
    assert float(np.abs(np.asarray(jgp["router"])).max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 1.25])
def test_bf16_block_and_combine_match_jitted_jax(arch, capacity_factor):
    jcfg, tcfg, jparams, tparams, x = _setup(arch, capacity_factor, seed=7)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    tp = tree.unflatten(tparams, [a.to(torch.bfloat16)
                                  for a in tree.flatten(tparams)])
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    T, D = x.shape[0] * x.shape[1], x.shape[2]
    E, k = tcfg.num_experts, tcfg.experts_per_token
    capacity = int(tcfg.capacity_factor * T * k / E) + 1

    _, ji = jax.jit(lambda r, xt: jmoe._route(jcfg, r, xt))(
        jp["router"], jx.reshape(T, D))
    tw, ti = tmoe._route(tcfg, tp["router"], tx.reshape(T, D))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    slot_tok, slot_w, token_slots = tmoe._slot_tables(E, k, capacity, tw,
                                                      ti, T)
    if capacity_factor is not None:
        assert int((slot_tok < T).sum()) < T * k      # some are dropped
    contrib = (torch.from_numpy(np.random.default_rng(8).normal(
        size=(E * capacity, D)).astype(np.float32)).bfloat16()
        * slot_w[:, None].bfloat16())
    want = jax.jit(lambda c, s: jnp.zeros((T + 1, D), c.dtype)
                   .at[s].add(c)[:T])(
        jnp.asarray(contrib.float().numpy(), jnp.bfloat16),
        jnp.asarray(slot_tok.numpy()))
    got = tmoe._combine(contrib, token_slots)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))

    want = jax.jit(lambda p, xx: jmoe.moe_block(jcfg, p, xx))(jp, jx)
    got = tmoe.moe_block(tcfg, tp, tx)
    assert got.dtype == torch.bfloat16
    assert_close_scaled(got.float().numpy(),
                        np.asarray(want.astype(jnp.float32)), rtol=0,
                        atol_frac=2 ** -8)
