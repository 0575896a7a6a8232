"""The moe block's expert-parallel path (repro_torch/models/moe.py,
``_moe_routed_expert_parallel``) on four gloo ranks against the
reference's ``_moe_routed_shard_map`` (repro/models/moe.py :75) and
against the port's single-process block; and the rules port's
``param_spec`` (repro_torch/sharding/rules.py) against the reference's.

A module fixture runs tests/torch_mesh_ranks.py's ``moe_ep`` scenario on 4
ranks (tests/torch_ranks.py: fresh interpreters with no JAX, one thread
each, killed after 120 s) and, beside them, one JAX interpreter with 4
host devices that runs the reference's ``moe_block`` under ``use_mesh`` on
the same meshes (built with ``jax.sharding.Mesh``, whose axes are Auto:
jax 0.9's ``jax.make_mesh`` makes Explicit axes, under which the
reference's ``constrain`` raises) and its ``jax.grad``.  The cases
(``MOE_CASES``): the reduced deepseek-moe-16b and kimi-k2-1t-a32b, 8
experts over a (1, 4) mesh (2 a rank), at the configs' capacity factor
(no drops) and at 1.25 (drops), in f32 and bf16; deepseek's on a (2, 2)
mesh (the batch and the fsdp axis split over 'data': the router's and the
experts' d_model rows gathered); and ``moe_impl="gspmd"``, which takes the
single-process path under the mesh.  Each rank holds only its experts
(``convert.expert_parallel_shard``) and its rows of the batch; the loss is
the weighted sum of its output.

Held, for every rank: its output rows; the gradients of its experts (its
slices of the whole gradient), of the router and of its input rows; the
shared experts' gradient (summed over the data ranks on the (2, 2) mesh,
whose losses are the whole one's parts).  In f32 against the reference
and against the single-process block at ``rtol=1e-5`` plus 1e-6 of the
largest magnitude (outputs) and ``rtol=1e-4`` plus 1e-5 of each leaf's
largest magnitude (gradients), as tests/test_torch_moe.py holds the
block: the routed sum runs in f32 in another order (measured: 3e-7 of the
largest output and 8e-7 of a leaf's largest gradient against the
reference; at k = 2 the output equals the single-process block's).  In
bf16 within 2^-8 (outputs) and 2^-6 (gradients) of the largest magnitude:
the partials are rounded to bf16 and summed in f32 here, added one at a
time in bf16 by the single-process block and in a bf16 ``psum`` by the
reference (measured: outputs 4.8e-6, gradients 8.7e-3 against the
reference and 5.8e-3 against the single-process block, whose own bf16
gradients differ from the reference's by 8.7e-3).  The gradient is the
single-process one, not 4 times it.  Every rank of an
experts group ends with the same output and router, shared and input
gradients; the dropped assignments are the single-process block's; the
gspmd case is the single-process block bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks_lib
import torch_ranks
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.sharding import rules as jrules
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import model as model_lib
from repro_torch.models import moe as tmoe
from repro_torch.sharding import rules as trules

P = ranks_lib.WORLD
LIMIT_S = 120
CASES = ranks_lib.MOE_CASES
NAMES = [ranks_lib.moe_case_name(c) for c in CASES]

_REFERENCE = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.models import moe
from repro.sharding import rules
cases = json.load(open(sys.argv[1]))
data = np.load(sys.argv[2])
out = {}
for name, (arch, dtype, cf, shape, impl) in cases.items():
    kw = dict(dtype=dtype, moe_impl=impl)
    if cf is not None:
        kw["capacity_factor"] = cf
    cfg = dataclasses.replace(registry.get_reduced(arch), **kw)
    dt = jnp.dtype(dtype)
    paths = sorted(k.split("/", 1)[1] for k in data.files
                   if k.startswith(name + "/p/"))
    p = {}
    for path in paths:
        node, keys = p, path.split("/")[1:]
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = jnp.asarray(data[f"{name}/{path}"], dt)
    x = jnp.asarray(data[f"{name}/x"], dt)
    w = data[f"{name}/w"]
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(shape),
                             ("data", "model"))
    with rules.use_mesh(mesh):
        loss = lambda p, x: jnp.sum(moe.moe_block(cfg, p, x) * w)
        y, (gp, gx) = jax.jit(lambda p, x: (
            moe.moe_block(cfg, p, x),
            jax.grad(loss, argnums=(0, 1))(p, x)))(p, x)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    out[f"{name}/y"] = f32(y)
    out[f"{name}/gx"] = f32(gx)
    for path, g in zip(paths, jax.tree.leaves(gp)):
        out[f"{name}/g/{path.split('/', 1)[1]}"] = f32(g)
np.savez(sys.argv[3], **out)
"""


def _paths(params: dict) -> list:
    return trules.tree_paths(params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the reference's arrays by key)."""
    out = tmp_path_factory.mktemp("moe_ep")
    arrays, cases = {}, {}
    for case, name in zip(CASES, NAMES):
        params, x, w = ranks_lib.moe_inputs(case)
        if case[4] != "gspmd":
            cases[name] = case
        for path, a in zip(_paths(params), tree.flatten(params)):
            arrays[f"{name}/p/{path}"] = a
        arrays[f"{name}/x"], arrays[f"{name}/w"] = x, w
    (out / "cases.json").write_text(json.dumps(cases))
    np.savez(out / "inputs.npz", **arrays)
    procs = torch_ranks.start_ranks(ranks_lib.__file__, ["moe_ep"], P, out)
    procs.append(torch_ranks.start_jax(
        _REFERENCE, [out / "cases.json", out / "inputs.npz",
                     out / "ref.npz"], 4, out))
    torch_ranks.wait_all(procs, out, LIMIT_S)
    ref = np.load(out / "ref.npz")
    return torch_ranks.load_ranks(out, P), {k: ref[k] for k in ref.files}


def _single(case, rows=slice(None)):
    """The port's single-process block on the whole weights and the batch's
    ``rows``: (output, {path: gradient}, input gradient, dropped
    assignments), f32."""
    cfg = ranks_lib.moe_config(case)
    dtype = model_lib.DTYPES[cfg.dtype]
    params, x, w = ranks_lib.moe_inputs(case)
    x, w = x[rows], w[rows]
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True)
              for a in tree.flatten(params)]
    xt = torch.from_numpy(x.copy()).to(dtype).requires_grad_(True)
    drops = []
    tables = tmoe._slot_tables

    def counted(E, k, capacity, *rest):
        got = tables(E, k, capacity, *rest)
        drops.append(int((got[2] == E * capacity).sum()))
        return got

    tmoe._slot_tables = counted
    try:
        y = tmoe.moe_block(cfg, tree.unflatten(params, leaves), xt)
    finally:
        tmoe._slot_tables = tables
    grads = torch.autograd.grad((y.float() * torch.from_numpy(w.copy())
                                 ).sum(),
                                leaves + [xt])
    return (y.detach().float().numpy(),
            dict(zip(_paths(params), (g.float().numpy()
                                      for g in grads[:-1]))),
            grads[-1].float().numpy(), sum(drops))


def _rank_part(path: str, g: np.ndarray, case, rank: int) -> np.ndarray:
    """What rank ``rank`` holds of the whole gradient ``g`` of ``path``:
    its experts and, on the (2, 2) mesh, its d_model rows of the experts
    and the router."""
    nd, nm = case[3]
    d, m, _ = ranks_lib.moe_rank_slices(case, rank)
    rows = lambda n: slice(d * n // nd, (d + 1) * n // nd)
    if path.startswith("experts/"):
        E = g.shape[0]
        g = g[m * E // nm:(m + 1) * E // nm]
        if path.endswith("w_down"):
            return g[:, :, rows(g.shape[2])]
        return g[:, rows(g.shape[1])]
    if path == "router":
        return g[rows(g.shape[0])]
    return g


def _check(case, got: dict, rank: int, y, grads: dict, gx) -> None:
    """Rank ``rank``'s results ``got`` against the whole block's ``y``,
    ``grads`` (by path) and ``gx`` at the case's tolerance."""
    bf16 = case[1] == "bfloat16"
    out_tol = dict(rtol=0, atol_frac=2 ** -8) if bf16 else \
        dict(rtol=1e-5, atol_frac=1e-6)
    grad_tol = dict(rtol=0, atol_frac=2 ** -6) if bf16 else \
        dict(rtol=1e-4, atol_frac=1e-5)
    _, _, rows = ranks_lib.moe_rank_slices(case, rank)
    assert_close_scaled(got["y"].numpy(), y[rows], **out_tol)
    assert_close_scaled(got["gx"].numpy(), gx[rows], **grad_tol)
    for path, g in zip(_paths(got["grads"]), tree.flatten(got["grads"])):
        if path.startswith("shared/"):
            continue                      # summed over the data ranks
        want = _rank_part(path, grads[path], case, rank)
        assert g.shape == want.shape, path
        assert_close_scaled(g.numpy(), want, **grad_tol)


def _shared_sums(case, ranks: list, m: int) -> dict:
    """The shared experts' gradients of the model index ``m``'s ranks,
    summed over the data ranks."""
    nd, nm = case[3]
    name = ranks_lib.moe_case_name(case)
    out = {}
    for d in range(nd):
        got = ranks[d * nm + m][name]["grads"]
        for path, g in zip(_paths(got), tree.flatten(got)):
            if path.startswith("shared/"):
                out[path] = out.get(path, 0) + g.numpy()
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c[4] != "gspmd"],
                         ids=[n for c, n in zip(CASES, NAMES)
                              if c[4] != "gspmd"])
def test_expert_parallel_matches_reference_and_single_process(runs, case):
    ranks, ref = runs
    name = ranks_lib.moe_case_name(case)
    nd, nm = case[3]
    # the single-process block on each data rank's rows (its capacity is
    # that of its T tokens, as in the reference's shard_map), the weights'
    # gradients summed over the data ranks
    shards = [_single(case, ranks_lib.moe_rank_slices(case, d * nm)[2])
              for d in range(nd)]
    y = np.concatenate([sh[0] for sh in shards])
    gx = np.concatenate([sh[2] for sh in shards])
    grads = {k: sum(sh[1][k] for sh in shards) for k in shards[0][1]}
    want = {k.split("/g/", 1)[1]: v for k, v in ref.items()
            if k.startswith(name + "/g/")}
    assert set(want) == set(grads)
    for r in range(P):
        got = ranks[r][name]
        _check(case, got, r, ref[f"{name}/y"], want, ref[f"{name}/gx"])
        _check(case, got, r, y, grads, gx)
        assert got["drops"] == shards[r // nm][3]
    tol = dict(rtol=0, atol_frac=2 ** -6) if case[1] == "bfloat16" else \
        dict(rtol=1e-4, atol_frac=1e-5)
    for m in range(nm):
        for path, g in _shared_sums(case, ranks, m).items():
            assert_close_scaled(g, want[path], **tol)
            assert_close_scaled(g, grads[path], **tol)
    # an experts group ends with the same bits on every rank
    for d in range(nd):
        group = [ranks[d * nm + m][name] for m in range(nm)]
        for key in ("y", "gx"):
            assert all(torch.equal(g[key], group[0][key]) for g in group)
        for path in ("router",) + tuple(f"shared/{w}" for w in
                                        ("w_down", "w_gate", "w_up")):
            pick = lambda g: dict(zip(_paths(g["grads"]),
                                      tree.flatten(g["grads"])))[path]
            if path == "router" or path in grads:
                assert all(torch.equal(pick(g), pick(group[0]))
                           for g in group)
    if case[2] is not None:
        assert all(sh[3] > 0 for sh in shards)


def test_gspmd_takes_the_single_process_path(runs):
    ranks, _ = runs
    (case,) = [c for c in CASES if c[4] == "gspmd"]
    name = ranks_lib.moe_case_name(case)
    y, grads, gx, drops = _single(case)
    for r in range(P):
        got = ranks[r][name]
        np.testing.assert_array_equal(got["y"].numpy(), y)
        np.testing.assert_array_equal(got["gx"].numpy(), gx)
        for path, g in zip(_paths(got["grads"]), tree.flatten(got["grads"])):
            np.testing.assert_array_equal(g.numpy(), grads[path])
        assert got["drops"] == drops and got["sums"] == 0


# ---------------------------------------------------------------------------
# the rules port: param_spec by path, in this process

FAMILIES = ["paper-lm-100m", "phi3-mini-3.8b", "qwen2.5-32b", "qwen3-32b",
            "gemma-2b", "deepseek-moe-16b", "kimi-k2-1t-a32b",
            "mamba2-370m", "zamba2-7b", "qwen2-vl-72b", "musicgen-large"]


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model"), ("data",)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_spec_matches_the_reference(arch, axes):
    """``param_spec`` of every path of the reduced arch's parameter tree (a
    spec depends on the mesh's axis names only), and ``dp_axis_names``, the
    reference's on a one-device mesh with the same names."""
    import types
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(
        (1,) * len(axes)), axes)
    jr = jrules.MeshRules(mesh=jmesh, rules=dict(jrules.DEFAULT_LOGICAL_RULES))
    tr = trules.MeshRules(mesh=types.SimpleNamespace(mesh_dim_names=axes),
                          rules=dict(trules.DEFAULT_LOGICAL_RULES))
    shapes = model_lib.param_shapes(tregistry.get_reduced(arch))
    jshapes = jax.tree.leaves(
        __import__("repro.models.model", fromlist=["x"]).param_shapes(
            jregistry.get_reduced(arch)),
        is_leaf=lambda x: isinstance(x, tuple))
    assert [tuple(s) for s in tree.flatten(shapes)] == \
        [tuple(s) for s in jshapes]
    for path, shape in zip(trules.tree_paths(shapes), tree.flatten(shapes)):
        got = trules.param_spec(path, len(shape), tr)
        want = jrules.param_spec(path, len(shape), jr)
        assert tuple(got) == tuple(want), (path, got, want)
    assert trules.dp_axis_names(tr.mesh) == jrules.dp_axis_names(jmesh)
