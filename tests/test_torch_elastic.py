"""The port's repro_torch/train/elastic.py and launch/mesh.py against the
reference's repro/train/elastic.py and launch/mesh.py.

``StragglerMonitor`` (:128): both monitors read a fake clock that
advances by each step's time between ``start`` and ``stop``, so the test
does not depend on how busy the host is (the reference's own test times
real sleeps of a few milliseconds).  They must flag the same steps, return
the same times and report the same median: the arithmetic is the same, so
exactly.

``plan_mesh`` (:35) is arithmetic: the same plan for every input of a
grid, and the same refusal.  ``merge_sketches_on_shrink`` (:94) on the same
numpy states as the reference's (mirroring
tests/test_distributed.py::test_merge_sketches_on_shrink): the merged
sketches by covariance, ladder and rho with ``assert_close_scaled`` (the FD
merge's tolerance in tests/test_torch_distributed.py), the other leaves
passed through from the first state.

On four gloo ranks (tests/torch_mesh_ranks.py's ``elastic`` scenario; one
JAX interpreter with 4 host devices runs the reference beside them):
``make_mesh`` places rank r where ``jax.make_mesh`` puts device r, and a
world of another size raises; ``remesh`` (mirroring :71) builds the 2 x 2
plan of 4 ranks and the 1 x 2 plan of the shrink to 2, which ranks 2 and 3
do not get; ``remesh_opt_state`` (mirroring :285, 8 -> 4 devices there,
4 -> 2 ranks here) of a Sketchy state of the reduced deepseek-moe-16b, fp32
and int8 storage: every rank's local shard of every parameter, pooled
stack and per-parameter leaf equals, bit for bit, the slice that the
reference's sharding (``tree_param_shardings``, ``blocks_sharding``) gives
its device on the same plan, and the DTensors' ``full_tensor`` is the whole
state again.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks_lib
import torch_ranks
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.core import api as japi
from repro.core import fd as jfd
from repro.train import elastic as jelastic
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import fd as tfd
from repro_torch.models import model as model_lib
from repro_torch.sharding import rules as trules
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import elastic as telastic


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _sequences() -> dict:
    rng = np.random.default_rng(0)
    base = 0.010 + 1e-4 * (np.arange(40) % 3)
    spiky = base.copy()
    spiky[[12, 25, 26, 39]] = [0.5, 0.05, 0.0101, 0.2]
    return {
        "uniform": list(base),
        "spiky": list(spiky),
        "noisy": list(0.02 + 0.002 * rng.standard_normal(80)),
        "drift": list(np.linspace(0.01, 0.03, 60)),
        "heavy_tail": list(0.01 * (1 + rng.pareto(3.0, 120))),
        "short": [0.01] * 9 + [1.0],
    }


@pytest.mark.parametrize("window,k", [(50, 6.0), (20, 3.0), (10, 1.0)])
@pytest.mark.parametrize("name", list(_sequences()))
def test_straggler_monitor_matches_reference(monkeypatch, name, window, k):
    clock = _Clock()
    monkeypatch.setattr(telastic, "_clock", clock)
    monkeypatch.setattr(jelastic, "time",
                        types.SimpleNamespace(perf_counter=clock))
    got = telastic.StragglerMonitor(window=window, k=k)
    want = jelastic.StragglerMonitor(window=window, k=k)
    flagged = []
    for dt in _sequences()[name]:
        got.start()
        want.start()
        clock.now += dt
        assert got.stop() == want.stop()
        assert got.flagged == want.flagged
        flagged.append(got.flagged)
    assert got.times == want.times
    assert got.flagged == want.flagged
    assert got.median == want.median
    if name == "spiky" and k == 6.0:
        # the 0.5 s, 50 ms and 0.2 s steps, not the normal step after 50 ms
        assert np.flatnonzero(np.diff([0] + flagged)).tolist() == \
            [12, 25, 39]
    if name == "uniform":
        assert got.flagged == 0


def test_straggler_monitor_needs_start():
    with pytest.raises(AssertionError):
        telastic.StragglerMonitor().stop()
    assert telastic.StragglerMonitor().median == 0.0


# ---------------------------------------------------------------------------
# plan_mesh, merge_sketches_on_shrink: in this process


@pytest.mark.parametrize("devices,mp,batch,pods", [
    (8, 2, 64, 1), (6, 2, 64, 1), (4, 2, 8, 1), (2, 2, 8, 1), (7, 2, 64, 1),
    (5, 1, 8, 1), (16, 4, 30, 2), (12, 2, 7, 2), (3, 4, 8, 1),
    (2, 1, 1, 2), (256, 16, 1024, 1), (512, 16, 1000, 2)])
def test_plan_mesh_matches_the_reference(devices, mp, batch, pods):
    kw = dict(model_parallel=mp, target_global_batch=batch, pods=pods)
    try:
        want = jelastic.plan_mesh(devices, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            telastic.plan_mesh(devices, **kw)
        return
    got = telastic.plan_mesh(devices, **kw)
    assert (got.mesh_shape, got.axis_names, got.global_batch, got.note) \
        == (want.mesh_shape, want.axis_names, want.global_batch, want.note)


def test_merge_sketches_on_shrink_matches_the_reference():
    rng = np.random.default_rng(0)
    d, ell, N = 12, 4, 2

    def mk_stack():
        U = np.linalg.qr(rng.normal(size=(d, ell)))[0]
        s = np.sort(rng.uniform(1, 2, size=ell))[::-1]
        s[-1] = 0.0
        return (np.stack([U] * N).astype(np.float32),
                np.stack([s] * N).astype(np.float32),
                rng.uniform(0, 1, size=N).astype(np.float32))

    stacks = [mk_stack() for _ in range(3)]
    counts = [np.int32(i + 5) for i in range(3)]
    tag = lambda st: jfd.FDState(*(japi.tag(jnp.asarray(x), "second_moment",
                                            blocked=True) for x in st))
    want = jelastic.merge_sketches_on_shrink(
        [{"pool": tag(st), "n": jnp.asarray(c)}
         for st, c in zip(stacks, counts)])
    got = telastic.merge_sketches_on_shrink(
        [{"pool": tfd.FDState(*map(torch.from_numpy, st)),
          "n": torch.tensor(c)} for st, c in zip(stacks, counts)])
    assert int(got["n"]) == 5                  # from the first state
    wu = jfd.FDState(*japi.untag(list(want["pool"])))
    U, s, rho = (x.numpy().astype(np.float64) for x in got["pool"])
    cov = lambda U, s: np.einsum("nde,ne,nfe->ndf", U, s, U)
    assert_close_scaled(cov(U, s), cov(np.asarray(wu.eigvecs, np.float64),
                                       np.asarray(wu.eigvals, np.float64)))
    assert_close_scaled(s, wu.eigvals)
    lad = max(float(np.abs(np.asarray(wu.eigvals)).max()),
              float(np.abs(np.asarray(wu.rho)).max()))
    assert_close_scaled(rho, wu.rho, scale=lad)
    # one state passes through as it is
    one = {"pool": tfd.FDState(*map(torch.from_numpy, stacks[0]))}
    assert telastic.merge_sketches_on_shrink([one]) is one


# ---------------------------------------------------------------------------
# meshes and remesh_opt_state on four gloo ranks

P = ranks_lib.WORLD
LIMIT_S = 120

# the reference's side, with 4 host devices: the device ids of its meshes
# and, for each plan, the slice of every leaf each device holds
_REFERENCE = r"""
import json, sys
import jax, numpy as np
from jax import ShapeDtypeStruct as S
from repro.sharding import rules
from repro.train.elastic import plan_mesh, remesh
spec = json.load(open(sys.argv[1]))

def ids(mesh):
    return np.vectorize(lambda d: d.id)(mesh.devices).tolist()

def slices(sh, shape):
    out = {}
    for dev, idx in sh.devices_indices_map(tuple(shape)).items():
        out[dev.id] = [[s.start or 0, shape[i] if s.stop is None else s.stop]
                       for i, s in enumerate(idx)]
    return out

def shapes(tree):
    if isinstance(tree, dict):
        return {k: shapes(v) for k, v in tree.items()}
    return S(tuple(tree), np.float32)

out = {"make_mesh": ids(jax.make_mesh((2, 2), ("data", "model"))),
       "host": ids(jax.make_mesh((4,), ("data",)))}
for devices, mp, batch in spec["plans"]:
    mesh = remesh(plan_mesh(devices, model_parallel=mp,
                            target_global_batch=batch))
    mr = rules.MeshRules(mesh=mesh, rules=dict(rules.DEFAULT_LOGICAL_RULES))
    psh = jax.tree.leaves(rules.tree_param_shardings(
        shapes(spec["params"]), mr),
        is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    flat = jax.tree.leaves(spec["params"], is_leaf=lambda x: isinstance(
        x, list))
    leaves = {}
    for name, shape, kind, index in spec["leaves"]:
        if kind == "pooled":
            sh = rules.blocks_sharding(mr, S(tuple(shape), np.float32))
        elif kind == "param" or (kind == "per_param"
                                 and list(shape) == flat[index]):
            sh = psh[index]
        else:
            sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        leaves[name] = slices(sh, shape)
    specs = lambda shs: [list(sh.spec) for sh in jax.tree.leaves(
        shs, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]
    out[str(devices)] = {
        "ids": ids(mesh), "leaves": leaves,
        "blocks": [list(rules.blocks_sharding(mr, S((n, 3), np.float32))
                        .spec) for n in range(1, 10)],
        "families": {arch: specs(rules.tree_param_shardings(shapes(tree),
                                                            mr))
                     for arch, tree in spec["families"].items()}}
json.dump(out, open(sys.argv[2], "w"))
"""


def _leaf_kinds(storage: str) -> list:
    """(name, shape, kind, parameter index) of every tensor the placed
    (params, state) pair holds, in ``checkpoint.leaves`` order."""
    params, state = ranks_lib.elastic_state(storage)
    out = []
    for leaf in tckpt.leaves((params, state)):
        if not isinstance(leaf.value, torch.Tensor):
            continue
        shape = list(leaf.value.shape)
        per = telastic._PER_PARAM.search(leaf.name)
        if leaf.name.startswith("0::"):
            kind, index = "param", len([x for x in out
                                        if x[2] == "param"])
        elif telastic._POOLED.search(leaf.name):
            kind, index = "pooled", None
        elif per and leaf.role not in ("count", "hyperparam"):
            kind, index = "per_param", int(per.group(1))
        else:
            kind, index = "replicated", None
        out.append((leaf.name, shape, kind, index))
    return out


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """(each rank's results, the reference's, the leaf kinds by storage)."""
    out = tmp_path_factory.mktemp("elastic")
    kinds = {s: _leaf_kinds(s) for s in ("fp32", "int8")}
    spec = dict(plans=ranks_lib.ELASTIC_PLANS,
                params=_shape_tree(ranks_lib.elastic_params()),
                leaves=[k for s in kinds.values() for k in s],
                families={arch: _shape_tree(model_lib.param_shapes(
                    registry.get_reduced(arch))) for arch in FAMILIES})
    (out / "spec.json").write_text(json.dumps(spec))
    procs = torch_ranks.start_ranks(ranks_lib.__file__, ["elastic"], P, out)
    procs.append(torch_ranks.start_jax(
        _REFERENCE, [out / "spec.json", out / "ref.json"], 4, out))
    torch_ranks.wait_all(procs, out, LIMIT_S)
    ref = json.loads((out / "ref.json").read_text())
    return torch_ranks.load_ranks(out, P), ref, kinds


def _shape_tree(params):
    if isinstance(params, dict):
        return {k: _shape_tree(v) for k, v in params.items()}
    return list(params.shape if isinstance(params, torch.Tensor)
                else params)


# a reduced arch of each family (and the dense ones with a feature of
# their own)
FAMILIES = ["paper-lm-100m", "phi3-mini-3.8b", "qwen2.5-32b", "gemma-2b",
            "deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-370m",
            "zamba2-7b", "qwen2-vl-72b", "musicgen-large"]


def _json_spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _rules(devices: int):
    """The port's rules over a stand-in of the plan's mesh: the specs
    depend on the dimensions' names and sizes alone."""
    plan = telastic.plan_mesh(devices, model_parallel=2,
                              target_global_batch=8)
    mesh = types.SimpleNamespace(mesh_dim_names=plan.axis_names,
                                 shape=plan.mesh_shape)
    return trules.MeshRules(mesh=mesh,
                            rules=dict(trules.DEFAULT_LOGICAL_RULES))


@pytest.mark.parametrize("devices", [4, 2])
def test_shardings_of_every_family_and_stack_match_the_reference(placed,
                                                                 devices):
    """``tree_param_shardings`` (``param_spec`` and ``enforce_divisible``)
    of each family's reduced tree, and ``blocks_sharding`` of N = 1..9
    blocks (model-major over both axes, then fsdp alone, then replicated),
    the reference's specs on the same plan."""
    ref = placed[1][str(devices)]
    mr = _rules(devices)
    for arch in FAMILIES:
        shapes = model_lib.param_shapes(registry.get_reduced(arch))
        leaves = [torch.empty(s, device="meta") for s in
                  tree.flatten(shapes)]
        got = trules.tree_param_shardings(tree.unflatten(shapes, leaves),
                                          mr)
        assert [_json_spec(sh.spec) for sh in tree.flatten(got)] == \
            ref["families"][arch], arch
    got = [_json_spec(trules.blocks_sharding(
        mr, torch.empty(n, 3, device="meta")).spec) for n in range(1, 10)]
    assert got == ref["blocks"]
    # every branch taken (on the 1 x 2 plan fsdp's extent 1 divides all)
    assert {str(x) for x in got} == {"[['model', 'data'], None]",
                                     "['data', None]"} | (
        {"[None, None]"} if devices == 4 else set())


def test_meshes_place_ranks_as_jax_places_devices(placed):
    got, ref, _ = placed
    for r, res in enumerate(got):
        assert res["host"] == (ref["host"], ("data",))
        assert res["grid"] == (ref["make_mesh"], (r // 2, r % 2))
        assert "needs 3 ranks" in res["wrong_world"]
        assert "needs 256 ranks" in res["production"]


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_remesh_builds_the_plans(placed, storage):
    """As tests/test_distributed.py::test_elastic_plan_and_remesh: the
    4-rank plan is 2 x 2 over ranks 0-3, the 2-rank plan 1 x 2 over ranks
    0-1, and ranks 2 and 3 get no mesh."""
    got, ref, _ = placed
    assert ref["4"]["ids"] == [[0, 1], [2, 3]] and ref["2"]["ids"] == [[0, 1]]
    for r, res in enumerate(got):
        assert res[f"coord_{storage}_4"] == (r // 2, r % 2)
        assert res[f"coord_{storage}_2"] == ((0, r) if r < 2 else None)
        assert (f"{storage}_2" in res) == (r < 2)


@pytest.mark.parametrize("devices", [4, 2])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_remesh_opt_state_holds_the_reference_blocks(placed, storage,
                                                     devices):
    got, ref, kinds = placed
    leaves = ref[str(devices)]["leaves"]
    key = f"{storage}_{devices}"
    whole = got[0][f"whole_{storage}"]
    for r, res in enumerate(got[:devices]):
        assert res[f"full_{key}"] is True
        assert list(res[key]) == [name for name, *_ in kinds[storage]]
        for name, *_ in kinds[storage]:
            local = res[key][name][0]
            want = whole[name][tuple(slice(a, b)
                                     for a, b in leaves[name][str(r)])]
            assert local.dtype == want.dtype, name
            assert torch.equal(local, want), (name, r)
    spread = 0
    for name, shape, kind, _ in kinds[storage]:
        rows = sorted({tuple(v[0]) for v in leaves[name].values()})
        if kind == "pooled" and len(rows) == devices:
            # the blocks dim over both axes: the ranks hold every block once
            spread += 1
            assert rows[0][0] == 0 and rows[-1][1] == shape[0]
            assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert spread > 0
