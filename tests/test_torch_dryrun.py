"""The port's dry run (repro_torch/launch/{dryrun,dryrun_lib,roofline}.py)
and the shapes it reads, against the reference's.

In this process: ``probe_plan``, ``solve_affine``, ``model_flops_per_token``,
``subquadratic``, ``applicable_shapes``, ``input_specs``, ``param_struct``
and ``cache_struct`` equal the reference's for every architecture and
shape (exactly: integers, shapes and dtypes; the flops and the solved
costs as the same float64 arithmetic); ``roofline_terms`` equals the
reference's formula with the H100 constants in place of its TPU ones;
``cost_of`` counts a matmul's flops and bytes and a collective's bytes;
``LiveBytes`` follows a small autograd graph.

In subprocesses (the pytest process joins no process group): the
reference's ``run_cell(..., mesh=jax.sharding.Mesh(...), smoke=True,
skip_probes=True)`` on a 2 x 4 ('data', 'model') mesh of 8 forced CPU
devices (paper-lm-100m train_4k and zamba2-7b decode_32k), and in one
port interpreter the CLI's ``main`` (``python -m repro_torch.launch.dryrun
--devices 8 --mesh 2x4:data,model --smoke``) for the same cells, each on
a fake process group of 8 ranks (train_4k with its probes).  Both exit
0; the port's report has every key of the reference's (those its probes
write read from ``run_cell``'s source); ``argument_bytes`` and ``alias_bytes`` are equal to the byte (373,100 and
371,052; 161,652 and 73,216).  (XLA drops arguments the step never reads,
``jax.jit``'s ``keep_unused=False``: the scheduled learning rate's stored
value, 4 bytes; the port counts only the arguments its step reads, so the
counts agree.)  ``train_state_shardings``' local shard shape of every
leaf of the reduced paper-lm-100m's Sketchy state on rank 0 equals the
reference's ``shard_shape`` on the same mesh.
"""
import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.launch import dryrun_lib as jdryrun
from repro.launch import roofline as jroofline
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.launch import dryrun_lib as tdryrun
from repro_torch.launch import roofline as troofline
from repro_torch.models import cache as tcache
from repro_torch.models import model as tmodel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(tregistry.ALIASES)
LIMIT_S = 240


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_flops_and_shapes_match_reference(arch):
    jc, tc = jregistry.get_config(arch), tregistry.get_config(arch)
    assert tdryrun.probe_plan(tc) == jdryrun.probe_plan(jc)
    assert tc.subquadratic == jc.subquadratic
    assert [s.name for s in tregistry.applicable_shapes(tc)] == \
        [s.name for s in jregistry.applicable_shapes(jc)]
    for seq in (1, 4096, 32768):
        for kw in (dict(training=True), dict(training=False),
                   dict(training=False, decode=True)):
            assert tc.model_flops_per_token(seq, **kw) == \
                jc.model_flops_per_token(seq, **kw)
    for name, shape in tregistry.SHAPES.items():
        jshape = jregistry.SHAPES[name]
        assert dataclasses.astuple(shape) == dataclasses.astuple(jshape)
        got = tregistry.input_specs(tc, shape, batch_override=4)
        want = jregistry.input_specs(jc, jshape, batch_override=4)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
    want = jax.tree.leaves(jmodel.param_struct(jc))
    got = tree.flatten(tmodel.param_struct(tc))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1], t.device.type)
            for t in got] == [(w.shape, w.dtype.name, "meta") for w in want]
    want = jcache.cache_struct(jc, 4, 64)
    got = tcache.cache_struct(tc, 4, 64)
    assert sorted(got) == sorted(want)
    for k in want:
        assert (tuple(got[k].shape), str(got[k].dtype).split(".")[-1],
                got[k].device.type) == (want[k].shape, want[k].dtype.name,
                                        "meta")


def test_solve_affine_and_roofline_terms_match_reference(monkeypatch):
    rng = np.random.default_rng(0)
    counts = [(1, 1), (2, 2), (2, 1)]
    costs = [dict(flops=float(rng.integers(1, 10 ** 9)),
                  bytes_accessed=float(rng.integers(1, 10 ** 9)),
                  coll={k: float(rng.integers(0, 10 ** 6))
                        for k in troofline.COLLECTIVE_OPS + ("total",)})
             for _ in counts]
    want = jroofline.solve_affine(counts, [jroofline.ProbeCost(**c)
                                           for c in costs], (81, 14))
    got = troofline.solve_affine(counts, [troofline.ProbeCost(**c)
                                          for c in costs], (81, 14))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the reference's formula with the card's constants in its TPU ones
    monkeypatch.setattr(jroofline, "PEAK_FLOPS", 989e12)
    monkeypatch.setattr(jroofline, "HBM_BW", 3.35e12)
    monkeypatch.setattr(jroofline, "ICI_BW", 450e9)
    assert troofline.roofline_terms(got) == jroofline.roofline_terms(want)
    assert (troofline.PEAK_FLOPS, troofline.HBM_BYTES_PER_S,
            troofline.NVLINK_BYTES_PER_S) == (989e12, 3.35e12, 450e9)


def test_cost_of_counts_flops_bytes_and_views():
    a = torch.randn(8, 16, device="meta")
    b = torch.randn(16, 4, device="meta")
    cost = troofline.cost_of(lambda: (a @ b).t().contiguous())
    # matmul 2 * 8 * 16 * 4; bytes: a, b and the product, then the copy
    # of the transposed product (read and written); the view moves none
    assert cost.flops == 2 * 8 * 16 * 4
    assert cost.bytes_accessed == 4 * (8 * 16 + 16 * 4 + 8 * 4 + 2 * 32)
    assert cost.coll["total"] == 0.0


def test_live_bytes_follow_an_autograd_graph():
    w = torch.randn(64, 64, requires_grad=True)
    x = torch.randn(32, 64)
    unread = torch.empty(3)
    live = troofline.LiveBytes()
    live.start([w, x, unread])
    with live:
        h = torch.tanh(x @ w)        # the product is freed, tanh's output
        y = (h * h).sum()            # saved for the backward
        assert live.live == 32 * 64 * 4 + 4
        y.backward()                 # + w.grad
        assert live.live == 32 * 64 * 4 + 4 + 64 * 64 * 4
        del h, y
    assert live.live == 64 * 64 * 4
    assert live.was_read(w) and live.was_read(x)
    assert not live.was_read(unread)


# ---------------------------------------------------------------------------
# subprocesses: the reference's run_cell and the port's CLI

_REFERENCE = r"""
import json, sys
import jax, numpy as np
from repro.configs import registry
from repro.core.factory import OptimizerConfig, make_optimizer
from repro.launch.dryrun_lib import run_cell
from repro.models import model
from repro.sharding import rules
from repro.train import trainer
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
out = {"train": run_cell("paper-lm-100m", "train_4k", mesh=mesh, smoke=True,
                         skip_probes=True),
       "decode": run_cell("zamba2-7b", "decode_32k", mesh=mesh, smoke=True,
                          skip_probes=True)}
cfg = registry.get_reduced("paper-lm-100m")
ps = model.param_struct(cfg)
tx = make_optimizer(OptimizerConfig(name="sketchy", rank=8, block_size=32,
                                    update_every=10, total_steps=10000))
st = jax.eval_shape(tx.init, ps)
with rules.use_mesh(mesh) as r:
    osh = trainer.train_state_shardings(st, ps, r)
    out["local"] = [list(sh.shard_shape(l.shape)) for l, sh in zip(
        jax.tree.leaves(st), jax.tree.leaves(
            osh, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding)))]
json.dump(out, open(sys.argv[1], "w"), default=float)
"""

_PORT = r"""
import json, sys
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.factory import OptimizerConfig, make_optimizer
from repro_torch.launch import dryrun_lib, mesh as mesh_lib
from repro_torch.models import model
from repro_torch.sharding import rules
from repro_torch.train import checkpoint, trainer
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = mesh_lib.make_mesh((2, 4), ("data", "model"), device_type="cpu")
cfg = registry.get_reduced("paper-lm-100m")
ps = model.param_struct(cfg)
tx = make_optimizer(OptimizerConfig(name="sketchy", rank=8, block_size=32,
                                    update_every=10, total_steps=10000))
st = tx.init(tree.flatten(ps))
out = []
with rules.use_mesh(mesh) as r:
    osh = dryrun_lib._flat_shardings(trainer.train_state_shardings(st, ps, r))
    for leaf, sh in zip(checkpoint.leaves(st), osh):
        x = leaf.value
        out.append([] if isinstance(x, int) else
                   list(rules.place(x, sh).to_local().shape))
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
# the CLI, each cell in turn (each joins and leaves its own fake group)
from repro_torch.launch import dryrun
for i in range(2, len(sys.argv), 2):
    dryrun.main(json.loads(sys.argv[i]) + ["--out", sys.argv[i + 1]])
"""

CLI = ["--devices", "8", "--mesh", "2x4:data,model", "--smoke"]
CELLS = {"train": ["--arch", "paper-lm-100m", "--shape", "train_4k"],
         "decode": ["--arch", "zamba2-7b", "--shape", "decode_32k",
                    "--skip-probes"]}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(REPO, "src")
    port_env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    port_env.update(PYTHONPATH=src, OMP_NUM_THREADS="1")
    jax_env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")
    port = [sys.executable, "-c", _PORT, str(out / "local.json")]
    for name, cell in CELLS.items():
        port += [json.dumps(CLI + cell), str(out / f"{name}.json")]
    runs = {"reference": ([sys.executable, "-c", _REFERENCE,
                           str(out / "reference.json")], jax_env),
            "port": (port, port_env)}
    procs = {name: subprocess.Popen(cmd, env=env, cwd=REPO,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (cmd, env) in runs.items()}
    logs = {}
    try:
        for name, proc in procs.items():
            logs[name] = proc.communicate(timeout=LIMIT_S)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        assert proc.returncode == 0, f"{name}:\n{logs.get(name, '')[-4000:]}"
    return {name: json.loads((out / f"{name}.json").read_text())
            for name in ["reference", "local", *CELLS]}


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_bytes_equal_the_reference(reports, cell):
    got, want = reports[cell]["full"], reports["reference"][cell]["full"]
    assert (got["argument_bytes"], got["alias_bytes"]) == \
        (want["argument_bytes"], want["alias_bytes"])
    assert got["argument_bytes"] == {"train": 373_100,
                                     "decode": 161_652}[cell]
    assert got["peak_bytes_per_device"] == \
        got["argument_bytes"] + got["output_bytes"] + got["temp_bytes"] \
        - got["alias_bytes"]


def _reference_report_keys() -> set:
    """Every key the reference's ``run_cell`` writes into its report."""
    return set(re.findall(r'report\["(\w+)"\]',
                          inspect.getsource(jdryrun.run_cell)))


@pytest.mark.parametrize("cell", list(CELLS))
def test_cli_report_has_the_reference_keys(reports, cell):
    got, want = reports[cell], reports["reference"][cell]
    assert set(want) <= set(got)
    assert set(want["full"]) <= set(got["full"])
    for k in ("arch", "shape", "mesh", "axes", "chips", "optimizer", "kind"):
        assert got[k] == want[k], k
    if cell == "train":      # the probes ran (the reference's skipped)
        assert _reference_report_keys() <= set(got)
        assert set(got["cost"]["collective_bytes_per_device"]) == \
            set(troofline.COLLECTIVE_OPS) | {"total"}
        assert set(got["roofline"]) == set(jroofline.roofline_terms(
            jroofline.ProbeCost(1.0, 1.0, {"total": 1.0})))
        assert got["model_flops_total"] == \
            jregistry.get_reduced("paper-lm-100m").model_flops_per_token(
                64, training=True) * 8 * 64
        # the data-parallel step all-reduces the gradients over 'data'
        assert got["cost"]["collective_bytes_per_device"]["all-reduce"] > 0
        assert got["roofline"]["bound_s"] > 0


def test_train_state_local_shards_equal_the_reference(reports):
    assert reports["local"] == reports["reference"]["local"]
