"""One rank of the gloo process group that tests/test_torch_compression.py,
tests/test_torch_elastic.py and tests/test_torch_moe_ep.py each start,
four fresh interpreters a file:

    python tests/torch_mesh_ranks.py SCENARIO RANK WORLD RENDEZVOUS OUT_DIR

It imports no JAX and nothing of ``repro``: PyTorch, numpy and the port.
The rank runs on one CPU thread, joins the group through a file
rendezvous, runs its scenario on CPU meshes and saves what it computed to
``OUT_DIR/rank-<RANK>.pt``; the test functions hold that against the
reference.  The inputs come from numpy seeds, the same on every rank (the
tests import this module for them).  Scenarios:

  * ``compression``: ``compressed_mean_grads`` and ``quantized_psum`` over
    the 4 ranks on replicated and on per-rank gradients (stochastic, to
    nearest, over two axes, over many seeds) and the pass-through of a
    mesh with no data axis;
  * ``elastic``: ``make_mesh`` and its relatives, ``remesh`` of the
    4-rank plan and of the 2-rank plan of the shrink, and
    ``remesh_opt_state`` of a Sketchy state (fp32 and int8 storage) of the
    reduced deepseek-moe-16b on both: each rank's local shards;
  * ``moe_ep``: the moe block's expert-parallel forward and gradients on
    (1, 4) and (2, 2) meshes (MOE_CASES), and ``moe_impl="gspmd"``.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import convert, tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import sketchy as tsk  # noqa: E402
from repro_torch.distributed import reduce as dreduce  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression, elastic  # noqa: E402

WORLD = 4
F32 = np.float32

# ---------------------------------------------------------------------------
# compression


COMPRESS_DRAWS = 300


def compression_inputs() -> dict:
    """``replicated``: the reference test's gradients; ``per_rank``: each
    rank's own (WORLD, ...) of leaves of different magnitudes on different
    ranks, a bf16 one (given as f32 values that bf16 holds) and a zero
    one; ``draw``: the (WORLD, 6, 7) leaf of the unbiasedness test."""
    rng = np.random.default_rng(0)
    replicated = {"a": rng.normal(size=(64, 32)).astype(F32),
                  "b": rng.normal(size=(128,)).astype(F32)}
    rng = np.random.default_rng(1)
    spread = np.array([1.0, 0.5, 3.0, 0.1])
    per_rank = {
        "a": (rng.normal(size=(WORLD, 16, 8)) * spread[:, None, None]
              ).astype(F32),
        "b": rng.normal(size=(WORLD, 33)).astype(F32) * 1e-3,
        "c": torch.from_numpy(rng.normal(size=(WORLD, 5, 4)).astype(F32))
        .bfloat16().float().numpy(),
        "z": np.zeros((WORLD, 3), F32),
    }
    draw = rng.normal(size=(WORLD, 6, 7)).astype(F32)
    return dict(replicated=replicated, per_rank=per_rank, draw=draw)


def _mine(per_rank: dict, rank: int) -> dict:
    return {k: torch.from_numpy(v[rank].copy()).to(
        torch.bfloat16 if k == "c" else torch.float32)
        for k, v in per_rank.items()}


def run_compression(rank: int) -> dict:
    x = compression_inputs()
    out = {}
    host = mesh_lib.make_host_mesh(device_type="cpu")
    pods = mesh_lib.make_mesh((2, 2), ("pod", "data"), device_type="cpu")
    model = mesh_lib.make_mesh((WORLD,), ("model",), device_type="cpu")
    rep = {k: torch.from_numpy(v) for k, v in x["replicated"].items()}
    out["replicated"] = compression.compressed_mean_grads(rep, host)
    mine = _mine(x["per_rank"], rank)
    out["stochastic"] = compression.compressed_mean_grads(mine, host,
                                                          seed=0)
    out["stochastic_seed1"] = compression.compressed_mean_grads(
        mine, host, seed=1)
    with dreduce.bind_axis("data", host.get_group("data")):
        out["nearest"] = {k: compression.quantized_psum(g, ("data",))
                          for k, g in mine.items()}
        out["int8_sum"] = {k: compression.int8_sum(g, ("data",))
                           for k, g in mine.items()}
        out["exact"] = {k: g.float() for k, g in zip(
            mine, dreduce.pmean([g.float() for g in mine.values()],
                                "data"))}
        dreduce.merge_log = []
        compression.compressed_mean_grads(mine, host)
        out["log"] = [dict(r) for r in dreduce.merge_log]
        dreduce.merge_log = None
    with dreduce.bind_axis("pod", pods.get_group("pod")), \
            dreduce.bind_axis("data", pods.get_group("data")):
        out["two_axes_nearest"] = {
            k: compression.quantized_psum(g, ("pod", "data"))
            for k, g in mine.items()}
    out["two_axes"] = compression.compressed_mean_grads(
        mine, pods, dp_axes=("pod", "data"), seed=0)
    out["list"] = compression.compressed_mean_grads(list(mine.values()),
                                                    host, seed=0)
    out["pass_through"] = compression.compressed_mean_grads(
        mine, model) is mine
    draw = torch.from_numpy(x["draw"][rank].copy())
    out["draws"] = torch.stack([
        compression.compressed_mean_grads([draw], host, seed=s)[0]
        for s in range(COMPRESS_DRAWS)])
    return out


# ---------------------------------------------------------------------------
# elastic

ELASTIC_ARCH = "deepseek-moe-16b"
ELASTIC_SKETCHY = dict(block_size=32, rank=4)
# (devices, model_parallel, target_global_batch): the 4-rank plan and the
# 2-rank plan of the shrink
ELASTIC_PLANS = [(4, 2, 8), (2, 2, 8)]


def elastic_params() -> dict:
    """The reduced arch's parameters (f32) from a numpy seed."""
    cfg = dataclasses.replace(registry.get_reduced(ELASTIC_ARCH),
                              dtype="float32")
    rng = np.random.default_rng(3)
    shapes = model_lib.param_shapes(cfg)
    return tree.unflatten(shapes, [
        torch.from_numpy(rng.normal(size=s).astype(F32))
        for s in tree.flatten(shapes)])


def elastic_state(storage: str):
    """(parameters, a Sketchy state after one refresh on numpy gradients):
    every pooled block's sketch its own."""
    params = elastic_params()
    flat = tree.flatten(params)
    rng = np.random.default_rng(4)
    grads = [torch.from_numpy(rng.normal(size=p.shape).astype(F32))
             for p in flat]
    k = ELASTIC_SKETCHY["rank"]
    tx = tsk.sketchy(tsk.SketchyConfig(
        rank_budget=tsk.RankBudget(min_k=k, max_k=k),
        block_size=ELASTIC_SKETCHY["block_size"], update_every=1,
        second_moment_dtype=storage))
    _, state = tx.update(grads, tx.init(flat), flat)
    return params, state


def _locals(placed) -> dict:
    """name -> (local shard, placements) of every DTensor of a placed
    (params, state) pair, in ``checkpoint.leaves`` order."""
    out = {}
    for leaf in ckpt.leaves(placed):
        if isinstance(leaf.value, torch.Tensor):
            out[leaf.name] = (leaf.value.to_local().clone(),
                              repr(list(leaf.value.placements)))
    return out


def _full_equal(placed, whole) -> bool:
    """Every DTensor's ``full_tensor()`` (a collective over its mesh) equals
    the whole tensor it was placed from: the placements say what the local
    shards hold."""
    got = [x.value for x in ckpt.leaves(placed)
           if isinstance(x.value, torch.Tensor)]
    want = [x.value for x in ckpt.leaves(whole)
            if isinstance(x.value, torch.Tensor)]
    return len(got) == len(want) and all(
        torch.equal(g.full_tensor(), w) for g, w in zip(got, want))


def run_elastic(rank: int) -> dict:
    out = {}
    host = mesh_lib.make_host_mesh(device_type="cpu")
    grid = mesh_lib.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    out["host"] = (host.mesh.tolist(), host.mesh_dim_names)
    out["grid"] = (grid.mesh.tolist(), grid.get_coordinate())
    for name, fn in (("wrong_world", lambda: mesh_lib.make_mesh(
            (3,), ("data",), device_type="cpu")),
            ("production", lambda: mesh_lib.make_production_mesh(
                device_type="cpu"))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    for storage in ("fp32", "int8"):
        params, state = elastic_state(storage)
        out[f"whole_{storage}"] = {
            leaf.name: leaf.value.clone() for leaf in ckpt.leaves(
                (params, state)) if isinstance(leaf.value, torch.Tensor)}
        for devices, mp, batch in ELASTIC_PLANS:
            plan = elastic.plan_mesh(devices, model_parallel=mp,
                                     target_global_batch=batch)
            mesh = elastic.remesh(plan, device_type="cpu")
            key = f"{storage}_{devices}"
            out[f"coord_{key}"] = None if mesh is None else \
                mesh.get_coordinate()
            if mesh is None:
                continue
            placed = elastic.remesh_opt_state(state, params, mesh)
            out[key] = _locals(placed)
            out[f"full_{key}"] = _full_equal(placed, (params, state))
    return out


# ---------------------------------------------------------------------------
# the moe block's expert-parallel path

MOE_B, MOE_S = 2, 16
# (arch, dtype, capacity factor (None: the config's), mesh (data, model),
# moe_impl)
MOE_CASES = [
    ("deepseek-moe-16b", "float32", None, (1, 4), "auto"),
    ("deepseek-moe-16b", "float32", 1.25, (1, 4), "auto"),
    ("kimi-k2-1t-a32b", "float32", None, (1, 4), "auto"),
    ("kimi-k2-1t-a32b", "float32", 1.25, (1, 4), "auto"),
    ("deepseek-moe-16b", "bfloat16", 1.25, (1, 4), "auto"),
    ("kimi-k2-1t-a32b", "bfloat16", None, (1, 4), "auto"),
    ("deepseek-moe-16b", "float32", 1.25, (2, 2), "auto"),
    ("deepseek-moe-16b", "float32", None, (1, 4), "gspmd"),
]


def moe_case_name(case) -> str:
    arch, dtype, cf, (nd, nm), impl = case
    return f"{arch}-{dtype}-cf{cf}-{nd}x{nm}-{impl}"


def moe_config(case):
    arch, dtype, cf, _, impl = case
    cfg = registry.get_reduced(arch)
    kw = dict(dtype=dtype, moe_impl=impl)
    if cf is not None:
        kw["capacity_factor"] = cf
    return dataclasses.replace(cfg, **kw)


def moe_inputs(case, seed: int = 11) -> tuple:
    """(block parameters, x (B, S, D), loss weights (B, S, D)) as f32 numpy,
    values the case's dtype holds; with a capacity factor, a direction all
    tokens share crowds the same experts, so some assignments drop."""
    cfg = moe_config(case)
    rng = np.random.default_rng(seed)
    shapes = tmoe.moe_params_shape(cfg)
    leaves = [rng.normal(size=s).astype(F32) * s[-2] ** -0.5
              for s in tree.flatten(shapes)]
    x = rng.normal(size=(MOE_B, MOE_S, cfg.d_model)).astype(F32)
    if case[2] is not None:
        x += 2 * rng.normal(size=cfg.d_model).astype(F32)
    w = rng.normal(size=x.shape).astype(F32)
    if case[1] == "bfloat16":
        held = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
        leaves, x = [held(a) for a in leaves], held(x)
    return tree.unflatten(shapes, leaves), x, w


def moe_rank_slices(case, rank: int) -> tuple:
    """(data index, model index, batch rows) of ``rank`` on the case's
    mesh, row-major."""
    nd, nm = case[3]
    d, m = divmod(rank, nm)
    rows = MOE_B // nd
    return d, m, slice(d * rows, (d + 1) * rows)


def run_moe_ep(rank: int) -> dict:
    out = {}
    meshes = {}
    drops = []
    tables = tmoe._slot_tables

    def counted(E, k, capacity, gate_w, gate_idx, T):
        got = tables(E, k, capacity, gate_w, gate_idx, T)
        drops.append(int((got[2] == E * capacity).sum()))
        return got

    tmoe._slot_tables = counted
    for case in MOE_CASES:
        shape = case[3]
        if shape not in meshes:
            meshes[shape] = mesh_lib.make_mesh(shape, ("data", "model"),
                                               device_type="cpu")
        cfg = moe_config(case)
        dtype = model_lib.DTYPES[cfg.dtype]
        params, x, w = moe_inputs(case)
        d, m, rows = moe_rank_slices(case, rank)
        whole = tree.unflatten(params, [torch.from_numpy(a).to(dtype)
                                        for a in tree.flatten(params)])
        mine = whole if case[4] == "gspmd" else \
            convert.expert_parallel_shard({"moe": whole}, m, shape[1],
                                          fsdp_rank=d,
                                          n_fsdp=shape[0])["moe"]
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in tree.flatten(mine)]
        xt = torch.from_numpy(x[rows].copy()).to(dtype).requires_grad_(True)
        drops.clear()
        dreduce.merge_log = []
        with rules.use_mesh(meshes[shape]):
            y = tmoe.moe_block(cfg, tree.unflatten(mine, leaves), xt)
            loss = (y.float() * torch.from_numpy(w[rows].copy())).sum()
            grads = torch.autograd.grad(loss, leaves + [xt])
        sums = [r for r in dreduce.merge_log if r["kind"] == "sum"]
        dreduce.merge_log = None
        out[moe_case_name(case)] = dict(
            y=y.detach().float(),
            grads=tree.unflatten(mine, [g.float() for g in grads[:-1]]),
            gx=grads[-1].float(), drops=sum(drops), sums=len(sums))
    tmoe._slot_tables = tables
    return out


SCENARIOS = {"compression": run_compression, "elastic": run_elastic,
             "moe_ep": run_moe_ep}


def main(scenario: str, rank: int, world: int, rendezvous: str,
         out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        out = SCENARIOS[scenario](rank)
        dist.barrier()
        torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
