"""Dry run of one (arch x shape x mesh) cell without running it (port of
repro/launch/dryrun_lib.py; the torch counterpart of the XLA lowering).

Every tensor is on the ``meta`` device (shapes and dtypes, no storage), and
the process is rank 0 of a process group whose other ranks need not exist
(launch/dryrun.py joins a fake group of ``--devices`` ranks), so a
production mesh of 256 or 512 ranks is planned on one host.  Per cell:

  1. FULL: the parameters, the optimizer state (``tx.init`` on meta), the
     batch and the decode cache, placed by ``tree_param_shardings``,
     ``train_state_shardings``, ``batch_shardings`` and ``cache_shardings``
     under the reference's ``RULE_OVERRIDES``.  ``argument_bytes`` is the
     sum of rank 0's local shards (a step count, a Python int here, is the
     reference's int32 scalar: 4 bytes); the donated parameters and state
     alias their outputs (``alias_bytes``), as in the reference.  Then one
     eager step of the rank's program runs on meta (the train step is the
     port's data-parallel step over the mesh's batch axes, the whole model
     and state on the rank; prefill the forward; decode ``decode_step``),
     and ``temp_bytes`` is the peak of the live bytes it allocates above
     its arguments (``roofline.LiveBytes``).  There is no compiler: that
     peak stands in for XLA's ``memory_analysis()``, and the report says
     so (``full.memory``).
  2. PROBES: the reference's ``probe_plan``, each probe's step run once on
     meta under ``roofline.cost_of``, solved to the full depth with
     ``solve_affine``.
  3. The roofline terms and the MODEL_FLOPS ratio, as the reference's.

The kernels' entries route meta tensors to their plain versions'
shapes (kernels/registry.py); nothing is computed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core.factory import OptimizerConfig, make_optimizer
from repro_torch.launch import roofline
from repro_torch.models import cache as cache_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import checkpoint
from repro_torch.train import trainer as trainer_lib

# per-shape logical-rule overrides (baseline policy)
RULE_OVERRIDES = {
    "long_500k": {"batch": None, "kv_seq": ("data", "model")},
}
MEMORY_NOTE = ("eager: the peak of live bytes one step of the rank's "
               "program allocates on meta above its arguments (no compiler; "
               "stands in for memory_analysis)")


def _sharding(rules: rules_lib.MeshRules, *axes) -> rules_lib.NamedSharding:
    return rules_lib.NamedSharding(rules.mesh, rules.spec(*axes))


def batch_shardings(specs: dict, rules: rules_lib.MeshRules) -> dict:
    out = {}
    for k, v in specs.items():
        if k == "positions":            # (3, B, S)
            sh = _sharding(rules, None, "batch", None)
        else:
            sh = _sharding(rules, "batch", *[None] * (v.ndim - 1))
        out[k] = rules_lib.enforce_divisible(sh, v.shape)
    return out


def cache_shardings(cfg: ModelConfig, struct: dict,
                    rules: rules_lib.MeshRules) -> dict:
    out = {}
    for k, v in struct.items():
        if k in ("k", "v"):             # (L, B, Smax, KV, hd)
            sh = _sharding(rules, None, "batch", "kv_seq", None, None)
        elif k == "ssm":                # (L, B, H, P, N)
            sh = _sharding(rules, None, "batch", "heads", None, None)
        elif k == "conv":               # (L, B, W-1, conv_dim)
            sh = _sharding(rules, None, "batch", None, "tensor")
        else:
            sh = _sharding(rules)
        out[k] = rules_lib.enforce_divisible(sh, v.shape)
    return out


def local_bytes(x, sharding: rules_lib.NamedSharding) -> int:
    """Bytes of rank 0's shard of ``x`` under ``sharding``: a meta tensor's
    local shard, a Python int as an int32 scalar, a bool as one byte."""
    if isinstance(x, bool):
        return 1
    if isinstance(x, int):
        return 4
    local = rules_lib.place(x, sharding).to_local()
    return local.numel() * local.element_size()


def _state_leaves(state) -> list:
    """The state's leaves in ``checkpoint.leaves`` order (None skipped)."""
    return [leaf.value for leaf in checkpoint.leaves(state)]


def _flat_shardings(x) -> list:
    """The shardings of a ``train_state_shardings`` tree in the same order
    (dict keys sorted, None skipped)."""
    if isinstance(x, rules_lib.NamedSharding):
        return [x]
    if x is None:
        return []
    if isinstance(x, dict):
        return [s for k in sorted(x) for s in _flat_shardings(x[k])]
    return [s for item in x for s in _flat_shardings(item)]


def _dp_group(mesh):
    """The process group over the mesh's batch axes (None: one rank)."""
    axes = rules_lib.dp_axis_names(mesh)
    sizes = rules_lib.mesh_sizes(mesh)
    if not axes or all(sizes[a] == 1 for a in axes):
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


@dataclasses.dataclass
class Cell:
    """One cell built on meta: the step and what it is called with, and
    each argument leaf with its sharding and whether it is donated
    (aliased by an output)."""
    step: Callable
    args: tuple
    leaves: List[Tuple[object, rules_lib.NamedSharding, bool]]


def build_cell(cfg: ModelConfig, shape: registry.ShapeCfg,
               rules: rules_lib.MeshRules, opt_cfg: OptimizerConfig, *,
               microbatches: Optional[int] = None) -> Cell:
    """The cell's step and arguments on meta, placed by the rules."""
    params = model_lib.param_struct(cfg)
    psh = tree.flatten(rules_lib.tree_param_shardings(params, rules))
    batch = registry.input_specs(cfg, shape)
    bsh = batch_shardings(batch, rules)
    leaves = [(x, bsh[k], False) for k, x in batch.items()]

    if shape.kind == "train":
        tx = make_optimizer(opt_cfg)
        state = tx.init(tree.flatten(params))
        osh = _flat_shardings(
            trainer_lib.train_state_shardings(state, params, rules))
        step = trainer_lib.make_train_step(
            cfg, tx, microbatches=microbatches,
            data_parallel_group=_dp_group(rules.mesh))
        donated = list(zip(tree.flatten(params), psh)) + \
            list(zip(_state_leaves(state), osh))
        return Cell(step, (params, state, batch),
                    [(x, sh, True) for x, sh in donated] + leaves)

    leaves += [(x, sh, False) for x, sh in zip(tree.flatten(params), psh)]
    if shape.kind == "prefill":
        def forward(params, batch):
            with torch.no_grad():
                return model_lib.forward(cfg, params, batch)
        return Cell(forward, (params, batch), leaves)

    if shape.kind == "decode":
        cache = cache_lib.cache_struct(cfg, shape.global_batch,
                                       shape.seq_len)
        csh = cache_shardings(cfg, cache, rules)

        def serve_step(params, cache, batch, pos):
            with torch.no_grad():
                return cache_lib.decode_step(cfg, params, cache, batch, pos)
        # the position: the reference's replicated int32 scalar
        return Cell(serve_step, (params, cache, batch, 0),
                    [(x, csh[k], True) for k, x in cache.items()] + leaves
                    + [(0, _sharding(rules), False)])

    raise ValueError(shape.kind)


def _new_output_bytes(kind: str, out, rules: rules_lib.MeshRules) -> int:
    """Rank 0's bytes of the outputs that alias no argument: the train
    step's two f32 metrics, the logits (batch-sharded) otherwise."""
    if kind == "train":
        return 8
    logits = out[0] if isinstance(out, tuple) else out
    sh = rules_lib.enforce_divisible(
        _sharding(rules, "batch", *[None] * (logits.ndim - 1)), logits.shape)
    return local_bytes(logits, sh)


def run_full(cell: Cell, kind: str, rules: rules_lib.MeshRules,
             lower_s: float = 0.0) -> dict:
    """One eager step of the cell on meta (its live bytes and the
    arguments it reads), then one more (its cost): the report's ``full``
    entry.  An argument the step never reads is not an argument, as
    ``jax.jit`` drops unused ones (a scheduled hyperparameter's stored
    value: the schedule recomputes it); their bytes are ``unused_bytes``."""
    live = roofline.LiveBytes()
    live.start(list(cell.args))
    t0 = time.time()
    with live:
        out = cell.step(*cell.args)
    new = _new_output_bytes(kind, out, rules)
    del out
    compile_s = round(time.time() - t0, 2)
    read = [not isinstance(x, torch.Tensor) or live.was_read(x)
            for x, _, _ in cell.leaves]
    nbytes = [local_bytes(x, sh) for x, sh, _ in cell.leaves]
    arg = sum(b for b, r in zip(nbytes, read) if r)
    alias = sum(b for b, r, (_, _, donated) in zip(nbytes, read, cell.leaves)
                if r and donated)
    return {
        "lower_s": lower_s,
        "compile_s": compile_s,
        "argument_bytes": arg,
        "output_bytes": alias + new,
        "temp_bytes": live.peak,
        "alias_bytes": alias,
        "peak_bytes_per_device": arg + new + live.peak,
        "unused_bytes": sum(b for b, r in zip(nbytes, read) if not r),
        "memory": MEMORY_NOTE,
        "scan_cost_raw": dataclasses.asdict(roofline.cost_of(cell.step,
                                                             *cell.args)),
    }


# ---------------------------------------------------------------------------
# Probe plans


def probe_plan(cfg: ModelConfig) -> Tuple[List[Tuple[dict, Tuple[int, ...]]],
                                          Tuple[int, ...]]:
    """[(config replacements, counts), ...], full_counts."""
    fam = cfg.family
    L = cfg.num_layers
    if fam in ("dense", "vlm", "audio", "ssm"):
        probes = [({"num_layers": 1}, (1,)), ({"num_layers": 2}, (2,))]
        return probes, (L,)
    if fam == "moe":
        fd = cfg.first_dense_layers
        probes = [
            ({"num_layers": 1, "first_dense_layers": 0}, (0, 1)),
            ({"num_layers": 2, "first_dense_layers": 1}, (1, 1)),
            ({"num_layers": 3, "first_dense_layers": 1}, (1, 2)),
        ]
        return probes, (fd, L - fd)
    if fam == "hybrid":
        # every probe keeps >= 1 shared-attention site (decode caches slice
        # into the sites-only cache, which must be non-empty)
        n_sites = len(cfg.shared_attn_layers())
        probes = [
            ({"num_layers": 1, "attn_every": 1}, (1, 1)),
            ({"num_layers": 2, "attn_every": 1}, (2, 2)),
            ({"num_layers": 2, "attn_every": 2}, (2, 1)),
        ]
        return probes, (L, n_sites)
    raise ValueError(fam)


def probe_costs(cfg: ModelConfig, shape: registry.ShapeCfg,
                rules: rules_lib.MeshRules, opt_cfg: OptimizerConfig,
                microbatches: Optional[int] = None) -> roofline.ProbeCost:
    probes, full_counts = probe_plan(cfg)
    counts, costs = [], []
    for repl, cnt in probes:
        pcfg = dataclasses.replace(cfg, **repl)
        cell = build_cell(pcfg, shape, rules, opt_cfg,
                          microbatches=microbatches)
        costs.append(roofline.cost_of(cell.step, *cell.args))
        counts.append(cnt)
    return roofline.solve_affine(counts, costs, full_counts)


# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             optimizer: str = "sketchy", mesh=None,
             skip_probes: bool = False, skip_full: bool = False,
             rule_overrides: Optional[dict] = None,
             opt_overrides: Optional[dict] = None,
             model_overrides: Optional[dict] = None,
             microbatches: Optional[int] = None,
             smoke: bool = False, shape: Optional[registry.ShapeCfg] = None
             ) -> Dict:
    """One dry-run cell; returns the report dict.  ``smoke``: the reduced
    config and a tiny shape (tests).  ``mesh`` (a ``DeviceMesh`` over the
    default group) defaults to the production mesh; ``shape`` replaces
    ``SHAPES[shape_name]``'s sizes."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg = registry.get_reduced(arch) if smoke else registry.get_config(arch)
    if model_overrides:
        cfg = dataclasses.replace(cfg, **model_overrides)
    shape = shape or registry.SHAPES[shape_name]
    if smoke:
        shape = registry.ShapeCfg(shape.name, seq_len=64, global_batch=8,
                                  kind=shape.kind)
    if shape_name == "long_500k" and not cfg.subquadratic:
        return {"arch": arch, "shape": shape_name,
                "skipped": "full-attention arch; long_500k requires "
                           "sub-quadratic attention"}

    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_chips = mesh.size()
    overrides = dict(RULE_OVERRIDES.get(shape_name, {}))
    overrides.update(rule_overrides or {})

    opt_kwargs = dict(name=optimizer, rank=256 if not smoke else 8,
                      block_size=1024 if not smoke else 32,
                      update_every=10, total_steps=10000)
    opt_kwargs.update(opt_overrides or {})
    opt_cfg = OptimizerConfig(**opt_kwargs)

    report: Dict = {"arch": arch, "shape": shape_name,
                    "mesh": "x".join(map(str, mesh.shape)),
                    "axes": list(mesh.mesh_dim_names), "chips": int(n_chips),
                    "optimizer": optimizer, "kind": shape.kind}

    with rules_lib.use_mesh(mesh, overrides) as rules:
        if not skip_full:
            t0 = time.time()
            cell = build_cell(cfg, shape, rules, opt_cfg,
                              microbatches=microbatches)
            lower_s = round(time.time() - t0, 2)
            report["full"] = run_full(cell, shape.kind, rules, lower_s)
            del cell

        if not skip_probes:
            t0 = time.time()
            cost = probe_costs(cfg, shape, rules, opt_cfg, microbatches)
            report["probe_s"] = round(time.time() - t0, 2)
            terms = roofline.roofline_terms(cost)
            report["cost"] = {"flops_per_device": cost.flops,
                              "bytes_per_device": cost.bytes_accessed,
                              "collective_bytes_per_device": cost.coll}
            report["roofline"] = terms

            # MODEL_FLOPS vs counted flops (useful-compute fraction)
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1)
            mf = cfg.model_flops_per_token(
                shape.seq_len, training=(shape.kind == "train"),
                decode=(shape.kind == "decode")) * tokens
            report["model_flops_total"] = mf
            counted_total = cost.flops * n_chips
            report["hlo_flops_total"] = counted_total
            report["useful_flops_ratio"] = (mf / counted_total
                                            if counted_total else 0.0)
            # roofline fraction: ideal time on the dominant term vs bound
            ideal = mf / (n_chips * roofline.PEAK_FLOPS)
            report["ideal_compute_s"] = ideal
            report["roofline_fraction"] = (
                ideal / terms["bound_s"] if terms["bound_s"] else 0.0)

    return report
