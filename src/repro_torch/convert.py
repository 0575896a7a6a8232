"""State carried across the packages: parameters from the JAX package, so
both start from identical weights (the JAX tree arrives as numpy arrays,
``np.asarray`` of each leaf), and checkpoints of either package rewritten
into the other's leaf names (``convert_checkpoint``); and a whole
parameter tree cut to one rank's share under expert parallelism
(``expert_parallel_shard``).  This module imports no JAX."""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint


def params_from_numpy(cfg: ModelConfig, params: dict) -> dict:
    """The port's parameter dict (on the CPU) for a nested dict of numpy
    arrays in the reference's layout.  Keys and shapes must match
    ``param_shapes(cfg)``; values are cast exactly to ``cfg.dtype`` (bf16
    arrives as ml_dtypes bfloat16 and float16 as numpy's, both through f32,
    which holds every value of either)."""
    like = model_lib.param_shapes(cfg)
    if tree.structure(params) != tree.structure(like):
        raise ValueError("parameter tree keys differ from param_shapes(cfg)")
    dtype = model_lib.DTYPES[cfg.dtype]
    leaves = []
    for shape, arr in zip(tree.flatten(like), tree.flatten(params)):
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"parameter of shape {arr.shape}, expected "
                             f"{shape}")
        leaves.append(torch.from_numpy(arr.astype(np.float32)).to(dtype))
    return tree.unflatten(like, leaves)


def expert_parallel_shard(params: dict, rank: int, n: int, *,
                          fsdp_rank: int = 0, n_fsdp: int = 1) -> dict:
    """Rank ``rank`` of ``n``'s parameters under expert parallelism
    (models/moe.py): every moe block's routed experts ``w_gate``, ``w_up``
    and ``w_down`` (E, ...) (stacked: (L, E, ...)) cut to experts
    [rank E/n, (rank + 1) E/n); with ``n_fsdp`` > 1 also the d_model rows
    of those experts and of the router cut into ``n_fsdp`` parts, part
    ``fsdp_rank`` (the reference's ``in_specs`` of
    ``_moe_routed_shard_map``).  The cut leaves are copies, so the whole
    ones can be freed; every other leaf is the same tensor."""
    def cut(x: torch.Tensor, dim: int, i: int, parts: int) -> torch.Tensor:
        if x.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"into {parts}")
        size = x.shape[dim] // parts
        return x.narrow(dim, i * size, size)

    def visit(node, path: tuple):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        if "moe" not in path or path[-1] not in ("router", "w_gate", "w_up",
                                                 "w_down"):
            return node
        x, nd = node, node.ndim
        if path[-1] != "router":
            if path[-2] != "experts":
                return node
            x = cut(x, nd - 3, rank, n)
        if n_fsdp > 1:
            x = cut(x, nd - 1 if path[-1] == "w_down" else nd - 2,
                    fsdp_rank, n_fsdp)
        return x.clone()

    return visit(params, ())


# ---------------------------------------------------------------------------
# Checkpoints across the packages

PORT, REFERENCE = "port", "reference"

# The optimizer-state leaves a checkpoint of ``(params, opt_state)`` may
# hold, by the port's names (train/checkpoint.py) after "1::": the chain's
# count and hyperparameters, the momentum (by flat parameter index; the
# reference keys it by parameter path), and the engine's count, pool stacks
# (Sketchy's sketches with their active ranks, Shampoo's factors and roots;
# int8 stacks as values and scale) and per-leaf residue (diagonal
# accumulators, Adam's moments, grafting accumulators; in a pre-pool
# checkpoint, each leaf's own block stacks under ".stats").  The reference
# names each of them with a "::.value" suffix (its Tagged wrapper).
_INT8 = r"(?:::\.values|::\.scale)?"
_STATE = re.compile(
    r"\.count|\.hyperparams::\w+"
    r"|\.inner::momentum::\.momentum::(?P<momentum>.+)"
    r"|\.inner::precond::(?:\.count"
    rf"|\.pools::(?P<pool>\d+x\d+)::(?:{checkpoint.POOL_SUFFIX})"
    r"|\.leaves::(?P<leaf>\d+)::(?:\.graft"
    rf"|\.stats(?:::\.mu|::\.nu)?{_INT8}"
    rf"|\.stats::(?P<pre_pool>{checkpoint.POOL_SUFFIX})))")
_PARAM = re.compile(r"\w+(?:::\w+)*")
_VALUE = "::.value"


def _rename(name: str, to: str, param_paths: list) -> tuple:
    """One leaf's name in the other package and the reference's
    ``blocked`` and ``param_index`` for it; ValueError when it has no
    counterpart."""
    head, _, rest = name.partition("::")
    if head == "0" and _PARAM.fullmatch(rest):
        return name, False, None
    m = None
    if head == "1" and (to == REFERENCE or rest.endswith(_VALUE)):
        if to == PORT:
            rest = rest[:-len(_VALUE)]
        m = _STATE.fullmatch(rest)
    if m is None:
        raise ValueError(f"checkpoint leaf {name!r} has no counterpart in "
                         f"the {to}'s state")
    index = m.group("leaf")
    if m.group("momentum") is not None:
        key = m.group("momentum")
        if to == PORT:
            if key not in param_paths:
                raise ValueError(f"momentum leaf {name!r} names no "
                                 "parameter of the checkpoint")
            index = param_paths.index(key)
        else:
            if not key.isdigit() or int(key) >= len(param_paths):
                raise ValueError(f"momentum leaf {name!r} names no "
                                 "parameter of the checkpoint")
            index = int(key)
        rest = rest[:m.start("momentum")] + (
            str(index) if to == PORT else param_paths[index])
    out = f"1::{rest}" + (_VALUE if to == REFERENCE else "")
    blocked = m.group("pool") is not None or m.group("pre_pool") is not None
    return out, blocked, None if index is None else int(index)


def convert_checkpoint(src: str, dst: str, *, to: str) -> str:
    """Rewrite the latest step of the checkpoint directory ``src`` into
    ``dst`` under the leaf names of the package ``to`` (``"port"`` or
    ``"reference"``); returns the new step's path.  To convert an earlier
    step, copy its ``step-<s>`` alone into a directory of its own.

    The checkpoint holds ``(params, opt_state)``, as both launchers save
    it, of Sketchy (any storage, inline or async, with or without a rank
    budget), Shampoo or Adam.  Leaf files are copied as they are (both
    packages write the same ``.npy`` records, bf16 as ``|V2``); each
    record's role crosses with it (both packages use the reference's role
    strings), and a record for the reference gets its ``blocked`` and
    ``param_index`` as the reference's own save writes them.  A leaf with
    no counterpart raises ValueError."""
    if to not in (PORT, REFERENCE):
        raise ValueError(f"to={to!r}: expected {PORT!r} or {REFERENCE!r}")
    step = checkpoint.latest_step(src)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {src}")
    path = os.path.join(src, f"step-{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    param_paths = [r["name"][3:] for r in manifest["leaves"]
                   if r["name"].startswith("0::")]
    records = []
    for rec in manifest["leaves"]:
        name, blocked, index = _rename(rec["name"], to, param_paths)
        meta = rec.get("meta")
        if meta is not None:
            meta = {"role": meta["role"]}
            if to == REFERENCE:
                meta.update(blocked=blocked, param_index=index)
        records.append(dict(rec, name=name, meta=meta))
    tmp = os.path.join(dst, f"tmp-{step}")
    final = os.path.join(dst, f"step-{step}")
    for d in (tmp, final):
        if os.path.exists(d):
            shutil.rmtree(d)
    os.makedirs(tmp)
    for rec in records:
        shutil.copyfile(os.path.join(path, rec["file"]),
                        os.path.join(tmp, rec["file"]))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(dict(manifest, leaves=records), f)
    os.replace(tmp, final)
    return final
