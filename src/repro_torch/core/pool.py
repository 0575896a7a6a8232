"""Packed block pools: shape-grouped cross-parameter block stacks (port of
repro/core/pool.py).

Every matrix block of the model is grouped by its padded block shape
``(bs_m, bs_n)`` into one ``(N, bs_m, bs_n)`` stack per shape, so the engine
runs each preconditioner method once per shape group.  Groups are ordered by
their sorted key and blocks within a group by parameter leaf (in the JAX
canonical order), then row-major tile order, exactly as the JAX package
orders them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import blocking


def group_key(bs_m: int, bs_n: int) -> str:
    """Canonical pool-dict key for a block shape."""
    return f"{bs_m}x{bs_n}"


@dataclasses.dataclass(frozen=True)
class PoolGroup:
    """One packed stack: all model blocks of one ``(bs_m, bs_n)`` shape."""
    key: str
    bs_m: int
    bs_n: int
    num_blocks: int          # N: total blocks across all member leaves
    leaf_ids: tuple          # flat param indices contributing, in pack order


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Where one parameter leaf's blocks live."""
    info: blocking.BlockInfo
    group: Optional[int] = None   # index into PoolIndex.groups ('matrix')
    offset: int = 0               # block offset within the group stack


@dataclasses.dataclass(frozen=True)
class PoolIndex:
    """Static scatter/gather map between the flat params and the pools."""
    groups: tuple          # tuple[PoolGroup]
    leaves: tuple          # tuple[LeafPlan], one per flat param leaf


@functools.lru_cache(maxsize=None)
def build_index(shapes: tuple, block_size: int = 1024, *,
                vectors_as_columns: bool = False) -> PoolIndex:
    """Group every matrix leaf's blocks by block shape.  ``shapes`` are the
    flat parameter shapes in canonical order; 'diag' leaves get a plan with
    ``group=None``.  ``vectors_as_columns`` makes 1-D leaves (d, 1) blocks
    (``blocking.analyze_leaf``)."""
    members: dict = {}               # key -> list[(leaf_id, num_blocks)]
    infos = [blocking.analyze_leaf(tuple(s), block_size,
                                   vectors_as_columns=vectors_as_columns)
             for s in shapes]
    for i, info in enumerate(infos):
        if info.kind == "matrix":
            members.setdefault(group_key(info.bs_m, info.bs_n), []).append(
                (i, info.num_blocks))

    groups, plans = [], [None] * len(infos)
    for gi, key in enumerate(sorted(members)):  # sorted: JAX dict order
        offset, leaf_ids = 0, []
        for i, nb in members[key]:
            plans[i] = LeafPlan(info=infos[i], group=gi, offset=offset)
            offset += nb
            leaf_ids.append(i)
        bs_m, bs_n = infos[leaf_ids[0]].block_shape
        groups.append(PoolGroup(key=key, bs_m=bs_m, bs_n=bs_n,
                                num_blocks=offset, leaf_ids=tuple(leaf_ids)))
    plans = [p if p is not None else LeafPlan(info=info)
             for p, info in zip(plans, infos)]
    return PoolIndex(groups=tuple(groups), leaves=tuple(plans))


def pack(index: PoolIndex, flat_leaves) -> dict:
    """Flat gradient leaves -> {group key: contiguous (N, bs_m, bs_n)}."""
    per_group: dict = {g.key: [] for g in index.groups}
    for leaf, plan in zip(flat_leaves, index.leaves):
        if plan.group is not None:
            per_group[index.groups[plan.group].key].append(
                blocking.to_blocks(leaf, plan.info))
    return {key: torch.cat(blocks, dim=0) for key, blocks in per_group.items()}


def unpack_leaf(index: PoolIndex, pools: dict, leaf_id: int) -> torch.Tensor:
    """Slice one leaf's blocks out of its pool and restore the leaf shape."""
    plan = index.leaves[leaf_id]
    if plan.group is None:
        raise ValueError(f"leaf {leaf_id} is not pooled")
    stack = pools[index.groups[plan.group].key]
    blocks = stack[plan.offset:plan.offset + plan.info.num_blocks]
    return blocking.from_blocks(blocks, plan.info)
