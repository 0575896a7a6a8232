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
from typing import Any, Callable, Optional

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


def map_stacks(fn: Callable, *stacks) -> Any:
    """``fn`` over the tensors of congruent stats stacks (NamedTuples of
    tensors, nested, an int8 ``QuantizedPool`` among them), keeping the
    structure of the first."""
    first = stacks[0]
    if isinstance(first, torch.Tensor):
        return fn(*stacks)
    return type(first)(*(map_stacks(fn, *items) for items in zip(*stacks)))


def due_blocks(group: PoolGroup, count: int, update_every: int) -> list:
    """The blocks of ``group`` the staggered refresh updates at step
    ``count``: block ``b`` when ``(count + b) % update_every == 0``
    (repro/core/pool.py ``block_ids`` is this phase's source there).  The
    port's step count is a host int, so the due set is host arithmetic:
    at most ``ceil(N / update_every)`` blocks, none for a group whose
    ``N`` is below the phase."""
    return list(range((-count) % update_every, group.num_blocks,
                      update_every))


def uniform_ranks(n: int, total: int, min_k: int, max_k: int, *,
                  device=None) -> torch.Tensor:
    """The rank budget's initial allocation: ``total`` spread over ``n``
    blocks as evenly as possible (earlier blocks take the remainder),
    clipped to ``[min_k, max_k]``; (n,) int32.  The caller checks
    ``n * min_k <= total <= n * max_k``."""
    base = total // n
    k = base + (torch.arange(n, device=device) < (total - base * n)).long()
    return torch.clamp(k, min_k, max_k).to(torch.int32)


def allocate_ranks(pressure: torch.Tensor, *, total: int, min_k: int,
                   max_k: int) -> torch.Tensor:
    """Greedy waterfill of a fixed total rank budget by descending
    ``pressure`` (N,): every block floored at ``min_k``, the rest of the
    budget poured into blocks in descending pressure order, each taking up
    to its headroom ``max_k - min_k`` before the next gets any.  One stable
    argsort (ties break by block index, as the reference's) and a
    cumulative sum; (N,) int32 with ``sum == total`` whenever ``N * min_k
    <= total <= N * max_k``."""
    n = pressure.shape[0]
    room = torch.full((n,), max(max_k - min_k, 0), dtype=torch.int64,
                      device=pressure.device)
    budget = min(max(total - n * min_k, 0), int(room.sum()))
    order = torch.argsort(-pressure, stable=True)           # descending
    ahead = torch.cumsum(room, 0) - room                    # better-ranked
    give_sorted = torch.minimum(torch.clamp(budget - ahead, min=0), room)
    give = torch.zeros_like(room).scatter(0, order, give_sorted)
    return (min_k + give).to(torch.int32)


def commit_select(valid: bool, pending, live):
    """The async refresh's commit (core/api.py): the pending stats stack
    where ``valid`` (it holds a refresh), else the live one."""
    return pending if valid else live
