"""The shared preconditioner engine (port of repro/core/api.py, default
path only).

``scale_by_preconditioner`` owns what every Kronecker-style optimizer
shares: blocking, pooling of same-shaped blocks (core/pool.py), the gated
refresh on ``count % update_every == 0``, the diagonal (RMSProp) fallback
for vectors and scalars, norm grafting (paper App. C) and the
``start_preconditioning_step`` gate.  The preconditioner supplies
``init_block``, ``refresh_batched`` and ``precondition_batched`` over whole
pool stacks.

Ported: synchronized inline refresh, fp32 pool storage, replicated
statistics, static rank, RMSPROP_NORMALIZED grafting with f32 accumulators,
and the diagonal fallback damped by ``GRAFT_EPS``.  Other ``EngineConfig``
values raise ``NotImplementedError`` naming the ROADMAP item that ports
them.

State is plain: the step count is a Python int (the refresh gate is a host
branch), pools map group keys to the preconditioner's stats stacks, and the
per-leaf residue holds the diagonal accumulators and grafting norms.  The
JAX ``Tagged``/``StateMeta`` annotations become the structure itself:
``second_moment_bytes`` reads the pools and the diagonal accumulators.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import pool
from repro_torch.core.transform import GradientTransformation

GRAFT_EPS = 1e-8        # grafting and diag-fallback damping

# non-default engine values -> the ROADMAP.md item (queue 1) that ports them
_NOT_PORTED = {
    "refresh_schedule": ("synchronized",
                         "queue 1 item 10 (staggered refresh)"),
    "refresh_mode": ("inline", "queue 1 item 10 (async refresh)"),
    "second_moment_dtype": ("fp32", "queue 1 item 9 (quantized storage)"),
    "stats_reduction": ("replicated", "queue 1 item 12 (distributed FD)"),
    "realloc_every": (0, "queue 1 item 10 (rank-budget reallocation)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    block_size: int = 1024
    beta2: Any = 0.999              # diag-fallback / grafting EMA decay
    update_every: int = 10          # refresh cadence (paper §6)
    start_preconditioning_step: int = 0
    refresh_schedule: str = "synchronized"
    refresh_mode: str = "inline"
    second_moment_dtype: str = "fp32"
    stats_reduction: str = "replicated"
    realloc_every: int = 0

    def __post_init__(self):
        for name, (ported, item) in _NOT_PORTED.items():
            if getattr(self, name) != ported:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (ROADMAP.md {item}); the port runs "
                    f"{name}={ported!r}")


class LeafState(NamedTuple):
    """Per-leaf residue that is not pooled: the diagonal accumulator of a
    vector/scalar leaf (``stats``) or the grafting accumulator of a matrix
    leaf (``graft``)."""
    stats: Optional[torch.Tensor]
    graft: Optional[torch.Tensor]


class PrecondState(NamedTuple):
    count: int
    pools: dict         # group key -> stats stack (leading dim N)
    leaves: tuple       # LeafState per flat param leaf


def graft_direction(g: torch.Tensor, acc: torch.Tensor, *, beta2):
    """Grafting direction + updated accumulator (paper App. C,
    RMSPROP_NORMALIZED); f32 tensors."""
    gn = g / (torch.linalg.norm(g) + 1e-16)
    acc = beta2 * acc + (1.0 - beta2) * torch.square(gn)
    return gn * torch.rsqrt(acc + GRAFT_EPS), acc


def scale_by_preconditioner(precond, cfg: EngineConfig = EngineConfig()
                            ) -> GradientTransformation:
    """The shared direction engine over flat leaf lists (emits a descent
    direction, no lr)."""

    def index_of(tensors) -> pool.PoolIndex:
        return pool.build_index(tuple(tuple(t.shape) for t in tensors),
                                cfg.block_size)

    def init_fn(params):
        index = index_of(params)
        device = params[0].device
        pools = {grp.key: precond.init_block(grp, device=device)
                 for grp in index.groups}
        leaves = []
        for p, plan in zip(params, index.leaves):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=device)
            if plan.group is None:
                leaves.append(LeafState(stats=zeros, graft=None))
            else:
                leaves.append(LeafState(stats=None, graft=zeros))
        return PrecondState(count=0, pools=pools, leaves=tuple(leaves))

    def update_fn(updates, state, params=None):
        count = state.count
        index = index_of(updates)
        g32 = [g.float() for g in updates]
        packed = pool.pack(index, g32)

        # one refresh / precondition call per shape group: pass 1 refreshes
        # every pool, pass 2 preconditions from the refreshed pools
        due = cfg.update_every <= 1 or count % cfg.update_every == 0
        pools = {}
        for grp in index.groups:
            stats = state.pools[grp.key]
            if due:
                stats = precond.refresh_batched(stats, packed[grp.key])
            pools[grp.key] = stats
        pooled_dirs = {grp.key: precond.precondition_batched(
            pools[grp.key], packed[grp.key]) for grp in index.groups}

        out, leaves = [], []
        for i, (g, leaf, plan) in enumerate(zip(updates, state.leaves,
                                                index.leaves)):
            gi = g32[i]
            if plan.group is None:   # diagonal (RMSProp) fallback
                acc = cfg.beta2 * leaf.stats \
                    + (1.0 - cfg.beta2) * torch.square(gi)
                out.append((gi * torch.rsqrt(acc + GRAFT_EPS)).to(g.dtype))
                leaves.append(LeafState(stats=acc, graft=None))
                continue

            direction = pool.unpack_leaf(index, pooled_dirs, i)
            graft_dir, new_graft = graft_direction(
                gi, leaf.graft, beta2=cfg.beta2)
            pnorm = torch.linalg.norm(direction)
            gnorm = torch.linalg.norm(graft_dir)
            direction = direction * (gnorm / (pnorm + 1e-16))
            if count < cfg.start_preconditioning_step:
                direction = graft_dir
            out.append(direction.to(g.dtype))
            leaves.append(LeafState(stats=None, graft=new_graft))

        return out, PrecondState(count=count + 1, pools=pools,
                                 leaves=tuple(leaves))

    return GradientTransformation(init_fn, update_fn)


def second_moment_bytes(state: Any) -> int:
    """Second-moment memory (the paper's Fig. 1 quantity): every pooled
    sketch tensor and every diagonal accumulator of each engine state found
    in ``state`` (a bare engine state, a named chain or an injected chain);
    grafting and momentum are excluded."""
    if isinstance(state, PrecondState):
        tensors = [t for stats in state.pools.values() for t in _leaves(stats)]
        tensors += [leaf.stats for leaf in state.leaves
                    if leaf.stats is not None]
        return sum(t.numel() * t.element_size() for t in tensors)
    if isinstance(state, InjectState):
        return second_moment_bytes(state.inner)
    if isinstance(state, dict):
        return sum(second_moment_bytes(s) for s in state.values())
    return 0


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for item in x for t in _leaves(item)]


def named_chain(*stages) -> GradientTransformation:
    """Chain with labelled stages: state is ``{name: member_state}``."""
    names = [n for n, _ in stages]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate stage names: {names}")

    def init_fn(params):
        return {name: t.init(params) for name, t in stages}

    def update_fn(updates, state, params=None):
        new_state = {}
        for name, t in stages:
            updates, new_state[name] = t.update(updates, state[name], params)
        return updates, new_state

    return GradientTransformation(init_fn, update_fn)


class InjectState(NamedTuple):
    count: int
    hyperparams: dict    # name -> f32 scalar tensor
    inner: Any


def inject_hyperparams(inner_factory: Callable[..., GradientTransformation]):
    """Hyperparameters in state: each is a number or a schedule
    ``count -> value``, evaluated every step and handed to
    ``inner_factory(**values)`` as f32 scalar tensors (as the reference
    hands f32 arrays)."""
    def make(**hypers):
        def resolve(count: int, current: dict) -> dict:
            return {k: torch.as_tensor(v(count), dtype=torch.float32)
                    if callable(v) else current[k]
                    for k, v in hypers.items()}

        def init_fn(params):
            vals = {k: torch.as_tensor(v(0) if callable(v) else v,
                                       dtype=torch.float32)
                    for k, v in hypers.items()}
            return InjectState(count=0, hyperparams=vals,
                               inner=inner_factory(**vals).init(params))

        def update_fn(updates, state, params=None):
            vals = resolve(state.count, state.hyperparams)
            updates, inner = inner_factory(**vals).update(
                updates, state.inner, params)
            return updates, InjectState(count=state.count + 1,
                                        hyperparams=vals, inner=inner)

        return GradientTransformation(init_fn, update_fn)

    return make
