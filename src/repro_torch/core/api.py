"""The shared preconditioner engine (port of repro/core/api.py, default
path only).

``scale_by_preconditioner`` owns what every Kronecker-style optimizer
shares: blocking, pooling of same-shaped blocks (core/pool.py), the
per-step statistics update, the gated refresh on ``count % update_every ==
0``, the diagonal (RMSProp) fallback for vectors and scalars, norm grafting
(paper App. C) and the ``start_preconditioning_step`` gate.  The
preconditioner supplies ``init_block`` (the stats stack of a pool group),
and ``update_stats_batched`` (optional: every step, before the refresh),
``refresh_batched`` and ``precondition_batched`` over whole pool stacks, or
the per-block ``update_stats``, ``refresh`` and ``precondition``, which the
engine loops over the pool dim (the reference vmaps them).  The
reference's ``diagonal = True`` path (Adam, every leaf whole) is
core/adam.py's own transformation here.

Ported: synchronized inline refresh, fp32/bf16/int8 second-moment storage
(core/quantize.py) with the fused int8 path for preconditioners that
declare ``supports_quantized_compute``, replicated statistics, static
rank, RMSPROP_NORMALIZED grafting with f32 accumulators or none, 1-D leaves
as (d, 1) blocks for the OCO learners (``treat_vectors_as_columns``), and
the diagonal fallback damped by ``GRAFT_EPS``.  Other ``EngineConfig``
values raise ``NotImplementedError`` naming the ROADMAP item that ports
them.

State is plain: the step count is a Python int (the refresh gate is a host
branch), pools map group keys to the preconditioner's stats stacks, and the
per-leaf residue holds the diagonal accumulators (or Adam's moments) and
grafting norms.  The JAX ``Tagged``/``StateMeta`` roles become the stats
NamedTuples' ``second_moments`` declarations (core/quantize.py):
``second_moment_bytes`` reads the second-moment leaves of the pools and of
the per-leaf stats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import pool, quantize
from repro_torch.core.transform import GradientTransformation

GRAFT_EPS = 1e-8        # grafting and diag-fallback damping
GRAFTS = ("rmsprop_normalized", "none")
QUANTIZED_EPILOGUES = ("auto", "off", "on")
QUANTIZE_SEED = 0x0517  # root of the stochastic-rounding keys, as in JAX

# non-default engine values -> the ROADMAP.md item (queue 1) that ports them
_NOT_PORTED = {
    "refresh_schedule": ("synchronized",
                         "queue 1 item 10 (staggered refresh)"),
    "refresh_mode": ("inline", "queue 1 item 10 (async refresh)"),
    "stats_reduction": ("replicated", "queue 1 item 12 (distributed FD)"),
    "realloc_every": (0, "queue 1 item 10 (rank-budget reallocation)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    block_size: int = 1024
    beta2: Any = 0.999              # diag-fallback / grafting EMA decay
    update_every: int = 10          # refresh cadence (paper §6)
    start_preconditioning_step: int = 0
    graft: str = "rmsprop_normalized"   # rmsprop_normalized | none
    refresh_schedule: str = "synchronized"
    refresh_mode: str = "inline"
    # storage of the second-moment state between steps (core/quantize.py):
    # "fp32" | "bf16" | "int8"
    second_moment_dtype: str = "fp32"
    # fused int8 compute: with int8 storage, "on" and "auto" hand the FD
    # functions the int8 containers (quantize.compute_view), so the refresh
    # and the apply run on int8 values through the fused kernels; "off"
    # dequantizes the pools to f32 at the boundary.  JAX's "auto" fuses
    # only on its Pallas backend (repro/core/api.py :588-595), which runs
    # on the TPU; the port's counterpart of that backend is the card, and
    # the port has no backend knob, so "auto" means fused.  (A JAX CPU run
    # with "auto" takes the "off" path; the tests hold "auto" against JAX
    # "on".)
    quantized_epilogue: str = "auto"
    stats_reduction: str = "replicated"
    realloc_every: int = 0
    # OCO learners (S-AdaGrad, paper Alg. 2) precondition a d-vector with
    # one d x d sketch: 1-D leaves become a single (d, 1) matrix block
    # instead of taking the diagonal fallback
    treat_vectors_as_columns: bool = False

    def __post_init__(self):
        if self.graft not in GRAFTS:
            raise NotImplementedError(
                f"EngineConfig.graft={self.graft!r} is not ported yet "
                f"(ROADMAP.md queue 1 item 4); the port runs one of {GRAFTS}")
        if self.second_moment_dtype not in quantize.SECOND_MOMENT_DTYPES:
            raise ValueError(
                f"unknown second_moment_dtype {self.second_moment_dtype!r}; "
                f"expected one of {quantize.SECOND_MOMENT_DTYPES}")
        if self.quantized_epilogue not in QUANTIZED_EPILOGUES:
            raise ValueError(
                f"unknown quantized_epilogue {self.quantized_epilogue!r}; "
                f"expected one of {QUANTIZED_EPILOGUES}")
        for name, (ported, item) in _NOT_PORTED.items():
            if getattr(self, name) != ported:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (ROADMAP.md {item}); the port runs "
                    f"{name}={ported!r}")


class LeafState(NamedTuple):
    """Per-leaf residue that is not pooled: the diagonal accumulator of a
    vector/scalar leaf (``stats``, in its storage layout; Adam's moments
    of any leaf, core/adam.py), or the grafting accumulator of a matrix
    leaf (``graft``, f32)."""
    stats: Any
    graft: Optional[torch.Tensor]


class PrecondState(NamedTuple):
    count: int
    pools: dict         # group key -> stats stack (leading dim N), stored
                        # in its storage layout (core/quantize.py)
    leaves: tuple       # LeafState per flat param leaf


def graft_direction(g: torch.Tensor, acc: torch.Tensor, *, graft: str,
                    beta2):
    """Grafting direction + updated accumulator (paper App. C,
    RMSPROP_NORMALIZED); f32 tensors.  ``graft="none"`` returns the
    gradient and the accumulator unchanged."""
    if graft == "none":
        return g, acc
    gn = g / (torch.linalg.norm(g) + 1e-16)
    acc = beta2 * acc + (1.0 - beta2) * torch.square(gn)
    return gn * torch.rsqrt(acc + GRAFT_EPS), acc


def _batched_method(precond, name: str) -> Optional[Callable]:
    """``fn(stats_stack, G_stack)`` for one preconditioner method: its
    ``<name>_batched`` when it has one (one call over the whole pool stack,
    the kernel-backed hot path), else its per-block ``<name>`` over each
    block of the pool dim, restacked (the reference's ``jax.vmap``); None
    when it has neither (an ``update_stats`` that is the identity, as
    Sketchy's and S-AdaGrad's are in the reference)."""
    batched = getattr(precond, name + "_batched", None)
    if batched is not None:
        return batched
    per_block = getattr(precond, name, None)
    if per_block is None:
        return None

    def loop(stats, G):
        outs = [per_block(_block(stats, n), G[n]) for n in range(G.shape[0])]
        return _stack(outs)

    return loop


def _block(stats, n: int):
    """Block ``n`` of a stats stack (a tensor or a tuple of them)."""
    if isinstance(stats, torch.Tensor):
        return stats[n]
    return type(stats)(*(_block(x, n) for x in stats))


def _stack(items: list):
    """Per-block results back into a stack; one block becomes a view."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return first[None] if len(items) == 1 else torch.stack(items)
    return type(first)(*(_stack([it[i] for it in items])
                         for i in range(len(first))))


def scale_by_preconditioner(precond, cfg: EngineConfig = EngineConfig()
                            ) -> GradientTransformation:
    """The shared direction engine over flat leaf lists (emits a descent
    direction, no lr)."""
    qdtype = cfg.second_moment_dtype
    # the int8 containers go to the preconditioner only if it can run on
    # them (repro/core/api.py :588-595); Shampoo's root solve needs f32
    fused = (qdtype == "int8" and cfg.quantized_epilogue != "off"
             and getattr(precond, "supports_quantized_compute", False))
    pool_compute = quantize.compute_view if fused \
        else quantize.dequantize_pool
    update_stats_b = _batched_method(precond, "update_stats")
    refresh_b = _batched_method(precond, "refresh")
    precondition_b = _batched_method(precond, "precondition")

    def index_of(tensors) -> pool.PoolIndex:
        return pool.build_index(
            tuple(tuple(t.shape) for t in tensors), cfg.block_size,
            vectors_as_columns=cfg.treat_vectors_as_columns)

    def init_fn(params):
        index = index_of(params)
        device = params[0].device
        # stored in the storage layout from the start, rounded to nearest
        # (zeros: nothing to dither)
        pools = {grp.key: quantize.quantize_pool(
            precond.init_block(grp, device=device), qdtype)
            for grp in index.groups}
        leaves = []
        for p, plan in zip(params, index.leaves):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=device)
            if plan.group is None:
                leaves.append(LeafState(
                    stats=quantize.quantize_leaf_state(zeros, qdtype),
                    graft=None))
            else:
                leaves.append(LeafState(
                    stats=None, graft=None if cfg.graft == "none" else zeros))
        return PrecondState(count=0, pools=pools, leaves=tuple(leaves))

    def update_fn(updates, state, params=None):
        count = state.count
        index = index_of(updates)
        g32 = [g.float() for g in updates]
        packed = pool.pack(index, g32)
        # stochastic requantization keyed by step (and below by group or
        # leaf), as the reference folds its PRNG key
        qkey = (QUANTIZE_SEED, count) if qdtype == "int8" else None

        # one call of each method per shape group: pass 1 updates the
        # statistics of every pool and refreshes it when due, pass 2
        # preconditions from the refreshed pools and stores them back in
        # their storage layout
        due = cfg.update_every <= 1 or count % cfg.update_every == 0
        raws = {}
        for grp in index.groups:
            raw = pool_compute(state.pools[grp.key])
            if update_stats_b is not None:
                raw = update_stats_b(raw, packed[grp.key])
            if due:
                raw = refresh_b(raw, packed[grp.key])
            raws[grp.key] = raw
        pooled_dirs, pools = {}, {}
        for gi, grp in enumerate(index.groups):
            pooled_dirs[grp.key] = precondition_b(raws[grp.key],
                                                  packed[grp.key])
            pools[grp.key] = quantize.requantize_pool(
                state.pools[grp.key], raws[grp.key],
                key=quantize.fold_in(qkey, gi))

        out, leaves = [], []
        for i, (g, leaf, plan) in enumerate(zip(updates, state.leaves,
                                                index.leaves)):
            gi = g32[i]
            if plan.group is None:   # diagonal (RMSProp) fallback
                acc = cfg.beta2 * quantize.dequantize_pool(leaf.stats) \
                    + (1.0 - cfg.beta2) * torch.square(gi)
                out.append((gi * torch.rsqrt(acc + GRAFT_EPS)).to(g.dtype))
                stats = quantize.requantize_pool(
                    leaf.stats, acc,
                    key=quantize.fold_in(qkey, len(index.groups) + i))
                leaves.append(LeafState(stats=stats, graft=None))
                continue

            direction = pool.unpack_leaf(index, pooled_dirs, i)
            graft_dir, new_graft = graft_direction(
                gi, leaf.graft, graft=cfg.graft, beta2=cfg.beta2)
            if cfg.graft != "none":
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


def pool_stats(state: PrecondState, key: Optional[str] = None) -> Any:
    """The f32 stats stack of one pool group (default: the only group),
    dequantized from its storage layout."""
    if key is None:
        if len(state.pools) != 1:
            raise ValueError(f"state has {len(state.pools)} pools "
                             f"{sorted(state.pools)}; pass an explicit key")
        key = next(iter(state.pools))
    return quantize.dequantize_pool(state.pools[key])


def second_moment_bytes(state: Any) -> int:
    """Second-moment memory (the paper's Fig. 1 quantity): the
    second-moment leaves (core/quantize.py ``second_moments``) of every
    pool stack and every per-leaf stats entry of each engine state found in
    ``state`` (a bare engine state, a named chain or an injected chain), as
    stored (int8 values and their f32 scales under int8 storage); grafting,
    momentum and Shampoo's cached roots are excluded."""
    if isinstance(state, PrecondState):
        stats = list(state.pools.values()) + [
            leaf.stats for leaf in state.leaves if leaf.stats is not None]
        return sum(t.numel() * t.element_size() for s in stats
                   for t in quantize.second_moment_tensors(s))
    if isinstance(state, InjectState):
        return second_moment_bytes(state.inner)
    if isinstance(state, dict):
        return sum(second_moment_bytes(s) for s in state.values())
    return 0


def _leaves(x) -> list:
    """Every tensor of a stats tree, second moment or not."""
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


def set_hyperparams(state: InjectState, **overrides) -> InjectState:
    """The state with stored hyperparameter values replaced (serve-time
    lr/beta2 changes without rebuilding the chain): they take effect on the
    next update.  Schedule-driven values are recomputed from the step count
    each update.  KeyError on an unknown name."""
    hp = dict(state.hyperparams)
    for k, v in overrides.items():
        if k not in hp:
            raise KeyError(f"unknown hyperparameter {k!r}; have {list(hp)}")
        hp[k] = torch.as_tensor(v, dtype=hp[k].dtype)
    return state._replace(hyperparams=hp)


def get_hyperparams(state: InjectState) -> dict:
    return dict(state.hyperparams)
