"""The shared preconditioner engine (port of repro/core/api.py).

``scale_by_preconditioner`` owns what every Kronecker-style optimizer
shares: blocking, pooling of same-shaped blocks (core/pool.py), the
per-step statistics update, the gated refresh, the diagonal (RMSProp)
fallback for vectors and scalars, norm grafting (paper App. C) and the
``start_preconditioning_step`` gate.  The preconditioner supplies
``init_block`` (the stats stack of a pool group), and
``update_stats_batched`` (optional: every step, before the refresh),
``refresh_batched`` and ``precondition_batched`` over whole pool stacks, or
the per-block ``update_stats``, ``refresh`` and ``precondition``, which the
engine loops over the pool dim (the reference vmaps them).  The
reference's ``diagonal = True`` path (Adam, every leaf whole) is
core/adam.py's own transformation here.

Refresh schedules: ``"synchronized"`` refreshes every block on ``count %
update_every == 0``; ``"staggered"`` refreshes every block at count 0, then
block b of a group when ``(count + b) % update_every == 0``.  Refresh
modes: ``"inline"`` preconditions a step from the statistics it refreshed;
``"async"`` preconditions from the statistics before the step's refresh,
launches the refresh into a pending slot (``PrecondState.pending``) and
commits it at the top of the next step, so ``committed_pools`` after step t
equals the inline engine's pools after step t, bit for bit.  A
preconditioner with ``finalize_init_pools`` and ``realloc_pools`` (the rank
budget, core/sketchy.py) sees every pool stack at init and, with
``realloc_every > 0``, every ``realloc_every * update_every`` steps after
the refresh.

Ported: both schedules and modes, the rank-budget hooks, fp32/bf16/int8
second-moment storage (core/quantize.py) with the fused int8 path for
preconditioners that declare ``supports_quantized_compute``, replicated
and sharded statistics (below), grafting with f32 accumulators
(RMSPROP_NORMALIZED, the un-normalized RMSPROP, or none), 1-D leaves as
(d, 1) blocks for the OCO learners (``treat_vectors_as_columns``), the
diagonal fallback damped by ``diag_eps`` (``GRAFT_EPS`` when None, as the
reference couples it to ``graft_eps``), and the profiling spans
(``profile_annotations``).

Sharded statistics (``stats_reduction="sharded"``, distributed/): when the
preconditioner has ``refresh_sharded_batched`` and ``stats_axis`` is bound
to a process group of more than one rank (the trainer binds it for a
step), the statistics see this rank's own gradients scaled by 1/sqrt(P),
the refreshes end in a butterfly merge of the sketches over the group, and
the diagonal fallback takes the mean of the ranks' squares; the direction,
grafting and everything after see the mean gradients.  Otherwise the path
is the replicated one, bit for bit.

State is plain: the step count is a Python int (the refresh gate and the
staggered due set are host arithmetic), pools map group keys to the
preconditioner's stats stacks, and the per-leaf residue holds the diagonal
accumulators (or Adam's moments) and grafting norms.  The JAX
``Tagged``/``StateMeta`` roles become the stats NamedTuples'
``second_moments`` declarations (core/quantize.py): ``second_moment_bytes``
reads the second-moment leaves of the pools and of the per-leaf stats; the
pending slot, transient in the reference, is not among them.  The other
roles a checkpoint records (count, grafting, momentum, ...) are declared
beside them in ``roles``, and the pending slot in ``transient``
(train/checkpoint.py).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import pool, quantize
from repro_torch.core.fd import FDState
from repro_torch.core.transform import GradientTransformation

GRAFT_EPS = 1e-8        # grafting (and by default diag-fallback) damping
GRAFTS = ("rmsprop_normalized", "rmsprop", "none")
REFRESH_SCHEDULES = ("synchronized", "staggered")
REFRESH_MODES = ("inline", "async")
STATS_REDUCTIONS = ("replicated", "sharded")
QUANTIZED_EPILOGUES = ("auto", "off", "on")
QUANTIZE_SEED = 0x0517  # root of the stochastic-rounding keys, as in JAX


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    block_size: int = 1024
    beta2: Any = 0.999              # diag-fallback / grafting EMA decay
    update_every: int = 10          # refresh cadence (paper §6)
    start_preconditioning_step: int = 0
    graft: str = "rmsprop_normalized"   # rmsprop_normalized | rmsprop | none
    # diagonal-fallback damping of vector and scalar leaves; None keeps the
    # grafting's GRAFT_EPS (the reference's graft_eps coupling)
    diag_eps: Optional[float] = None
    # synchronized | staggered (module docstring)
    refresh_schedule: str = "synchronized"
    # inline | async (module docstring)
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
    # "replicated" | "sharded" (module docstring), over the process group
    # bound to the axis name ``stats_axis`` (distributed/reduce.py)
    stats_reduction: str = "replicated"
    stats_axis: str = "data"
    # rank-budget reallocation cadence in refresh windows (0: never)
    realloc_every: int = 0
    # torch.profiler ranges around the engine's phases (``_span``)
    profile_annotations: bool = False
    # OCO learners (S-AdaGrad, paper Alg. 2) precondition a d-vector with
    # one d x d sketch: 1-D leaves become a single (d, 1) matrix block
    # instead of taking the diagonal fallback
    treat_vectors_as_columns: bool = False

    def __post_init__(self):
        for name, allowed in (
                ("graft", GRAFTS),
                ("second_moment_dtype", quantize.SECOND_MOMENT_DTYPES),
                ("quantized_epilogue", QUANTIZED_EPILOGUES),
                ("refresh_schedule", REFRESH_SCHEDULES),
                ("refresh_mode", REFRESH_MODES),
                ("stats_reduction", STATS_REDUCTIONS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}; "
                                 f"expected one of {allowed}")
        if self.realloc_every < 0:
            raise ValueError(
                f"realloc_every must be >= 0, got {self.realloc_every}")


class LeafState(NamedTuple):
    """Per-leaf residue that is not pooled: the diagonal accumulator of a
    vector/scalar leaf (``stats``, in its storage layout; Adam's moments
    of any leaf, core/adam.py), or the grafting accumulator of a matrix
    leaf (``graft``, f32)."""
    stats: Any
    graft: Optional[torch.Tensor]

    # checkpoint roles (train/checkpoint.py), as the reference's StateMeta
    roles = {"stats": "second_moment", "graft": "grafting"}


class PendingSlot(NamedTuple):
    """One group's refresh in flight (``refresh_mode="async"``): the stats
    stack refreshed at step t in the live pool's storage layout, and
    whether it holds one (False at init, where the commit keeps the live
    stack)."""
    stats: Any
    valid: bool


class PrecondState(NamedTuple):
    count: int
    pools: dict         # group key -> stats stack (leading dim N), stored
                        # in its storage layout (core/quantize.py)
    leaves: tuple       # LeafState per flat param leaf
    pending: Optional[dict] = None   # group key -> PendingSlot under async

    # checkpoint roles (train/checkpoint.py); the pending slot is derived
    # state, never written and rebuilt empty on restore
    roles = {"count": "count", "pools": "second_moment"}
    transient = ("pending",)


def committed_pools(state: PrecondState) -> dict:
    """The stored pools the next update preconditions from: the live pools
    inline; under async each group's pending refresh committed over its
    live stack, the select the next update makes first.  So after step t,
    ``committed_pools(async_t) == inline_t.pools`` bit for bit."""
    if state.pending is None:
        return state.pools
    return {key: pool.commit_select(state.pending[key].valid,
                                    state.pending[key].stats, live)
            for key, live in state.pools.items()}


def graft_direction(g: torch.Tensor, acc: torch.Tensor, *, graft: str,
                    beta2):
    """Grafting direction + updated accumulator (paper App. C): f32 tensors.
    RMSPROP_NORMALIZED scales the gradient to unit norm first, RMSPROP
    takes it as it is, and ``graft="none"`` returns the gradient and the
    accumulator unchanged.  The temporaries are updated
    in place, in the order and with the bits of ``beta2 * acc + (1 -
    beta2) * gn², gn * rsqrt(acc + eps)``: qwen2-vl-72b's head is 4.98 GB
    in f32, and two of its temporaries fewer are 10 GB."""
    if graft == "none":
        return g, acc
    gn = g / (torch.linalg.norm(g) + 1e-16) if graft == "rmsprop_normalized" \
        else g
    sq = torch.square(gn).mul_(1.0 - beta2)
    acc = torch.mul(acc, beta2).add_(sq)
    del sq
    return torch.add(acc, GRAFT_EPS).rsqrt_().mul_(gn), acc


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


@contextlib.contextmanager
def _span(name: str, enabled: bool):
    """A ``torch.profiler.record_function`` range named as the reference's
    span (a host range, and the device work launched inside it in a
    trace); nothing when not ``enabled``."""
    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def scale_by_preconditioner(precond, cfg: EngineConfig = EngineConfig()
                            ) -> GradientTransformation:
    """The shared direction engine over flat leaf lists (emits a descent
    direction, no lr)."""
    qdtype = cfg.second_moment_dtype
    diag_eps = GRAFT_EPS if cfg.diag_eps is None else cfg.diag_eps
    # the int8 containers go to the preconditioner only if it can run on
    # them (repro/core/api.py :588-595); Shampoo's root solve needs f32, and
    # the sharded merge f32 factors on the wire (off under "sharded" even
    # with no group bound, as in the reference)
    fused = (qdtype == "int8" and cfg.quantized_epilogue != "off"
             and getattr(precond, "supports_quantized_compute", False)
             and cfg.stats_reduction != "sharded")
    pool_compute = quantize.compute_view if fused \
        else quantize.dequantize_pool
    update_stats_b = _batched_method(precond, "update_stats")
    refresh_b = _batched_method(precond, "refresh")
    precondition_b = _batched_method(precond, "precondition")
    refresh_sharded_b = getattr(precond, "refresh_sharded_batched", None)
    realloc_fn = getattr(precond, "realloc_pools", None)
    spans = cfg.profile_annotations

    def sharded_ctx():
        """(the reduce module, the group's size) when the sharded path is
        live: ``"sharded"``, a preconditioner that can merge, and
        ``stats_axis`` bound to more than one rank; else (None, 1), the
        replicated path (a merge of one rank is the identity)."""
        if cfg.stats_reduction != "sharded" or refresh_sharded_b is None:
            return None, 1
        from repro_torch.distributed import reduce as dreduce
        size = dreduce.bound_axis_size(cfg.stats_axis)
        if size is None or size <= 1:
            return None, 1
        return dreduce, size

    def index_of(tensors) -> pool.PoolIndex:
        return pool.build_index(
            tuple(tuple(t.shape) for t in tensors), cfg.block_size,
            vectors_as_columns=cfg.treat_vectors_as_columns)

    def init_fn(params):
        index = index_of(params)
        device = params[0].device
        stacks = {grp.key: precond.init_block(grp, device=device)
                  for grp in index.groups}
        # the rank budget is global: its hook sees every stack at once
        finalize = getattr(precond, "finalize_init_pools", None)
        if finalize is not None:
            stacks = finalize(index.groups, stacks)
        # stored in the storage layout from the start, rounded to nearest
        # (zeros: nothing to dither)
        pools = {key: quantize.quantize_pool(stack, qdtype)
                 for key, stack in stacks.items()}
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
        pending = None
        if cfg.refresh_mode == "async":
            # the live pools' layout in tensors of its own (zeros), never
            # views of the live stacks
            pending = {key: PendingSlot(
                stats=pool.map_stacks(torch.zeros_like, stack), valid=False)
                for key, stack in pools.items()}
        return PrecondState(count=0, pools=pools, leaves=tuple(leaves),
                            pending=pending)

    def refresh_group(grp: pool.PoolGroup, raw, gb: torch.Tensor,
                      count: int, vrefresh):
        """The gated refresh of one pool stack; ``vrefresh(stats, G)`` is
        the ungated one (the preconditioner's, or its sharded-merge
        variant).  Staggered, the due blocks
        (a host list, ``pool.due_blocks``) are gathered from every tensor
        of the stack, refreshed as a sub-stack and written back out of
        place, where the refresh changed them (not Shampoo's L and R, nor
        the active ranks); a group with none due is left as it is.  The
        reference pads
        the due set to ``ceil(N / update_every)`` with a dummy slot, so its
        kernels launch for every group at every step, where the port's
        launch only for a group with a due block; a block's result is the
        same."""
        k = cfg.update_every
        if k <= 1:
            return vrefresh(raw, gb)
        if cfg.refresh_schedule == "synchronized" or count == 0:
            # count 0 of the staggered schedule warms every block up
            return vrefresh(raw, gb) if count % k == 0 else raw
        due = pool.due_blocks(grp, count, k)
        if not due:
            return raw
        idx = torch.tensor(due, device=gb.device)
        gathered = pool.map_stacks(lambda x: x.index_select(0, idx), raw)
        sub = vrefresh(gathered, gb.index_select(0, idx))
        return pool.map_stacks(
            lambda x, g, y: x if y is g else x.index_copy(0, idx, y),
            raw, gathered, sub)

    def maybe_realloc(index: pool.PoolIndex, raws: dict, count: int) -> dict:
        """The rank budget's reallocation over every refreshed stack at
        once, every ``realloc_every * update_every`` steps after step 0."""
        if cfg.realloc_every == 0 or realloc_fn is None or not index.groups:
            return raws
        period = max(cfg.update_every, 1) * cfg.realloc_every
        if count == 0 or count % period != 0:
            return raws
        return realloc_fn(index.groups, raws)

    def update_stats(raw, gb: torch.Tensor):
        if update_stats_b is None:
            return raw
        with _span("precond/update_stats", spans):
            return update_stats_b(raw, gb)

    def update_fn(updates, state, params=None):
        count = state.count
        index = index_of(updates)
        # sharded statistics: the stats see this rank's gradients scaled by
        # 1/sqrt(P) (the merged sketch then estimates (1/P) sum_i G_i G_i^T),
        # everything else the mean gradients.  The trainer hands the local
        # gradients over (``local_gradients``); without them ``updates``
        # are the local ones and their mean is formed here.
        dreduce, axis_size = sharded_ctx()
        dtypes = [g.dtype for g in updates]
        local = updates
        if dreduce is not None:
            ctx = dreduce.current_local_gradients()
            if ctx is None:
                updates = dreduce.pmean([g.float() for g in updates],
                                        cfg.stats_axis)
            else:
                local = list(ctx)
        # the f32 gradients live only in the pool stacks while the pools
        # refresh; the per-leaf pass below casts each again (exactly):
        # qwen2-vl-72b's are 8.5 GB
        packed = pool.pack(index, [g.float() for g in updates])
        packed_stats = packed
        vrefresh = refresh_b
        if dreduce is not None:
            packed_stats = pool.pack(index, [g.float() * axis_size ** -0.5
                                             for g in local])
            vrefresh = lambda s, G: refresh_sharded_b(
                s, G, axis=cfg.stats_axis, axis_size=axis_size)
        # stochastic requantization keyed by step (and below by group or
        # leaf), as the reference folds its PRNG key
        qkey = (QUANTIZE_SEED, count) if qdtype == "int8" else None

        pooled_dirs, pools, pending = {}, {}, None
        if state.pending is None:
            # pass 1 updates the statistics of every pool and refreshes it
            # when due, pass 2 preconditions from the refreshed pools and
            # stores them back in their storage layout
            raws = {}
            for grp in index.groups:
                raw = update_stats(pool_compute(state.pools[grp.key]),
                                   packed_stats[grp.key])
                with _span("precond/refresh", spans):
                    raws[grp.key] = refresh_group(
                        grp, raw, packed_stats[grp.key], count, vrefresh)
            raws = maybe_realloc(index, raws, count)
            for gi, grp in enumerate(index.groups):
                with _span("precond/precondition", spans):
                    pooled_dirs[grp.key] = precondition_b(raws[grp.key],
                                                          packed[grp.key])
                pools[grp.key] = quantize.requantize_pool(
                    state.pools[grp.key], raws[grp.key],
                    key=quantize.fold_in(qkey, gi))
        else:
            # async: commit the refresh launched at the last step, update
            # the statistics, precondition from them before this step's
            # refresh, and launch that refresh into the pending slot.  The
            # live pool keeps the pre-refresh stack and the slot the
            # refreshed one, both stored under this step's keys, so the
            # next commit stores bit for bit what inline stored here.
            raws, refreshed = {}, {}
            for grp in index.groups:
                slot = state.pending[grp.key]
                with _span("precond/commit", spans):
                    committed = pool.commit_select(
                        slot.valid, slot.stats, state.pools[grp.key])
                raw = update_stats(pool_compute(committed),
                                   packed_stats[grp.key])
                with _span("precond/precondition", spans):
                    pooled_dirs[grp.key] = precondition_b(raw,
                                                          packed[grp.key])
                with _span("precond/refresh_launch", spans):
                    refreshed[grp.key] = refresh_group(
                        grp, raw, packed_stats[grp.key], count, vrefresh)
                raws[grp.key] = raw
            # the reallocation rides the refresh into the pending slot
            refreshed = maybe_realloc(index, refreshed, count)
            pending = {}
            for gi, grp in enumerate(index.groups):
                gkey = quantize.fold_in(qkey, gi)
                pools[grp.key] = quantize.requantize_pool(
                    state.pools[grp.key], raws[grp.key], key=gkey)
                pending[grp.key] = PendingSlot(
                    stats=quantize.requantize_pool(
                        state.pending[grp.key].stats, refreshed[grp.key],
                        key=gkey),
                    valid=True)

        # the pool stacks are done with, freed before the per-leaf
        # grafting temporaries
        del packed, packed_stats
        diag_sq = {}
        if dreduce is not None:
            # the diagonal fallback's squares travel in the reduction too:
            # the mean of the ranks' own squares, one all-reduce for all
            ids = [i for i, plan in enumerate(index.leaves)
                   if plan.group is None]
            if ids:
                diag_sq = dict(zip(ids, dreduce.pmean(
                    [torch.square(local[i].float()) for i in ids],
                    cfg.stats_axis)))
        out, leaves = [], []
        for i, (g, dtype, leaf, plan) in enumerate(zip(updates, dtypes,
                                                       state.leaves,
                                                       index.leaves)):
            gi = g.float()
            if plan.group is None:   # diagonal (RMSProp) fallback
                sq = diag_sq[i] if i in diag_sq else torch.square(gi)
                acc = cfg.beta2 * quantize.dequantize_pool(leaf.stats) \
                    + (1.0 - cfg.beta2) * sq
                out.append((gi * torch.rsqrt(acc + diag_eps)).to(dtype))
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
            out.append(direction.to(dtype))
            leaves.append(LeafState(stats=None, graft=new_graft))

        return out, PrecondState(count=count + 1, pools=pools,
                                 leaves=tuple(leaves), pending=pending)

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


def _find_sketches(s: Any, per: dict) -> None:
    """Every pool group of ``s`` that holds FD sketches, into ``per`` as
    key -> (active ranks or None, the sketches).  Recursion at module
    level: a nested function that calls itself is a reference cycle, which
    keeps the sketches until the cyclic collector runs."""
    if isinstance(s, PrecondState):
        for key, stats in s.pools.items():
            sides = [x for x in stats if isinstance(x, FDState)] \
                if isinstance(stats, tuple) else []
            if sides:
                per[key] = (getattr(stats, "k", None), sides)
    elif isinstance(s, InjectState):
        _find_sketches(s.inner, per)
    elif isinstance(s, dict):
        for v in s.values():
            _find_sketches(v, per)


def rank_allocation(state: Any) -> dict:
    """The rank budget's allocation, read from any state that holds an
    engine state (as ``second_moment_bytes`` finds them): ``{"total": K,
    "groups": {key: {"k", "rho", "budget_share"}}}`` over every pool group
    that holds FD sketches, with (N,) numpy arrays per group: ``k`` the
    active ranks (a static engine's, or a state of meta tensors', the
    capacity of its wider side), ``rho`` the escaped mass summed over the
    sides, and ``budget_share = k / K``.  The pending slot is not read."""
    per = {}
    _find_sketches(state, per)
    if not per:
        raise ValueError("no sketch state found (no pool holds FD sketches)")
    concrete = lambda t: t.device.type != "meta"
    ks = {}
    for key, (k, sides) in per.items():
        if k is not None and concrete(k):
            ks[key] = k.cpu().numpy().astype(np.int64)
        else:
            n = sides[0].eigvals.shape[0]
            cap = max(side.eigvals.shape[-1] for side in sides)
            ks[key] = np.full((n,), cap, dtype=np.int64)
    total = int(sum(int(k.sum()) for k in ks.values()))
    groups = {}
    for key, (_, sides) in sorted(per.items()):
        k = ks[key]
        rhos = [side.rho.double().cpu().numpy() for side in sides
                if concrete(side.rho)]
        rho = np.sum(rhos, axis=0) if rhos else np.zeros(k.shape)
        groups[key] = {"k": k, "rho": rho,
                       "budget_share": k / max(total, 1)}
    return {"total": total, "groups": groups}


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

    roles = {"count": "count", "hyperparams": "hyperparam"}


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
