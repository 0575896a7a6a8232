"""Elastic re-meshing and straggler detection (port of
repro/train/elastic.py).

Elastic re-mesh: on failure or resize, ``plan_mesh`` picks the largest
(pod, data, model) mesh the surviving ranks can host, keeping the model
axis fixed (the weights are laid out for it) and absorbing the loss in the
data axis; ``remesh`` builds it as a ``DeviceMesh`` over the first ranks;
``remesh_opt_state`` places a state, restored whole from the mesh-agnostic
checkpoint (train/checkpoint.py), on it as DTensors.  Each rank slices its
own copy, so a rank that has left need not take part.  Every rank of the
world calls ``remesh`` (each mesh dimension's groups come from
``new_group``); a rank outside the new mesh gets None.

``merge_sketches_on_shrink`` folds the sketches of ranks that leave
mid-window into those of the ranks that stay (sharded statistics,
distributed/), with the exact merge, so no observed curvature is dropped.

``StragglerMonitor`` tracks per-step wall times with a robust (median +
MAD) detector.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree
from repro_torch.core.fd import FDState
from repro_torch.distributed import sketch_merge
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import checkpoint, trainer

_clock = time.perf_counter


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: tuple
    axis_names: tuple
    global_batch: int
    note: str = ""


def plan_mesh(num_devices: int, *, model_parallel: int,
              target_global_batch: int, pods: int = 1) -> ElasticPlan:
    """Largest (pod, data, model) mesh that fits the surviving ranks.

    model_parallel is fixed; the data-parallel degree absorbs the loss.
    The global batch stays (the per-rank batch grows) unless it stops
    dividing, and then it is rounded down to a multiple of the new data
    degree (at least one row a rank)."""
    per_pod = num_devices // pods
    dp = per_pod // model_parallel
    if dp < 1:
        raise ValueError(
            f"{num_devices} devices cannot host model_parallel={model_parallel}")
    batch = target_global_batch
    total_dp = dp * pods
    if batch % total_dp:
        batch = max((batch // total_dp), 1) * total_dp
    if pods > 1:
        return ElasticPlan((pods, dp, model_parallel),
                           ("pod", "data", "model"), batch,
                           note=f"elastic: {num_devices} devices -> "
                                f"{pods}x{dp}x{model_parallel}")
    return ElasticPlan((dp, model_parallel), ("data", "model"), batch,
                       note=f"elastic: {num_devices} devices -> "
                            f"{dp}x{model_parallel}")


def remesh(plan: ElasticPlan, ranks: Optional[Sequence[int]] = None, *,
           device_type: str = "cuda") -> Optional[DeviceMesh]:
    """The plan's mesh over the first ``prod(plan.mesh_shape)`` of
    ``ranks`` (default: every rank of the world, ascending), row-major as
    the reference lays out its devices.  Every rank of the world calls it;
    a rank outside the mesh gets None."""
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    n = math.prod(plan.mesh_shape)
    if n > len(ranks):
        raise ValueError(f"a {plan.mesh_shape} mesh needs {n} ranks; "
                         f"{len(ranks)} given")
    grid = torch.tensor(ranks[:n]).reshape(plan.mesh_shape)
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=plan.axis_names)
    return mesh if mesh.get_coordinate() is not None else None


def remesh_opt_state(opt_state, params: dict, mesh: DeviceMesh,
                     rules: Optional[dict] = None):
    """Place live training state on a new mesh: ``(params, opt_state)``
    with every tensor a DTensor of ``mesh`` (Python ints, the step counts,
    stay as they are).  Parameters take ``param_spec``'s sharding and every
    state leaf the one train/trainer.py ``state_sharding`` gives it (the
    rule of ``train_state_shardings``): one placement re-balances every
    same-shaped block of the model over the new mesh.  The state is whole
    on every rank of ``mesh`` (a restore gives it so), and nothing is
    exchanged."""
    mr = rules_lib.MeshRules(mesh=mesh,
                             rules={**rules_lib.DEFAULT_LOGICAL_RULES,
                                    **(rules or {})})
    flat = tree.flatten(params)
    param_sh = tree.flatten(rules_lib.tree_param_shardings(params, mr))

    def assign(leaf: checkpoint.Leaf):
        if not isinstance(leaf.value, torch.Tensor):
            return leaf.value
        return rules_lib.place(leaf.value, trainer.state_sharding(
            leaf, flat, param_sh, mr))

    placed = tree.unflatten(params, [rules_lib.place(p, sh)
                                     for p, sh in zip(flat, param_sh)])
    return placed, checkpoint.map_leaves(assign, opt_state)


def merge_sketches_on_shrink(states: Sequence):
    """Fold per-shard sketch statistics into one on mesh shrink.

    ``states`` are structurally equal statistics trees (dicts, lists,
    tuples and NamedTuples: ``PrecondState.pools`` or one pool's stats);
    every ``FDState`` in them merges through
    ``sketch_merge.merge_stack_states``, in list order, and every other
    leaf passes through from the first state."""
    states = list(states)
    if len(states) == 1:
        return states[0]
    return _merge(states)


def _merge(xs: list):
    first = xs[0]
    if isinstance(first, FDState):
        return sketch_merge.merge_stack_states(xs)
    if isinstance(first, dict):
        return {k: _merge([x[k] for x in xs]) for k in first}
    if hasattr(first, "_fields"):
        return type(first)(*(_merge([x[i] for x in xs])
                             for i in range(len(first))))
    if isinstance(first, (list, tuple)):
        return type(first)(_merge([x[i] for x in xs])
                           for i in range(len(first)))
    return first


class StragglerMonitor:
    """Robust per-step latency anomaly detector: a step is flagged when it
    takes longer than the median plus ``k`` scaled median absolute
    deviations of the last ``window`` steps (once 10 are known)."""

    def __init__(self, window: int = 50, k: float = 6.0):
        self.window = window
        self.k = k
        self.times: List[float] = []
        self.flagged = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = _clock()

    def stop(self) -> float:
        """Returns the step time; adds one to ``flagged`` when anomalous."""
        assert self._t0 is not None, "start() not called"
        dt = _clock() - self._t0
        self._t0 = None
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if dt > med + self.k * 1.4826 * mad:
                self.flagged += 1
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0
