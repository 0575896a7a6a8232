"""The training step and the optimizer state's shardings (port of
repro/train/trainer.py; the reference's data-parallel mesh becomes a
process group).

The step differentiates the loss with autograd, runs the optimizer chain
over the gradients in the JAX canonical leaf order (repro_torch/tree.py) and
adds the updates to the parameters in place.  The two phases are labelled
for ``torch.profiler`` ("train/forward_backward", "train/optimizer"); the
labels cost nothing measurable when no profiler runs.

With ``microbatches=M`` (the reference's :63-96) the batch dim (axis 1 of
``positions``) is cut into M equal microbatches, differentiated one after
the other; the loss is summed in f32 and the gradients in the parameters'
dtype, microbatch by microbatch in order from zero as the reference's
``scan`` adds them, both scaled by 1/M, and the optimizer updates once.

With a ``data_parallel_group`` of P ranks (the reference's ``shard_body``),
rank r takes its slice of the global batch, differentiates its own loss,
and the chain consumes the mean over the ranks of the loss and the
gradients (distributed/reduce.py ``pmean``), so clipping, grafting and
momentum see what a replicated step sees; the rank's own gradients go to
the engine's sharded statistics (``local_gradients``), with the axis name
``"data"`` bound to the group for the update.  Each rank microbatches its
own slice.

``train_state_shardings`` (the reference's :158-end) gives every leaf of
an optimizer state its ``NamedSharding`` (sharding/rules.py) on a mesh;
``state_sharding`` is its rule for one leaf, which
train/elastic.py ``remesh_opt_state`` places a state by.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch import tree
from repro_torch.core.transform import GradientTransformation, apply_updates
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import rules as rules_lib
from repro_torch.train import checkpoint

DATA_AXIS = "data"     # the engine's default ``stats_axis``


def split_microbatches(batch: dict, microbatches: int) -> list:
    """``batch`` cut into ``microbatches`` equal consecutive pieces of its
    batch dim (axis 1 of ``positions``, axis 0 of everything else)."""
    out = [{} for _ in range(microbatches)]
    for key, x in batch.items():
        axis = 1 if key == "positions" else 0
        if x.shape[axis] % microbatches:
            raise ValueError(f"batch dim {x.shape[axis]} of {key!r} not "
                             f"divisible by {microbatches}")
        for piece, part in zip(out, x.chunk(microbatches, axis)):
            piece[key] = part
    return out


def shard_batch(batch: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s rows of a global batch split over ``size`` ranks:
    the ``rank``-th of ``split_microbatches(batch, size)``."""
    return split_microbatches(batch, size)[rank]


def make_train_step(cfg: ModelConfig, tx: GradientTransformation, *,
                    microbatches: Optional[int] = None,
                    data_parallel_group=None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the nested parameter dict (its tensors are updated in
    place and returned), ``opt_state`` the chain state from
    ``tx.init(tree.flatten(params))``, ``batch`` a dict of token tensors on
    the parameters' device (the global batch).  ``metrics`` holds the loss
    and the global gradient norm as f32 scalar tensors.

    ``data_parallel_group`` (a ``torch.distributed`` process group, of
    which this process is a rank): the step is data-parallel over it, as
    the module docstring says; None is the step on one device.
    ``microbatches`` (None or 1: the whole batch at once) accumulates the
    gradients of that many microbatches before the update."""

    def loss_and_grads(params: dict, batch: dict):
        leaves = tree.flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        with record_function("train/forward_backward"):
            if not microbatches or microbatches == 1:
                loss = model_lib.loss_fn(cfg, params, batch)
                return leaves, loss.detach(), \
                    list(torch.autograd.grad(loss, leaves))
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = [torch.zeros_like(p) for p in leaves]
            for piece in split_microbatches(batch, microbatches):
                mloss = model_lib.loss_fn(cfg, params, piece)
                for acc, g in zip(grads, torch.autograd.grad(mloss, leaves)):
                    acc.add_(g)
                loss = loss + mloss.detach()
            # 1/M in each accumulator's dtype, as the reference's weakly
            # typed Python scalar
            inv = 1.0 / microbatches
            for acc in grads:
                acc.mul_(torch.tensor(inv, dtype=acc.dtype))
        return leaves, loss * inv, grads

    def finish(leaves, opt_state, grads, loss):
        updates, opt_state = tx.update(grads, opt_state, leaves)
        apply_updates(leaves, updates)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        return opt_state, {"loss": loss, "grad_norm": gnorm}

    def train_step(params: dict, opt_state, batch: dict):
        leaves, loss, grads = loss_and_grads(params, batch)
        with torch.no_grad(), record_function("train/optimizer"):
            opt_state, metrics = finish(leaves, opt_state, grads, loss)
        return params, opt_state, metrics

    if data_parallel_group is None:
        return train_step

    import torch.distributed as dist

    from repro_torch.distributed import reduce as dreduce
    group = data_parallel_group
    rank, size = dist.get_rank(group), dist.get_world_size(group)

    def sharded_train_step(params: dict, opt_state, batch: dict):
        leaves, loss_local, grads_local = loss_and_grads(
            params, shard_batch(batch, rank, size))
        with torch.no_grad(), record_function("train/optimizer"), \
                dreduce.bind_axis(DATA_AXIS, group):
            loss, *grads = dreduce.pmean([loss_local, *grads_local],
                                         DATA_AXIS)
            with dreduce.local_gradients(grads_local):
                opt_state, metrics = finish(leaves, opt_state, grads, loss)
        return params, opt_state, metrics

    return sharded_train_step


# ---------------------------------------------------------------------------
# Sharding assignment for optimizer state

# a per-parameter leaf (momentum, grafting accumulator, diagonal statistic,
# Adam's moments, or one of their int8 containers' tensors), named by the
# flat parameter index (train/checkpoint.py names)
_PER_PARAM = re.compile(r"(?:^|::)\.(?:momentum|leaves)::(\d+)(?:::|$)")
# a pooled stack: the engine's pools and the async pending slot
_POOLED = re.compile(r"(?:^|::)\.(?:pools|pending)::")


def state_sharding(leaf: checkpoint.Leaf, flat_params: list,
                   param_shardings: list,
                   rules: rules_lib.MeshRules) -> rules_lib.NamedSharding:
    """One state leaf's sharding: the reference's ``StateMeta`` walk, read
    from the leaf's checkpoint role and name.  Counts and hyperparameters
    replicate; every pooled stack (the engine's pools and the async pending
    slot; an int8 stack's values and scale alike) takes ``blocks_sharding``
    along its leading blocks dim; a per-parameter leaf of its parameter's
    shape takes the parameter's sharding; the rest replicate."""
    replicated = rules_lib.NamedSharding(rules.mesh, rules_lib.P())
    x = leaf.value
    if leaf.role in ("count", "hyperparam") or not isinstance(x, torch.Tensor):
        return replicated
    if _POOLED.search(leaf.name):
        return rules_lib.blocks_sharding(rules, x)
    per_param = _PER_PARAM.search(leaf.name)
    if per_param and x.shape == flat_params[int(per_param.group(1))].shape:
        return param_shardings[int(per_param.group(1))]
    return replicated


def train_state_shardings(opt_state, params: dict,
                          rules: rules_lib.MeshRules):
    """``NamedSharding``s for an optimizer state, in its structure (works
    on meta tensors): ``state_sharding`` of every leaf, Python ints (the
    step counts) included.  ``params`` is the nested parameter dict whose
    flat leaves the state's per-parameter entries follow.  This is the one
    rule: train/elastic.py ``remesh_opt_state`` places a live state leaf by
    leaf with ``state_sharding`` too, so a remeshed state and a dry-run
    plan (launch/dryrun_lib.py) shard alike."""
    flat = tree.flatten(params)
    param_sh = tree.flatten(rules_lib.tree_param_shardings(params, rules))
    return checkpoint.map_leaves(
        lambda leaf: state_sharding(leaf, flat, param_sh, rules), opt_state)
