"""The training step (port of repro/train/trainer.py ``make_train_step``
without microbatches; the reference's data-parallel mesh becomes a
process group).

The step differentiates the loss with autograd, runs the optimizer chain
over the gradients in the JAX canonical leaf order (repro_torch/tree.py) and
adds the updates to the parameters in place.  The two phases are labelled
for ``torch.profiler`` ("train/forward_backward", "train/optimizer"); the
labels cost nothing measurable when no profiler runs.

With a ``data_parallel_group`` of P ranks (the reference's ``shard_body``),
rank r takes its slice of the global batch, differentiates its own loss,
and the chain consumes the mean over the ranks of the loss and the
gradients (distributed/reduce.py ``pmean``), so clipping, grafting and
momentum see what a replicated step sees; the rank's own gradients go to
the engine's sharded statistics (``local_gradients``), with the axis name
``"data"`` bound to the group for the update.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch import tree
from repro_torch.core.transform import GradientTransformation, apply_updates
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig

DATA_AXIS = "data"     # the engine's default ``stats_axis``


def shard_batch(batch: dict, rank: int, size: int) -> dict:
    """Rank ``rank``'s rows of a global batch split over ``size`` ranks:
    rows ``rank * B / size`` to ``(rank + 1) * B / size`` of the batch dim,
    axis 1 of ``positions`` (3, B, S) and axis 0 of everything else."""
    out = {}
    for key, x in batch.items():
        axis = 1 if key == "positions" else 0
        if x.shape[axis] % size:
            raise ValueError(f"batch dim {x.shape[axis]} of {key!r} not "
                             f"divisible by {size} ranks")
        n = x.shape[axis] // size
        out[key] = x.narrow(axis, rank * n, n)
    return out


def make_train_step(cfg: ModelConfig, tx: GradientTransformation, *,
                    data_parallel_group=None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the nested parameter dict (its tensors are updated in
    place and returned), ``opt_state`` the chain state from
    ``tx.init(tree.flatten(params))``, ``batch`` a dict of token tensors on
    the parameters' device (the global batch).  ``metrics`` holds the loss
    and the global gradient norm as f32 scalar tensors.

    ``data_parallel_group`` (a ``torch.distributed`` process group, of
    which this process is a rank): the step is data-parallel over it, as
    the module docstring says; None is the step on one device."""

    def loss_and_grads(params: dict, batch: dict):
        leaves = tree.flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        with record_function("train/forward_backward"):
            loss = model_lib.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves)
        return leaves, loss.detach(), list(grads)

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
