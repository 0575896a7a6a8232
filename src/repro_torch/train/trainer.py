"""The training step on one device (port of repro/train/trainer.py
``make_train_step`` without microbatches or a mesh).

The step differentiates the loss with autograd, runs the optimizer chain
over the gradients in the JAX canonical leaf order (repro_torch/tree.py) and
adds the updates to the parameters in place.  The two phases are labelled
for ``torch.profiler`` ("train/forward_backward", "train/optimizer"); the
labels cost nothing measurable when no profiler runs.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch import tree
from repro_torch.core.transform import GradientTransformation, apply_updates
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


def make_train_step(cfg: ModelConfig, tx: GradientTransformation) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the nested parameter dict (its tensors are updated in
    place and returned), ``opt_state`` the chain state from
    ``tx.init(tree.flatten(params))``, ``batch`` a dict of token tensors on
    the parameters' device.  ``metrics`` holds the loss and the global
    gradient norm as f32 scalar tensors."""

    def train_step(params: dict, opt_state, batch: dict):
        leaves = tree.flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        with record_function("train/forward_backward"):
            loss = model_lib.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad(), record_function("train/optimizer"):
            updates, opt_state = tx.update(list(grads), opt_state, leaves)
            apply_updates(leaves, updates)
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return train_step
