"""Serve-time online adaptation: S-AdaGrad on the head from live feedback
(port of repro/serve/adapt.py).

The model's head weights are the online decision vector of the paper's OCO
setting (Sec. 2 / Alg. 2): each feedback batch gives one loss and gradient,
and one S-AdaGrad engine step (``core/sadagrad.SAdaGradPreconditioner``, FD
sketch with rho compensation and ``beta2 < 1`` forgetting under drift)
updates the head between decode steps.  The chain is built through
``api.inject_hyperparams``, so ``set_hyperparams(learning_rate=...,
beta2=...)`` changes the live values in the optimizer state, for the next
step.  When to step is the caller's decision (serve/monitor.py's policy).

The gradient with respect to the flattened f32 head comes from autograd
with only the head requiring a gradient.  With tied embeddings the head is
``embed``, and the gradient flows back through every layer (the attention
and SSD kernels' Functions).  On the card the step's refresh Gram and its
apply are the split-d kernels of csrc/gram_tall.cu and csrc/lowrank_tall.cu
(at full width a (25,165,824, 8) sketch for paper-lm-100m, (114,688,000,
8) for zamba2-7b).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import api, transform
from repro_torch.core.sadagrad import ENGINE, SAdaGradPreconditioner
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    lr: float = 0.1       # online learning rate (injected, runtime-mutable)
    beta2: float = 0.99   # FD sketch EMA decay (injected, runtime-mutable)
    ell: int = 8          # sketch rank over the flattened head


def _pick_leaf(params: dict) -> str:
    # the adapted decision vector: the output head when untied, else the
    # tied embedding matrix (which then IS the head)
    return "lm_head" if "lm_head" in params else "embed"


class OnlineAdapter:
    """S-AdaGrad online learner over the flattened head leaf.

    ``grad(params, batch)``  -> (loss, flat_grad)   telemetry only (feeds
                                                    serve/monitor.py)
    ``step(params, batch)``  -> (new_params, loss)  one OCO update
    ``set_hyperparams(...)``                        runtime lr/beta2
    """

    def __init__(self, cfg: ModelConfig, params: dict,
                 adapt: Optional[AdaptConfig] = None):
        self.cfg = cfg
        self.adapt = adapt = adapt or AdaptConfig()
        self.leaf = _pick_leaf(params)
        head = params[self.leaf]
        self._shape, self._dtype = head.shape, head.dtype
        self.device = head.device
        self.d = head.numel()

        def build(learning_rate, beta2):
            return api.named_chain(
                ("precond", api.scale_by_preconditioner(
                    SAdaGradPreconditioner(adapt.ell, beta2), ENGINE)),
                ("lr", transform.scale(-learning_rate)))

        self._tx = api.inject_hyperparams(build)(
            learning_rate=adapt.lr, beta2=adapt.beta2)
        self.opt_state = self._tx.init(
            [torch.zeros((self.d,), dtype=torch.float32, device=self.device)])

    def _batch(self, batch: dict) -> dict:
        """Token arrays or tensors -> long tensors on the head's device."""
        return {k: torch.as_tensor(v).to(device=self.device, dtype=torch.long)
                for k, v in batch.items()}

    def _value_and_grad(self, params: dict, batch: dict):
        """(loss, flat f32 gradient, flat f32 head)."""
        w = params[self.leaf].detach().float().reshape(-1)
        w.requires_grad_(True)
        p = dict(params)
        p[self.leaf] = w.reshape(self._shape).to(self._dtype)
        with torch.enable_grad():
            loss = model_lib.loss_fn(self.cfg, p, self._batch(batch))
            (g,) = torch.autograd.grad(loss, [w])
        return loss.detach(), g, w.detach()

    # -- telemetry ----------------------------------------------------------

    def grad(self, params: dict, batch: dict
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Feedback loss and flattened head gradient, no update (the
        monitor observes these even while adaptation is paused)."""
        loss, g, _ = self._value_and_grad(params, batch)
        return loss, g

    # -- the OCO step -------------------------------------------------------

    def step(self, params: dict, batch: dict) -> Tuple[dict, torch.Tensor]:
        """One S-AdaGrad update on the head; returns (new_params, loss)."""
        loss, g, w = self._value_and_grad(params, batch)
        with torch.no_grad():
            (update,), self.opt_state = self._tx.update([g], self.opt_state)
            new_leaf = (w + update).reshape(self._shape).to(self._dtype)
        new_params = dict(params)
        new_params[self.leaf] = new_leaf
        return new_params, loss

    # -- runtime hyperparameters --------------------------------------------

    def set_hyperparams(self, **overrides) -> None:
        """Change lr/beta2 in the optimizer state (``api.set_hyperparams``):
        takes effect on the next step; KeyError on unknown names."""
        self.opt_state = api.set_hyperparams(self.opt_state, **overrides)

    @property
    def hyperparams(self) -> Dict[str, float]:
        hp = api.get_hyperparams(self.opt_state)
        return {k: float(hp[k]) for k in sorted(hp)}
