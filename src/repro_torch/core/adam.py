"""Adam, the paper's first-order baseline (port of repro/core/adam.py): a
linear-memory diagonal second moment.  Each leaf is handled whole, with no
blocking, grafting or refresh gating, so Adam is its own transformation
rather than a preconditioner on the blocked engine; its state is an engine
``PrecondState`` with no pools and one ``AdamLeafStats`` a leaf, so
``api.second_moment_bytes`` counts it as the reference counts its
diagonal-engine state.  The first moment lives in that state, so the
factory's chain has no momentum stage.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import api
from repro_torch.core.transform import (GradientTransformation, _promote,
                                        _weak)


EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    beta1: float = 0.9
    beta2: Any = 0.999          # may be an f32 scalar tensor (injected)
    state_dtype: torch.dtype = torch.float32


class AdamLeafStats(NamedTuple):
    mu: torch.Tensor    # first moment (bias-corrected at apply time)
    nu: torch.Tensor    # diagonal second moment

    second_moments = ("nu",)     # core/quantize.py; mu is momentum
    roles = {"mu": "momentum"}   # train/checkpoint.py


def adam(cfg: AdamConfig = AdamConfig()) -> GradientTransformation:
    """Adam's direction transform (emits a descent direction, no lr):
    moments in ``cfg.state_dtype``, updated in it (a Python beta rounded
    to it, as JAX's weak type; an injected f32 beta2 promotes ``nu`` to
    f32, as it does in the reference), then ``(mu / bc1) * rsqrt(nu / bc2
    + eps^2)`` in f32 with the bias corrections of step ``t = count + 1``."""

    def init_fn(params):
        return api.PrecondState(count=0, pools={}, leaves=tuple(
            api.LeafState(stats=AdamLeafStats(
                mu=torch.zeros(p.shape, dtype=cfg.state_dtype,
                               device=p.device),
                nu=torch.zeros(p.shape, dtype=cfg.state_dtype,
                               device=p.device)), graft=None)
            for p in params))

    def update_fn(updates, state, params=None):
        t = torch.tensor(state.count + 1, dtype=torch.float32)
        bc1 = 1 - torch.pow(cfg.beta1, t)
        bc2 = 1 - torch.pow(torch.as_tensor(cfg.beta2, dtype=torch.float32), t)
        b1, b2 = cfg.beta1, cfg.beta2
        out, leaves = [], []
        for g, leaf in zip(updates, state.leaves):
            mu0, nu0 = leaf.stats.mu, leaf.stats.nu
            mu = _weak(b1, mu0) * mu0 + _weak(1 - b1, mu0) * g.to(mu0.dtype)
            g2 = torch.square(g.to(nu0.dtype))
            nu = _promote(nu0, b2) * _weak(b2, nu0) \
                + _promote(g2, b2) * _weak(1 - b2, g2)
            out.append(((mu.float() / bc1)
                        * torch.rsqrt(nu.float() / bc2 + EPS ** 2))
                       .to(g.dtype))
            leaves.append(api.LeafState(stats=AdamLeafStats(mu=mu, nu=nu),
                                        graft=None))
        return out, api.PrecondState(count=state.count + 1, pools={},
                                     leaves=tuple(leaves))

    return GradientTransformation(init_fn, update_fn)
