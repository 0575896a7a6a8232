"""Gradient transformations over flat tensor lists (port of
repro/core/transform.py).

A transformation is an ``(init, update)`` pair.  ``init(params)`` builds a
state from the flat parameter list; ``update(updates, state, params)``
returns the transformed flat update list and the new state.  Lists are in
the JAX canonical leaf order (repro_torch/tree.py), so the stages line up
with the reference's one for one.  Updates are returned as new tensors; only
``apply_updates`` writes in place, into the parameters.

The dtype rules follow the reference: a scalar hyperparameter held as an
f32 tensor promotes a bf16 update to f32 (``_promote``), as a non-weak f32
array does in JAX, where a Python float keeps the update's dtype and is
itself rounded to it first, as JAX's weak type is (``_weak``: a bf16
momentum decays by bf16(0.9) = 0.8984375).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


def _weak(c, like: torch.Tensor):
    """A Python scalar in an op with ``like``, as JAX's weak type: rounded
    to ``like``'s dtype when that is a half-precision float (f32 ops take
    the scalar as it is, which is the same); a tensor passes through."""
    if isinstance(c, torch.Tensor) \
            or like.dtype not in (torch.bfloat16, torch.float16):
        return c
    return torch.tensor(c, dtype=like.dtype)


def _promote(u: torch.Tensor, factor) -> torch.Tensor:
    if isinstance(factor, torch.Tensor):
        return u.to(torch.promote_types(u.dtype, factor.dtype))
    return u


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Compose transformations; state is a tuple of member states."""

    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def scale(factor) -> GradientTransformation:
    def init_fn(params):
        return EmptyState()

    def update_fn(updates, state, params=None):
        return [_promote(u, factor) * _weak(factor, u) for u in updates], \
            state

    return GradientTransformation(init_fn, update_fn)


class TraceState(NamedTuple):
    momentum: list

    roles = {"momentum": "momentum"}     # train/checkpoint.py


def momentum(beta1: float, *, ema: bool = True,
             dtype: torch.dtype | None = None) -> GradientTransformation:
    """Heavy-ball / EMA momentum.  ``ema=True`` is the paper's
    ``moving_average_for_momentum``, ``beta1 * mu + (1 - beta1) * g``;
    ``ema=False`` accumulates ``beta1 * mu + g``.  The buffer is held in
    ``dtype`` (default: each parameter's); the update leaves in the
    gradient's dtype."""

    def init_fn(params):
        return TraceState(momentum=[torch.zeros_like(p, dtype=dtype or p.dtype)
                                    for p in params])

    def update_fn(updates, state, params=None):
        if ema:
            mu = [_weak(beta1, m) * m + _weak(1.0 - beta1, m) * u.to(m.dtype)
                  for u, m in zip(updates, state.momentum)]
        else:
            mu = [_weak(beta1, m) * m + u.to(m.dtype)
                  for u, m in zip(updates, state.momentum)]
        out = [m.to(u.dtype) for u, m in zip(updates, mu)]
        return out, TraceState(momentum=mu)

    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    """Decoupled weight decay."""

    def init_fn(params):
        return EmptyState()

    def update_fn(updates, state, params=None):
        if weight_decay == 0.0 or params is None:
            return updates, state
        return [u + _weak(weight_decay, u) * p.to(u.dtype)
                for u, p in zip(updates, params)], state

    return GradientTransformation(init_fn, update_fn)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def init_fn(params):
        return EmptyState()

    def update_fn(updates, state, params=None):
        gnorm = torch.sqrt(sum(torch.sum(torch.square(u.float()))
                               for u in updates))
        scale_f = torch.clamp(max_norm / (gnorm + 1e-16), max=1.0)
        return [(_promote(u, scale_f) * scale_f).to(u.dtype)
                for u in updates], state

    return GradientTransformation(init_fn, update_fn)


@torch.no_grad()
def apply_updates(params: list, updates: list) -> None:
    """params += updates, in place (updates carry the negative lr)."""
    for p, u in zip(params, updates):
        p.add_(u.to(p.dtype))
