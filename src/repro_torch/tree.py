"""Nested-dict parameter trees in JAX's canonical leaf order.

``jax.tree.flatten`` visits dict keys in sorted order; the optimizer's pool
membership and offsets follow that order (repro/core/pool.py), so the port
flattens its parameter dicts the same way.  Anything that is not a dict is
a leaf (tensors, shape tuples).
"""
from __future__ import annotations

from typing import Any, Iterator


def flatten(tree: Any) -> list:
    """Leaves of ``tree`` in ``jax.tree.flatten`` order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    return [tree]


def structure(tree: Any) -> Any:
    """The nested key structure of ``tree``, leaves replaced by None."""
    if isinstance(tree, dict):
        return {key: structure(value) for key, value in tree.items()}
    return None


def unflatten(like: Any, leaves: list) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` in ``flatten`` order."""
    it: Iterator = iter(leaves)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has positions")
    return out


def _build(node: Any, it: Iterator) -> Any:
    # recursion at module level: a nested function that calls itself is a
    # reference cycle, which keeps what it holds until the cyclic collector
    # runs
    if isinstance(node, dict):
        return {key: _build(node[key], it) for key in sorted(node)}
    return next(it)
