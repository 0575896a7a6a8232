"""Gradient compression for the data-parallel mean (port of
repro/train/compression.py).

Each gradient leaf is scaled by its absmax over the ranks (one f32 ``pmax``
a leaf), rounded stochastically to int8 (the scale/round core of
core/quantize.py, shared with the int8 second-moment storage), summed over
the ranks in int32, and divided by their number: an unbiased mean within
one int8 step, ``scale = absmax / 127``, of the exact one.

The wire is not smaller than an f32 mean's.  The sum runs in int32, 4 B an
element on every rank, as the reference's does (``q.astype(jnp.int32)``
before its ``psum``): int8 values summed in int8 would overflow past one
rank.  What a rank sends per leaf is 4 B an element plus the 4 B of its
``pmax``.

Over ``torch.distributed`` the dp axes are the process groups bound to
their names (distributed/reduce.py ``bind_axis``; ``compressed_mean_grads``
binds a mesh's).  The reference draws each leaf's noise from
``fold_in(PRNGKey(seed), i)``, the same key on every device; here leaf i
draws from the generator of ``quantize.fold_in((seed,), i)``, the same
stream on every rank.  It cannot give ``jax.random``'s bits, only the same
distribution; rounding to nearest (``gen=None``) gives the reference's
bits.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree
from repro_torch.core import quantize
from repro_torch.distributed import reduce

PyTree = Any


def int8_sum(g: torch.Tensor, axes: Sequence[str],
             gen: Optional[torch.Generator] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the int32 sum over the bound axes of every rank's int8 ``g /
    scale``, rounded with ``gen`` (stochastic) or to nearest; the f32
    ``scale``, from the absmax of ``g`` over all those ranks)."""
    g32 = g.float()
    absmax = torch.amax(torch.abs(g32))
    for a in axes:
        absmax = reduce.pmax(absmax, a)
    scale = quantize.int8_scale(absmax)
    summed = quantize.round_int8(g32 / scale, gen).to(torch.int32)
    for a in axes:
        summed = reduce.psum(summed, a)
    return summed, scale


def quantized_psum(g: torch.Tensor, axes: Sequence[str],
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """int8 quantize -> int32 sum -> rescaled mean over the bound axes, in
    ``g``'s dtype (``int8_sum``)."""
    summed, scale = int8_sum(g, axes, gen)
    n = math.prod(reduce.bound_axis_size(a) for a in axes)
    return (summed.float() * scale / n).to(g.dtype)


def _leaves(grads) -> list:
    if isinstance(grads, (list, tuple)):
        return list(grads)
    return tree.flatten(grads)


def _rebuild(grads, leaves: list):
    if isinstance(grads, (list, tuple)):
        return type(grads)(leaves)
    return tree.unflatten(grads, leaves)


def compressed_mean_grads(grads: PyTree, mesh: DeviceMesh,
                          dp_axes: Sequence[str] = ("data",),
                          seed: int = 0) -> PyTree:
    """Mean of every rank's gradients (a dict, list or tuple of tensors,
    each rank its own microbatch's) over the ``dp_axes`` of ``mesh``, with
    int8 transport; unchanged when none of them is in the mesh."""
    axes = tuple(a for a in dp_axes if a in mesh.mesh_dim_names)
    if not axes:
        return grads
    out = []
    with contextlib.ExitStack() as stack:
        for a in axes:
            stack.enter_context(reduce.bind_axis(a, mesh.get_group(a)))
        for i, g in enumerate(_leaves(grads)):
            gen = quantize.generator(quantize.fold_in((seed,), i), g.device)
            out.append(quantized_psum(g, axes, gen))
    return _rebuild(grads, out)
