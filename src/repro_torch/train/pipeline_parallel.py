"""GPipe-style pipeline parallelism over a ``torch.distributed`` process
group (port of repro/train/pipeline_parallel.py; the group is the
reference's 'pipe' mesh axis).

The layer stack is cut into as many stages as the group has ranks: rank r
holds layers ``[r L / n, (r + 1) L / n)``.  Microbatches stream through in
the reference's schedule, ``M + n - 1`` ticks: at tick t every stage
receives what the previous stage computed at t - 1 (the last stage's goes
round to stage 0, as the reference's ring ``ppermute``), stage 0 takes
microbatch t instead while t < M, each stage runs its layers, and the last
stage keeps microbatch ``t - (n - 1)``'s output.  Every stage computes at
every tick, as the reference does (a stage outside its microbatches
computes on what it received, which reaches no output).  The outputs then
reach every rank through a sum over the group (the reference's ``psum``;
the other stages contribute zeros).

Autograd differentiates it: the permute is a ``torch.autograd.Function``
whose forward sends to the next stage and receives from the previous one
(``dist.batch_isend_irecv``) and whose backward sends the cotangent the
other way; the sum passes its cotangent through (each rank's loss is the
one replicated loss, as under the reference's ``shard_map``), and x's
cotangent is summed over the group, so every rank gets x's whole
gradient, as a replicated input's.  The backward runs each tick's
exchange on every rank in the same order, and the sum of x's cotangent
after the last of them, because every tick's received tensor feeds the
rank's output and needs a gradient: a stage's chain of ticks is linear
from a first state tied to x, stage 0's injected microbatch is tied to
the tensor it received in its place, and the last tick's state to the
output, each tie with a zero cotangent.  The exchanges go through host
buffers (gloo's point-to-point takes CPU tensors), so several ranks may
share one card.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import tree


def _exchange(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to`` and return what group rank ``frm``
    sends (same shape and dtype), through host buffers for a tensor on the
    card (gloo's point-to-point takes CPU tensors)."""
    host = x.detach().contiguous().to("cpu")
    got = torch.empty_like(host)
    ops = [dist.P2POp(dist.isend, host, dist.get_global_rank(group, to),
                      group),
           dist.P2POp(dist.irecv, got, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got.to(x.device)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, in a new tensor (through a host copy)."""
    host = x.detach().contiguous().to("cpu", copy=True)
    dist.all_reduce(host, group=group)
    return host.to(x.device)


class _Permute(torch.autograd.Function):
    """Ring shift to the next stage; backward shifts the cotangent back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _exchange(x, group, (r + 1) % n, (r - 1) % n)

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _exchange(grad, group, (r - 1) % n, (r + 1) % n), None


class _Replicated(torch.autograd.Function):
    """A tensor every rank holds: identity; the cotangent is summed over
    the group (each rank's part of the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _Tie(torch.autograd.Function):
    """``a`` itself, with ``b`` in its graph: ``b`` gets a zero cotangent,
    so what produced ``b`` runs in the backward on every rank, after what
    ``a`` feeds (a product with zero would turn a non-finite ``b`` into
    NaNs)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.b = (b.shape, b.dtype, b.device)
        return a.clone()

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.b
        return grad, torch.zeros(shape, dtype=dtype, device=device)


class _Sum(torch.autograd.Function):
    """Sum over the group; the cotangent passes through."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gpipe_apply(group, layers: dict, block_fn: Callable, x: torch.Tensor,
                microbatches: int) -> torch.Tensor:
    """Run ``block_fn`` over a layer stack pipelined across ``group``.

    layers: this rank's stage, a nested dict of tensors stacked on dim 0
    (its ``L / n`` layers of the whole stack); ``block_fn(layer, h)`` one
    layer, ``layer`` the dict of one slice; x: (B, ...) activations, the
    same on every rank, B % microbatches == 0.  Returns the stack's output
    (B, ...) on every rank."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} not divisible by {microbatches} "
                         f"microbatches")
    M = microbatches
    if n > 1:
        x = _Replicated.apply(x, group)
    xm = x.reshape(M, B // M, *x.shape[1:])
    stacks = tree.flatten(layers)
    depth = {v.shape[0] for v in stacks}
    if len(depth) != 1:
        raise ValueError(f"the stage's stacks differ in depth: {depth}")
    depth = depth.pop()

    def stage_apply(h):
        for i in range(depth):
            h = block_fn(tree.unflatten(layers, [v[i] for v in stacks]), h)
        return h

    needs_grad = torch.is_grad_enabled() and (x.requires_grad or any(
        v.requires_grad for v in stacks))
    state = torch.zeros_like(xm[0]).requires_grad_(needs_grad)
    if needs_grad and x.requires_grad:
        state = _Tie.apply(state, xm)
    outs = [torch.zeros_like(xm[0]) for _ in range(M)]
    for t in range(M + n - 1):
        recv = _Permute.apply(state, group) if n > 1 else state
        cur = _Tie.apply(xm[t], recv) if idx == 0 and t < M else recv
        state = stage_apply(cur)
        m_idx = t - (n - 1)
        if m_idx >= 0 and idx == n - 1:
            outs[m_idx] = state
    # the last tick's state reaches no output; the tie keeps its chain of
    # exchanges in every rank's backward
    out = _Tie.apply(torch.stack(outs), state)
    if n > 1:
        out = _Sum.apply(out, group)
    return out.reshape(B, *x.shape[1:])
