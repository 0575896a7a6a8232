"""Collectives of the sharded statistics over ``torch.distributed`` (port of
repro/distributed/reduce.py).

The reference reduces over a mesh axis bound by ``shard_map``; here the
axis name is bound to a process group (``bind_axis``), which the trainer
does for the duration of a step (train/trainer.py).  Outside it the name
is unbound: ``bound_axis_size`` returns None and the engine takes the
replicated path, as the reference's does outside ``shard_map``.

``butterfly_merge_fd`` is the log-depth mergeable-sketch reduction: ``P``
ranks, each holding its own locally updated sketch stack, reach one merged
stack in ``log2(P)`` rounds of recursive doubling, with the FD merge as the
combiner.  Each round a rank packs its stack into the wire form
(``sketch_merge.pack_wire``), swaps it with rank ``i ^ dist`` and merges the
pair lower rank first, so both ranks of a pair compute the same bits (the
order of the columns matters to ``eigh``); after the last round every rank
holds the same stack.  A group whose size is no power of two takes one
all-gather of the wires and one wide merge (``_gather_shrink``).

The ranks talk over gloo: NCCL puts no two ranks on one card, and gloo's
point-to-point and its collectives take CPU tensors only.  So a tensor on
the card goes through a pinned host buffer and back, and every time
reported for a collective includes those copies.  ``pmean`` sums in f32
and casts each tensor back to its dtype.

``psum``, ``pmax`` and ``all_gather`` are the collectives of the
compressed gradient mean (train/compression.py) and the moe block's
expert-parallel path (models/moe.py), over the group bound to an axis
name or (the ``group_*`` forms) over a group given directly.  A floating
tensor is summed in f32 and cast back to its dtype, an integer one exactly
in its own; a max stays in the tensor's dtype.

``local_gradients`` is the side channel through which the trainer hands
the engine each rank's own gradients, while the optimizer chain (clipping,
grafting, momentum) consumes their mean.  ``merge_log``, when set to a
list, receives one record per butterfly round, gather or mean: what a rank
sent and how long it took (waiting for the other ranks included).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.core.fd import FDState, fd_merge_factors_batched
from repro_torch.distributed import sketch_merge

_local = threading.local()

# one record per exchange while a list: {"kind": "round" | "gather" |
# "mean" | "sum" | "max" | "all_gather", "dist": partner distance (0 but
# for a round), "bytes": sent (the host buffer of a mean, sum, max or
# all-gather), "exchange_s": the host copies and the transfer, "round_s":
# pack, exchange and merge (a mean, sum or all-gather: its copy back and
# cast too), the device synchronized at the end}
merge_log: Optional[list] = None


@contextlib.contextmanager
def bind_axis(axis: str, group):
    """Bind the axis name ``axis`` to the process group ``group``
    (``dist.group.WORLD`` for all ranks) inside the block."""
    prev = getattr(_local, "axes", {})
    _local.axes = {**prev, axis: group}
    try:
        yield
    finally:
        _local.axes = prev


def _group(axis: str):
    axes = getattr(_local, "axes", {})
    if axis not in axes:
        raise NameError(f"unbound axis name: {axis}")
    return axes[axis]


def bound_axis_size(axis: str) -> Optional[int]:
    """Size of the group bound to ``axis``, or None when it is unbound."""
    try:
        group = _group(axis)
    except NameError:
        return None
    return dist.get_world_size(group)


def pmean(x, axis: str):
    """Mean over the ranks of the group bound to ``axis`` of a tensor or a
    list or tuple of them (one all-reduce for all, summed in f32, each
    result cast back to its tensor's dtype)."""
    group = _group(axis)
    size = dist.get_world_size(group)
    if size == 1:
        return x
    t0 = time.perf_counter()
    leaves = [x] if isinstance(x, torch.Tensor) else list(x)
    flat = torch.cat([t.reshape(-1).float() for t in leaves])
    host = _to_host(flat)
    dist.all_reduce(host, group=group)
    if host is not flat:
        flat.copy_(host)         # back into the card's buffer: no second one
    flat.div_(size)
    t1 = time.perf_counter()
    out = [chunk.view(t.shape).to(t.dtype) for chunk, t in
           zip(flat.split([t.numel() for t in leaves]), leaves)]
    _log("mean", 0, [host], t0, t1, flat.device)
    return out[0] if isinstance(x, torch.Tensor) else type(x)(out)


def group_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maximized (``"max"``) over the ranks
    of ``group``, in a new tensor of ``x``'s dtype on its device: a
    floating ``x`` is summed in f32 (gloo's sum over the ranks in its own
    order, the same bits on every rank), an integer one exactly."""
    if dist.get_world_size(group) == 1:
        return x.clone()
    t0 = time.perf_counter()
    work = x.float() if op == "sum" and x.is_floating_point() else x
    host = _to_host(work.contiguous())
    if host.data_ptr() == x.data_ptr():
        host = host.clone()             # never reduce into the caller's x
    dist.all_reduce(host, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    t1 = time.perf_counter()
    out = host.to(x.device).to(x.dtype)
    _log(op, 0, [host], t0, t1, x.device)
    return out


def group_all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in group rank order."""
    size = dist.get_world_size(group)
    if size == 1:
        return x.clone()
    t0 = time.perf_counter()
    host = _to_host(x.contiguous())
    bufs = [torch.empty_like(host) for _ in range(size)]
    dist.all_gather(bufs, host, group=group)
    t1 = time.perf_counter()
    out = torch.cat(bufs, dim).to(x.device)
    _log("all_gather", 0, [host], t0, t1, x.device)
    return out


def psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``group_reduce`` sum over the group bound to ``axis``."""
    return group_reduce(x, _group(axis), "sum")


def pmax(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``group_reduce`` max over the group bound to ``axis``."""
    return group_reduce(x, _group(axis), "max")


@contextlib.contextmanager
def local_gradients(grads):
    """Expose this rank's own gradients to the engine inside the block;
    ``scale_by_preconditioner`` reads them (``current_local_gradients``)
    on its sharded-statistics path."""
    prev = getattr(_local, "grads", None)
    _local.grads = grads
    try:
        yield
    finally:
        _local.grads = prev


def current_local_gradients():
    return getattr(_local, "grads", None)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself on the CPU (or on meta: the dry run's shapes); else a
    pinned host copy."""
    if t.device.type in ("cpu", "meta"):
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _byte_order(wire: sketch_merge.WireSketch) -> list:
    """The wire's fields widest dtype first, so that every field starts at
    a byte offset its dtype can be viewed at."""
    return sorted(range(len(wire)), key=lambda i: -wire[i].element_size())


def _serialize(wire: sketch_merge.WireSketch) -> torch.Tensor:
    """The wire's tensors as one host byte buffer."""
    flat = torch.cat([wire[i].contiguous().reshape(-1).view(torch.uint8)
                      for i in _byte_order(wire)])
    return _to_host(flat)


def _deserialize(buf: torch.Tensor, like: sketch_merge.WireSketch
                 ) -> sketch_merge.WireSketch:
    """A wire of ``like``'s shapes, dtypes and device from its bytes."""
    buf = buf.to(like.values.device)
    order = _byte_order(like)
    chunks = buf.split([like[i].numel() * like[i].element_size()
                        for i in order])
    fields = dict(zip(order, chunks))
    return sketch_merge.WireSketch(*(
        fields[i].view(t.dtype).view(t.shape) for i, t in enumerate(like)))


def _global_rank(group, rank: int) -> int:
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _swap(wire: sketch_merge.WireSketch, group, peer: int
          ) -> sketch_merge.WireSketch:
    """Send ``wire`` to group rank ``peer`` and receive its wire."""
    send = _serialize(wire)
    recv = torch.empty_like(send)
    peer = _global_rank(group, peer)
    ops = [dist.P2POp(dist.isend, send, peer, group),
           dist.P2POp(dist.irecv, recv, peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _deserialize(recv, wire)


def _log(kind: str, distance: int, wire, t0: float, t1: float,
         device) -> None:
    if merge_log is None:
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    merge_log.append(dict(kind=kind, dist=distance,
                          bytes=sum(t.numel() * t.element_size()
                                    for t in wire),
                          exchange_s=t1 - t0,
                          round_s=time.perf_counter() - t0))


def _gather_shrink(state: FDState, *, group, ell: int,
                   wire_dtype: str) -> FDState:
    """The fallback of a group whose size is no power of two: one
    all-gather of the wires, one merge of all P factors."""
    t0 = time.perf_counter()
    wire = sketch_merge.pack_wire(state, wire_dtype)
    send = _serialize(wire)
    bufs = [torch.empty_like(send) for _ in range(dist.get_world_size(group))]
    dist.all_gather(bufs, send, group=group)
    gathered = [_deserialize(b, wire) for b in bufs]
    t1 = time.perf_counter()
    B = torch.stack([w.values.float() * w.scale for w in gathered])
    P, N, d, r = B.shape                       # (P, N, d, r) -> (N, d, P r)
    M = B.permute(1, 2, 0, 3).reshape(N, d, P * r)
    rho = torch.sum(torch.stack([w.rho for w in gathered]), dim=0)
    empty = torch.zeros((N, d, 0), dtype=torch.float32, device=M.device)
    merged = fd_merge_factors_batched(M, rho, empty, torch.zeros_like(rho),
                                      ell=ell)
    _log("gather", 0, wire, t0, t1, M.device)
    return merged


def butterfly_merge_fd(state: FDState, *, axis: str, axis_size: int,
                       wire_dtype: str = "int8") -> FDState:
    """Merge one pooled sketch stack (eigvecs (N, d, ell)) over the ranks of
    the group bound to ``axis``, of size ``axis_size``
    (``bound_axis_size``).  ``wire_dtype`` is ``"int8"`` (the default,
    about 4x fewer bytes) or ``"fp32"`` (exact: the FD merge bound holds
    with no rounding slack).  Returns the merged stack, the same bits on
    every rank, in ``state``'s dtypes."""
    if axis_size <= 1:
        return state
    group = _group(axis)
    ell = state.eigvecs.shape[-1]
    if axis_size & (axis_size - 1):
        merged = _gather_shrink(state, group=group, ell=ell,
                                wire_dtype=wire_dtype)
    else:
        idx = dist.get_rank(group)
        merged, distance = state, 1
        while distance < axis_size:
            t0 = time.perf_counter()
            wire = sketch_merge.pack_wire(merged, wire_dtype)
            other = _swap(wire, group, idx ^ distance)
            t1 = time.perf_counter()
            lo, hi = (wire, other) if idx & distance == 0 else (other, wire)
            merged = sketch_merge.merge_wire(lo, hi, ell=ell)
            _log("round", distance, wire, t0, t1, merged.eigvecs.device)
            distance *= 2
    return FDState(eigvecs=merged.eigvecs.to(state.eigvecs.dtype),
                   eigvals=merged.eigvals.to(state.eigvals.dtype),
                   rho=merged.rho.to(state.rho.dtype))
