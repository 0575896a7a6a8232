"""Distributed FD: sharded second-moment statistics through mergeable
sketches (port of repro/distributed/).

Each data-parallel rank FD-updates its pooled sketch stacks on its own
gradients (``core/fd.fd_update_batched``), and at refresh time a log-depth
butterfly over the ranks' process group (``reduce.butterfly_merge_fd``)
merges the (N, d, ell) stacks through ``core/fd.fd_merge_factors_batched``.
The factors travel in int8 (``sketch_merge.pack_wire``): about ``ell * d``
bytes a block, not the ``d^2`` f32 of a dense statistic.

``stats_reduction="sharded"`` (core/api.EngineConfig, core/sketchy,
core/factory, launch/train.py) turns it on; with no group bound to the
axis, or a group of one, the engine's path is the replicated one, bit for
bit.
"""
from repro_torch.distributed.reduce import (bind_axis, bound_axis_size,
                                            butterfly_merge_fd,
                                            current_local_gradients,
                                            group_all_gather, group_reduce,
                                            local_gradients, pmax, pmean,
                                            psum)
from repro_torch.distributed.sketch_merge import (WIRE_DTYPES, WireSketch,
                                                  merge_stack_states,
                                                  merge_wire, pack_wire,
                                                  unpack_wire, wire_bytes)

__all__ = [
    "bind_axis", "bound_axis_size", "butterfly_merge_fd",
    "current_local_gradients", "group_all_gather", "group_reduce",
    "local_gradients", "pmax", "pmean", "psum", "WIRE_DTYPES",
    "WireSketch", "merge_stack_states", "merge_wire", "pack_wire",
    "unpack_wire", "wire_bytes",
]
