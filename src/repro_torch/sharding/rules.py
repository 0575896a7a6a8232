"""Logical-axis sharding rules over a ``torch.distributed`` device mesh
(port of repro/sharding/rules.py, the part its callers in the port need).

A ``MeshRules`` maps the model's logical axes ('batch', 'fsdp', 'experts',
'opt_blocks', ...) onto the named dimensions of a
``torch.distributed.device_mesh.DeviceMesh`` ('pod', 'data', 'model'), as
``DEFAULT_LOGICAL_RULES`` says.  A ``PartitionSpec`` has one entry per
tensor dimension: None, a mesh dimension's name, or a tuple of names, the
first outermost (the reference's ``jax.sharding.PartitionSpec``).
Parameters take their specs from ``PARAM_RULES`` by path (first match
wins; a spec shorter than the tensor's rank is padded with None on the
left, for the stack dimensions).  ``NamedSharding.placements`` turns a spec
into DTensor placements, one per mesh dimension (``Shard``, ``Replicate``);
a tensor dimension split over several mesh dimensions in another order
than the mesh's own takes ``_StridedShard`` for the inner ones, since
DTensor's ``Shard`` splits the first mesh dimension outermost:
``opt_blocks`` = ('model', 'data') on a ('data', 'model') mesh is
model-major, as the reference lays it out.  ``place`` makes each rank's
DTensor from a tensor every rank holds whole: each rank slices its own
copy, with no collective.

Where the port differs:
  * ``use_mesh`` sets a process-wide context, not a thread-local one.  On
    the card the autograd engine runs the backward on a thread of its own,
    and with it the recompute of a checkpointed layer (``cfg.remat``),
    which must take the path its forward took (models/moe.py).  Inside the
    block it also binds each mesh dimension's process group to the
    dimension's name on the calling thread (distributed/reduce.py
    ``bind_axis``), so the sharded statistics reduce over the same axis.
  * Left out: ``constrain`` (:95), a layout hint for GSPMD with no meaning
    in eager PyTorch (no module of the port calls it), and the
    ``shard_map`` shim (:23): each rank runs the body of a ``shard_map``
    itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch import tree
from repro_torch.distributed import reduce

# logical axis -> mesh axis (tuple = sharded over several mesh axes, the
# first outermost)
DEFAULT_LOGICAL_RULES = {
    "batch": ("pod", "data"),     # DP over pod + data
    "fsdp": "data",               # param row sharding (ZeRO-3 style)
    "tensor": "model",            # TP
    "vocab": "model",
    "experts": "model",           # EP
    "kv_seq": "model",            # decode-cache sequence sharding (SP)
    "seq": None,                  # training seq unsharded by default
    "embed": None,                # residual d_model dim (activations)
    "heads": "model",
    "stack": None,                # scan-over-layers stack dim
    # optimizer per-block state: leading blocks dim tiled model-major
    "opt_blocks": ("model", "data"),
}


class PartitionSpec(tuple):
    """One entry per tensor dimension (missing trailing entries are None):
    None, a mesh dimension's name, or a tuple of names, outermost first."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_sizes(mesh: DeviceMesh) -> dict:
    """Mesh dimension name -> its size."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: DeviceMesh
    spec: PartitionSpec

    def placements(self) -> list:
        """DTensor placements, one per mesh dimension."""
        sizes = mesh_sizes(self.mesh)
        names = list(self.mesh.mesh_dim_names)
        out = []
        for i, name in enumerate(names):
            placement = Replicate()
            for dim, entry in enumerate(self.spec):
                axes = _axes(entry)
                if name not in axes:
                    continue
                # the shards of axes outer to this one in the spec that
                # DTensor would split after it (later in the mesh)
                split = math.prod(sizes[a] for a in axes[:axes.index(name)]
                                  if names.index(a) > i)
                placement = Shard(dim) if split == 1 else \
                    _StridedShard(dim, split_factor=split)
            out.append(placement)
        return out


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """This rank's DTensor of ``x``, which every rank of the mesh holds
    whole: its local shard sliced from its own copy (no collective)."""
    return distribute_tensor(x, sharding.mesh, sharding.placements(),
                             src_data_rank=None)


@dataclasses.dataclass
class MeshRules:
    mesh: DeviceMesh
    rules: dict

    def axis(self, logical: Optional[str]):
        if logical is None:
            return None
        mapped = self.rules.get(logical, None)
        if mapped is None:
            return None
        axes = mapped if isinstance(mapped, tuple) else (mapped,)
        present = tuple(a for a in axes if a in self.mesh.mesh_dim_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, *logical_axes) -> PartitionSpec:
        return P(*(self.axis(a) for a in logical_axes))


_current: Optional[MeshRules] = None


def current() -> Optional[MeshRules]:
    return _current


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh, rules: Optional[dict] = None):
    """The mesh and its rules as the process's context inside the block, each
    mesh dimension's process group bound to its name (``reduce.bind_axis``)
    on the calling thread.  Only ranks of the mesh may enter it."""
    global _current
    prev = _current
    _current = MeshRules(mesh=mesh, rules={**DEFAULT_LOGICAL_RULES,
                                           **(rules or {})})
    try:
        with contextlib.ExitStack() as stack:
            for name in mesh.mesh_dim_names:
                stack.enter_context(reduce.bind_axis(name,
                                                     mesh.get_group(name)))
            yield _current
    finally:
        _current = prev


def dp_axis_names(mesh: DeviceMesh) -> tuple:
    """Mesh axes the ``batch`` logical axis maps onto: the data-parallel
    axes a gradient mean or a sketch merge reduces over."""
    mapped = DEFAULT_LOGICAL_RULES["batch"]
    axes = mapped if isinstance(mapped, tuple) else (mapped,)
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def axis_extent(logical: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 = unmapped)."""
    r = current()
    if r is None:
        return 1
    ax = r.axis(logical)
    if ax is None:
        return 1
    sizes = mesh_sizes(r.mesh)
    return math.prod(sizes[a] for a in _axes(ax))


# ---------------------------------------------------------------------------
# Parameter specs by path.  Paths are '/'-joined dict keys.  Patterns are
# tried in order; first match wins.  Specs are right-aligned to the
# parameter's rank, left-padded with None (stack dimensions).
PARAM_RULES: Sequence[tuple[str, tuple]] = (
    (r".*embed.*", ("vocab", "fsdp")),
    (r".*lm_head.*", ("fsdp", "vocab")),
    (r".*experts.*/w_(gate|up)", ("experts", "fsdp", None)),
    (r".*experts.*/w_down", ("experts", None, "fsdp")),
    (r".*router.*", ("fsdp", None)),
    (r".*/(wq|wk|wv|wqkv)$", ("fsdp", "tensor")),
    (r".*/(wo)$", ("tensor", "fsdp")),
    (r".*/(bq|bk|bv)$", ("tensor",)),
    (r".*/w_(gate|up)$", ("fsdp", "tensor")),
    (r".*/w_down$", ("tensor", "fsdp")),
    (r".*/in_proj$", ("fsdp", "tensor")),
    (r".*/out_proj$", ("tensor", "fsdp")),
    (r".*/conv_w$", (None, "tensor")),
    (r".*/(A_log|dt_bias|ssm_D|gate_norm)$", ("tensor",)),
    (r".*norm.*", (None,)),
    (r".*", (None,)),
)


def param_spec(path: str, rank: int, rules: MeshRules) -> PartitionSpec:
    for pat, logical in PARAM_RULES:
        if re.fullmatch(pat, path):
            axes = tuple(logical)
            if len(axes) < rank:          # left-pad stack dims
                axes = (None,) * (rank - len(axes)) + axes
            axes = axes[-rank:] if rank else ()
            return rules.spec(*axes)
    return P()


def enforce_divisible(sharding: NamedSharding, shape) -> NamedSharding:
    """Drop spec axes whose mesh extent does not divide the dim size."""
    sizes = mesh_sizes(sharding.mesh)
    new = []
    for i, entry in enumerate(sharding.spec):
        if entry is None or i >= len(shape):
            new.append(entry)
            continue
        total = math.prod(sizes[a] for a in _axes(entry))
        new.append(entry if shape[i] % total == 0 else None)
    return NamedSharding(sharding.mesh, P(*new))


def tree_paths(params: dict, prefix: str = "") -> list:
    """'/'-joined key paths of a nested dict's leaves, in ``tree.flatten``
    order."""
    if not isinstance(params, dict):
        return [prefix]
    return [path for key in sorted(params)
            for path in tree_paths(params[key],
                                   f"{prefix}/{key}" if prefix else key)]


def tree_param_specs(params: dict, rules: MeshRules) -> dict:
    """Dict of PartitionSpecs matching a parameter dict."""
    return tree.unflatten(params, [
        param_spec(path, leaf.ndim, rules) for path, leaf in
        zip(tree_paths(params), tree.flatten(params))])


def tree_param_shardings(params: dict, rules: MeshRules) -> dict:
    specs = tree.flatten(tree_param_specs(params, rules))
    return tree.unflatten(params, [
        enforce_divisible(NamedSharding(rules.mesh, spec), leaf.shape)
        for spec, leaf in zip(specs, tree.flatten(params))])


def blocks_sharding(rules: MeshRules, leaf) -> NamedSharding:
    """Sharding for a pooled optimizer-state stack (core/pool.py): the
    leading blocks dim over the model-major ``opt_blocks`` tiling when it
    divides, else over ``fsdp`` alone, else replicated.  An int8 pool's
    ``values`` (N, d, ell) and ``scale`` (N, 1, 1) share the leading N, so
    every rank holds the scales of exactly the blocks it owns."""
    ndim = leaf.ndim
    if not ndim:
        return NamedSharding(rules.mesh, P())
    for axis in ("opt_blocks", "fsdp"):
        spec = rules.spec(*([axis] + [None] * (ndim - 1)))
        sh = enforce_divisible(NamedSharding(rules.mesh, spec), leaf.shape)
        if sh.spec[0] is not None:
            return sh
    return NamedSharding(rules.mesh, P(*([None] * ndim)))
