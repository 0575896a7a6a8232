"""Device meshes over the ranks of a ``torch.distributed`` world (port of
repro/launch/mesh.py).

Functions, never module-level constants: importing this module creates no
process group.  Each builds a ``DeviceMesh`` over the default group's
ranks, rank r where ``jax.make_mesh`` puts device r (row-major: the last
axis varies fastest).  Every rank of the world calls it, in the same order
(each mesh dimension's process groups come from ``new_group``, which all
ranks enter), and a world whose size is not the mesh's raises.  The mesh
lives on the card unless ``device_type="cpu"`` is asked for.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the whole world."""
    shape, axes = tuple(shape), tuple(axes)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return DeviceMesh(device_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(*, device_type: str = "cuda") -> DeviceMesh:
    """Every rank of the world, as a 1-D 'data' mesh."""
    return make_mesh((dist.get_world_size(),), ("data",),
                     device_type=device_type)
