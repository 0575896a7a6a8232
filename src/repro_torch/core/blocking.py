"""Shampoo-style parameter blocking (paper §3.4; port of
repro/core/blocking.py).

Scalars and vectors take the diagonal path.  A tensor (..., m, n) becomes a
stack of matrix blocks: leading dims flattened into the stack, the last two
tiled into zero-padded blocks of at most ``block_size``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BlockInfo:
    kind: str              # 'diag' | 'matrix'
    shape: tuple           # original shape
    stack: int = 1         # flattened leading dims
    m: int = 0             # original matrix rows
    n: int = 0             # original matrix cols
    bs_m: int = 0          # block rows
    bs_n: int = 0          # block cols
    mb: int = 0            # number of row tiles
    nb: int = 0            # number of col tiles

    @property
    def num_blocks(self) -> int:
        return self.stack * self.mb * self.nb

    @property
    def block_shape(self) -> tuple:
        """(bs_m, bs_n): the pool-grouping key (core/pool.py)."""
        return (self.bs_m, self.bs_n)


def _tile(dim: int, block_size: int) -> tuple[int, int]:
    """(num_tiles, tile_size) with tile_size <= block_size; padded layout."""
    if dim <= block_size:
        return 1, dim
    return math.ceil(dim / block_size), block_size


def analyze(shape: tuple, block_size: int = 1024) -> BlockInfo:
    if len(shape) < 2 or min(shape[-2:]) == 1:
        return BlockInfo(kind="diag", shape=tuple(shape))
    *lead, m, n = shape
    stack = int(math.prod(lead)) if lead else 1
    mb, bs_m = _tile(m, block_size)
    nb, bs_n = _tile(n, block_size)
    return BlockInfo(kind="matrix", shape=tuple(shape), stack=stack,
                     m=m, n=n, bs_m=bs_m, bs_n=bs_n, mb=mb, nb=nb)


def analyze_leaf(shape: tuple, block_size: int = 1024, *,
                 vectors_as_columns: bool = False) -> BlockInfo:
    """``analyze`` plus the OCO convention: with ``vectors_as_columns`` a 1-D
    leaf becomes a single (d, 1) matrix block (S-AdaGrad preconditions the
    whole d-vector with one sketch, paper Alg. 2) instead of taking the
    diagonal path."""
    if vectors_as_columns and len(shape) == 1 and shape[0] >= 1:
        mb, bs_m = _tile(shape[0], block_size)
        return BlockInfo(kind="matrix", shape=tuple(shape), stack=1,
                         m=shape[0], n=1, bs_m=bs_m, bs_n=1, mb=mb, nb=1)
    return analyze(tuple(shape), block_size)


def to_blocks(x: torch.Tensor, info: BlockInfo) -> torch.Tensor:
    """(..., m, n) -> (stack*mb*nb, bs_m, bs_n), zero-padded."""
    if info.kind != "matrix":
        raise ValueError(f"not a matrix leaf: {info}")
    x = x.reshape(info.stack, info.m, info.n)
    pm = info.mb * info.bs_m - info.m
    pn = info.nb * info.bs_n - info.n
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    x = x.reshape(info.stack, info.mb, info.bs_m, info.nb, info.bs_n)
    x = x.permute(0, 1, 3, 2, 4)
    return x.reshape(info.num_blocks, info.bs_m, info.bs_n)


def from_blocks(blocks: torch.Tensor, info: BlockInfo) -> torch.Tensor:
    """Inverse of to_blocks, dropping padding."""
    if info.kind != "matrix":
        raise ValueError(f"not a matrix leaf: {info}")
    x = blocks.reshape(info.stack, info.mb, info.nb, info.bs_m, info.bs_n)
    x = x.permute(0, 1, 3, 2, 4)
    x = x.reshape(info.stack, info.mb * info.bs_m, info.nb * info.bs_n)
    x = x[:, :info.m, :info.n]
    return x.reshape(info.shape)
