"""Slab geometry of the split-d kernels (csrc/split_d.cuh): the single-block
Gram and low-rank apply cut the d rows of one tall matrix into slabs of
consecutive rows, reduce each slab in one block into an f32 partial, and
sum the partials in a fixed order.

The geometry depends on the shapes alone, never on the card, so a result
has the same bits on every run and every card.
"""
from __future__ import annotations

import math

MAX_BLOCKS = 1024          # blocks of one pass: ~8 per SM of an H100's 132
MIN_SLAB_ROWS = 1024       # fewer rows than this per block is all overhead
MAX_PARTIAL_FLOATS = 1 << 26   # 256 MB of f32 partials at most


def slabs(d: int, blocks_per_slab: int = 1,
          partial_floats: int = 1) -> tuple[int, int]:
    """(number of slabs S, rows per slab) for d rows, when each slab takes
    ``blocks_per_slab`` blocks and ``partial_floats`` f32 of scratch."""
    s = min(math.ceil(d / MIN_SLAB_ROWS), MAX_BLOCKS // blocks_per_slab,
            MAX_PARTIAL_FLOATS // partial_floats)
    rows = math.ceil(d / max(s, 1))
    return math.ceil(d / rows), rows
