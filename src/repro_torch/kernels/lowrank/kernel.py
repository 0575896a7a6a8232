"""Wrappers of the hand-written Hopper low-rank applies (csrc/lowrank.cu,
csrc/lowrank_tall.cu) and of the int8 FD write-back
(csrc/project_quantize.cu).

``batched_lowrank_apply`` replaces
repro/kernels/lowrank/kernel.py::batched_lowrank_apply_pallas,
``lowrank_apply`` (the apply of one tall factor, split over d) replaces
::lowrank_apply_pallas and ``batched_project_quantize`` replaces
::batched_project_quantize_pallas.
The wrappers take CUDA tensors only (the registry sends CPU tensors to
``ref.py``), check what the kernels accept, allocate the outputs (and the
f32 scratch of the single-block apply and the write-back; the batched apply
is one pass and needs none), launch on the current stream and raise on a
launch error.  Each counts the calls that launched (one per call):
``launches`` the apply with an f32 U, ``int8_launches`` the apply with an
int8 U (the fused int8 path), ``single_launches`` the single-block apply,
and ``project_quantize_launches`` the write-back;
``apply_launches_by_dtype`` counts both batched applies by U's dtype.

G must be contiguous.  The right-side apply of Sketchy sees a transposed
view; its caller makes the copy (core/fd.py fd_apply_inverse_root_batched).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build, split_d

U_DTYPES = {torch.float32: 0, torch.int8: 2}
G_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_GRID_X = 2**31 - 1  # a grid's x dimension
MAX_GRID_YZ = 65535     # a grid's y and z dimensions
MAX_ELL = 7264          # the single-block expand pass holds P's tile in
                        # shared memory, ell * 8 f32 (the card's 227 KB);
                        # a wider U takes that pass in chunks of it
BATCHED_MAX_ELL = 1984  # the batched apply's P (ell x 8 at its narrowest
                        # column tile, split in two) fits shared memory
                        # beside its stages (csrc/lowrank.cu smem_bytes);
APPLY_CHUNK = 256       # a wider U runs in chunks of 256 of its columns,
                        # whose P fits beside the widest column tile
# the write-back's pass 1 (csrc/project_quantize.cu project_kernel)
PROJECT_ROWS, PROJECT_COLS, PROJECT_DEPTH = 128, 64, 32
PROJECT_THREADS = 128
SMS = 132               # the H100's streaming multiprocessors
PROJECT_BLOCKS_PER_SM = 3   # pass 1's residency: 168 registers x 128
                            # threads (its launch bound), 53,248 B of
                            # shared memory a block
SMEM_LIMIT = 232_448    # dynamic shared memory a Hopper block can use
APPLY_COL_TILES = (64, 32, 16, 8)   # the batched apply's column tiles
launches = 0
int8_launches = 0
apply_launches_by_dtype: dict = {}    # both batched applies', by U's dtype
single_launches = 0
project_quantize_launches = 0


def _check(name: str, tensors: dict, device) -> None:
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} kernel needs CUDA tensors on one "
                             f"device; {arg} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors; {arg} "
                             f"has strides {t.stride()}")


def apply_smem_bytes(ell: int, col_tile: int, usize: int) -> int:
    """The batched apply's dynamic shared memory at a column tile of
    ``col_tile`` columns of G (csrc/lowrank.cu ``smem_bytes``): two stages
    of U and G rows, then P's tf32 hi and lo parts."""
    ustride = 64 + 8 if usize == 4 else 64 + 16
    gstride = 8 if col_tile == 8 else col_tile + 8
    stage = max(rows * ustride * usize + rows * gstride * 4
                for rows in (32, 64))
    cols = math.ceil(ell / 64) * 64
    return 2 * stage + 2 * 4 * cols * (col_tile + 4)


def apply_chunks(ell: int) -> list:
    """(first column, columns) of each launch of the batched apply over a
    U of ell columns (csrc/lowrank.cu ``chunk_cols``): one chunk (0, ell)
    at ell <= BATCHED_MAX_ELL, else chunks of APPLY_CHUNK, the rest
    last.  Each block reads all of its chunk of U, so the chunks keep the
    widest column tile (64): a tile of 8 reads U n / 8 times."""
    cols = ell if ell <= BATCHED_MAX_ELL else APPLY_CHUNK
    return [(e0, min(cols, ell - e0)) for e0 in range(0, ell, cols)]


def tall_chunks(ell: int) -> list:
    """(first column, columns) of each launch of the single-block apply's
    expand pass (csrc/lowrank_tall.cu): chunks of MAX_ELL, the rest last."""
    return [(e0, min(MAX_ELL, ell - e0)) for e0 in range(0, ell, MAX_ELL)]


@functools.lru_cache(maxsize=1024)
def apply_col_tiles(ell: int, usize: int) -> tuple:
    """The column tiles the batched apply can launch at ``ell`` (those whose
    shared memory fits each of its chunks), widest first; the first is its
    default."""
    widest = max(cols for _, cols in apply_chunks(ell)) if ell > 0 else ell
    return tuple(t for t in APPLY_COL_TILES
                 if apply_smem_bytes(widest, t, usize) <= SMEM_LIMIT)


def apply_grid(N: int, ell: int, m: int, usize: int,
               col_tile: int = 0) -> tuple:
    """The batched apply's grid (csrc/lowrank.cu): G's column tiles at
    ``col_tile`` (0: the widest that fits, ``apply_col_tiles``) on x, the N
    blocks on y in slices of at most 65,535 and the slices on z (block n =
    z 65,535 + y, the last slice's tail idle), so N is bound by 65,535^2
    and not by 65,535.  Raises where it would pass the grid's limits."""
    tile = col_tile or (apply_col_tiles(ell, usize) or (8,))[0]
    slice_ = max(min(N, MAX_GRID_YZ), 1)
    grid = (math.ceil(m / tile), slice_, math.ceil(N / slice_))
    if grid[0] > MAX_GRID_X or grid[2] > MAX_GRID_YZ:
        raise ValueError(f"batched_lowrank_apply kernel's grid {grid} is "
                         f"over the card's limits (N {N}, {m} columns at "
                         f"tile {tile})")
    return grid


def batched_lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor,
                          base: torch.Tensor, g: torch.Tensor,
                          col_tile: int = 0) -> torch.Tensor:
    """Y[n] = base[n] G[n] + U[n] diag(coeffs[n]) U[n]^T G[n] on the card.

    u (N, d, ell) is f32, or int8 for the fused int8 path (the registry's
    ``batched_lowrank_apply_quantized`` folds the block scale^2 into
    coeffs); coeffs (N, ell), base (N,) and g (N, d, n) are f32.  All are
    contiguous CUDA tensors on one device.  Any ell: above BATCHED_MAX_ELL
    the kernel runs on chunks of APPLY_CHUNK of U's columns, one launch
    each in order (``apply_chunks``), the later ones adding to Y.
    ``col_tile`` is the columns of G a block takes (``apply_col_tiles``;
    kernels/autotune.py tunes it), 0 the widest that fits each chunk.  N =
    0 returns an empty result unlaunched."""
    global launches, int8_launches
    _check("batched_lowrank_apply",
           {"u": u, "coeffs": coeffs, "base": base, "g": g}, g.device)
    if u.dtype not in U_DTYPES:
        raise TypeError(f"batched_lowrank_apply kernel takes a float32 or "
                        f"int8 u; u is {u.dtype}")
    for name, t in (("coeffs", coeffs), ("base", base), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"batched_lowrank_apply kernel takes float32 "
                            f"{name}; it is {t.dtype}")
    if u.ndim != 3 or g.ndim != 3:
        raise ValueError(f"u and g must be 3-D, got {tuple(u.shape)}, "
                         f"{tuple(g.shape)}")
    N, d, ell = u.shape
    m = g.shape[2]
    if g.shape[:2] != (N, d) or coeffs.shape != (N, ell) \
            or base.shape != (N,):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, base {tuple(base.shape)}, "
                         f"g {tuple(g.shape)}")
    if ell <= 0:
        raise ValueError(f"batched_lowrank_apply kernel takes ell > 0, got "
                         f"N={N}, ell={ell}")
    apply_grid(N, ell, m, u.element_size(), col_tile)
    if col_tile and col_tile not in apply_col_tiles(ell, u.element_size()):
        raise ValueError(f"batched_lowrank_apply kernel: column tile "
                         f"{col_tile} does not launch at ell {ell}, "
                         f"{u.dtype} u; it takes "
                         f"{apply_col_tiles(ell, u.element_size())}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    err = build.launch(build.library("lowrank").repro_batched_lowrank_apply,
                       g.device, u.data_ptr(), U_DTYPES[u.dtype],
                       coeffs.data_ptr(), base.data_ptr(), g.data_ptr(),
                       out.data_ptr(), N, d, ell, m, col_tile)
    if err != 0:
        raise RuntimeError(f"batched_lowrank_apply kernel launch failed: CUDA "
                           f"error {err} at u {tuple(u.shape)} {u.dtype}, g "
                           f"{tuple(g.shape)}, column tile {col_tile}")
    if u.dtype == torch.int8:
        int8_launches += 1
    else:
        launches += 1
    apply_launches_by_dtype[u.dtype] = \
        apply_launches_by_dtype.get(u.dtype, 0) + 1
    return out


def lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor, base,
                  g: torch.Tensor) -> torch.Tensor:
    """Y = base G + U diag(coeffs) U^T G for one tall factor on the card:
    u (d, ell) and coeffs (ell,) f32, base an f32 scalar (a tensor on the
    card or a number), g (d, n) f32, bf16 or fp16 -> (d, n) in g's dtype.
    The projection is summed over slabs of d in a fixed order (the same
    bits on every run).  Any ell: above MAX_ELL the expand pass runs on
    chunks of U's columns (``tall_chunks``), summed in order in an f32
    scratch (d, n).  An empty result returns unlaunched."""
    global single_launches
    base = torch.as_tensor(base, dtype=torch.float32,
                           device=g.device).reshape(())
    _check("lowrank_apply", {"u": u, "coeffs": coeffs, "base": base, "g": g},
           g.device)
    if u.dtype != torch.float32 or coeffs.dtype != torch.float32:
        raise TypeError(f"lowrank_apply kernel takes float32 u and coeffs; "
                        f"got {u.dtype}, {coeffs.dtype}")
    if g.dtype not in G_DTYPES:
        raise TypeError(f"lowrank_apply kernel takes a float32, bfloat16 or "
                        f"float16 g; g is {g.dtype}")
    if u.ndim != 2 or g.ndim != 2:
        raise ValueError(f"u and g must be 2-D, got {tuple(u.shape)}, "
                         f"{tuple(g.shape)}")
    d, ell = u.shape
    n = g.shape[1]
    if g.shape[0] != d or coeffs.shape != (ell,):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, g {tuple(g.shape)}")
    if ell <= 0:
        raise ValueError(f"lowrank_apply kernel takes ell > 0, got {ell}")
    out = torch.empty_like(g)
    if out.numel() == 0:
        return out
    # blocks per slab: the cross product's (n / 8) x (ell / 256) tiles
    slabs, slab_rows = split_d.slabs(
        d, math.ceil(n / 8) * math.ceil(ell / 256), ell * n)
    partial = torch.empty((slabs, ell, n), dtype=torch.float32,
                          device=g.device)
    p = torch.empty((ell, n), dtype=torch.float32, device=g.device)
    yacc = torch.empty((d, n) if ell > MAX_ELL else (0,),
                       dtype=torch.float32, device=g.device)
    err = build.launch(build.library("lowrank_tall").repro_lowrank_tall,
                       g.device, u.data_ptr(), coeffs.data_ptr(),
                       base.data_ptr(), g.data_ptr(), G_DTYPES[g.dtype],
                       partial.data_ptr(), p.data_ptr(), out.data_ptr(),
                       yacc.data_ptr(), d, ell, n, slabs, slab_rows)
    if err != 0:
        raise RuntimeError(f"lowrank_apply kernel launch failed: CUDA error "
                           f"{err} at u {tuple(u.shape)}, g {tuple(g.shape)} "
                           f"{g.dtype}")
    single_launches += 1
    return out


class ProjectPlan(NamedTuple):
    tiles: tuple        # (row blocks of d, column blocks of e, N)
    panels: int         # per tile: ceil(k / 32) + ceil(r / 32)
    blocks: int         # pass 1's grid, sharing the tiles' panels
    threads: int
    smem_bytes: int     # pass 1's double-buffered panels
    scratch: int        # f32 elements: partial slots, U_new, absmax words


@functools.lru_cache(maxsize=1024)
def project_plan(N: int, d: int, k: int, r: int, e: int,
                 blocks: int = 0) -> ProjectPlan:
    """The write-back as csrc/project_quantize.cu launches it.  Pass 1 has
    128-thread blocks, each computing 128 x 64 tiles of U_new over 32-deep
    panels of V's k columns and then A's r columns, double buffered in
    shared memory ([2][128][36] and [2][32][64] f32).  The tiles' panels,
    in a row, are cut evenly among as many blocks as are resident on the
    card at once (``project_runs``), each with two partial slots of one
    tile for the tiles it shares with its neighbours.  ``blocks`` other
    than 0 sets the blocks instead (kernels/autotune.py tunes it), at most
    one a unit (a panel of a tile)."""
    tiles = (math.ceil(d / PROJECT_ROWS), math.ceil(e / PROJECT_COLS), N)
    panels = math.ceil(k / PROJECT_DEPTH) + math.ceil(r / PROJECT_DEPTH)
    units = math.prod(tiles) * panels
    top = min(units, MAX_GRID_X)
    if blocks and not 0 < blocks <= top:
        raise ValueError(f"the write-back takes 1 to {top} blocks at "
                         f"(N, d, k, r, e) = {(N, d, k, r, e)}, got {blocks}")
    if math.prod(tiles) > MAX_GRID_X:
        raise ValueError(f"the write-back's fixup grid of {math.prod(tiles)} "
                         f"tiles is over the card's {MAX_GRID_X}")
    blocks = blocks or min(units, SMS * PROJECT_BLOCKS_PER_SM)
    return ProjectPlan(
        tiles, panels, blocks, PROJECT_THREADS,
        4 * 2 * (PROJECT_ROWS * (PROJECT_DEPTH + 4)
                 + PROJECT_DEPTH * PROJECT_COLS),
        2 * blocks * PROJECT_ROWS * PROJECT_COLS + N * d * e + N)


def project_runs(units: int, blocks: int, panels: int) -> list:
    """Pass 1's partition, as project_kernel walks it: per block c, its
    runs (tile, first panel, end panel, slot) over units [c U / B,
    (c + 1) U / B) (unit = tile * panels + panel); slot None for a whole
    tile, else the partial slot: 0 for a run that starts inside its tile, 1
    for one that starts the tile and ends inside it."""
    out = []
    for c in range(blocks):
        u, hi, runs = c * units // blocks, (c + 1) * units // blocks, []
        while u < hi:
            tile, pa = divmod(u, panels)
            pb = min(panels, pa + hi - u)
            whole = pa == 0 and pb == panels
            runs.append((tile, pa, pb, None if whole else int(pa == 0)))
            u += pb - pa
        out.append(runs)
    return out


def project_parts(units: int, blocks: int, panels: int, tile: int) -> list:
    """The (block, slot) parts fixup_kernel adds, in order, for ``tile``
    (empty for a tile one block computed whole): the block holding the
    tile's first panel, slot 1, then slot 0 of each block up to the one
    holding its last panel."""
    def block_of(u):
        return max(c for c in range(blocks) if c * units // blocks <= u)
    c0 = block_of(tile * panels)
    c1 = block_of(tile * panels + panels - 1)
    if c0 == c1:
        return []
    return [(c0, 1)] + [(c, 0) for c in range(c0 + 1, c1 + 1)]


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def project_vector_flags(vq: torch.Tensor, w_top: torch.Tensor,
                         a: torch.Tensor, w_bot: torch.Tensor,
                         un: torch.Tensor) -> int:
    """Which operands pass 1 moves in 16-byte accesses (bit 0 V, 1 A, 2
    W_top and W_bot, 3 the f32 scratch it writes): those whose base is
    16-byte aligned and whose rows are a whole number of 16 bytes (k % 16
    int8 values, r % 4 or e % 4 floats), so every row starts aligned.  The
    rest take masked scalar accesses."""
    k, r, e = vq.shape[2], a.shape[2], w_top.shape[2]
    return (int(k % 16 == 0 and _aligned(vq))
            | int(r % 4 == 0 and _aligned(a)) << 1
            | int(e % 4 == 0 and _aligned(w_top, w_bot)) << 2
            | int(e % 4 == 0 and _aligned(un)) << 3)


def batched_project_quantize(vq: torch.Tensor, w_top: torch.Tensor,
                             a: torch.Tensor, w_bot: torch.Tensor,
                             blocks: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``U_new = f32(vq) @ w_top + a @ w_bot`` requantized per block, on the
    card: vq (N, d, k) int8, w_top (N, k, e), a (N, d, r), w_bot (N, r, e)
    f32, contiguous, on one device -> (values (N, d, e) int8, scale
    (N, 1, 1) f32), rounding to nearest as ``quantize.quantize_stack``.
    ``blocks`` is pass 1's block count (``project_plan``), 0 its default.
    N = 0 returns empty results unlaunched."""
    global project_quantize_launches
    _check("batched_project_quantize",
           {"vq": vq, "w_top": w_top, "a": a, "w_bot": w_bot}, a.device)
    if vq.dtype != torch.int8 or any(
            t.dtype != torch.float32 for t in (w_top, a, w_bot)):
        raise TypeError(f"batched_project_quantize kernel takes int8 vq and "
                        f"float32 w_top, a, w_bot; got {vq.dtype}, "
                        f"{w_top.dtype}, {a.dtype}, {w_bot.dtype}")
    if vq.ndim != 3 or a.ndim != 3 or w_top.ndim != 3:
        raise ValueError(f"vq, a and w_top must be 3-D, got "
                         f"{tuple(vq.shape)}, {tuple(a.shape)}, "
                         f"{tuple(w_top.shape)}")
    N, d, k = vq.shape
    r, e = a.shape[2], w_top.shape[2]
    if w_top.shape != (N, k, e) or a.shape[:2] != (N, d) \
            or w_bot.shape != (N, r, e):
        raise ValueError(f"shape mismatch: vq {tuple(vq.shape)}, w_top "
                         f"{tuple(w_top.shape)}, a {tuple(a.shape)}, w_bot "
                         f"{tuple(w_bot.shape)}")
    values = torch.empty((N, d, e), dtype=torch.int8, device=a.device)
    if values.numel() == 0:
        return values, torch.ones((N, 1, 1), dtype=torch.float32,
                                  device=a.device)
    scale = torch.empty((N, 1, 1), dtype=torch.float32, device=a.device)
    p = project_plan(N, d, k, r, e, blocks)
    scratch = torch.empty((p.scratch,), dtype=torch.float32, device=a.device)
    err = build.launch(
        build.library("project_quantize").repro_batched_project_quantize,
        a.device, vq.data_ptr(), w_top.data_ptr(), a.data_ptr(),
        w_bot.data_ptr(), scratch.data_ptr(), values.data_ptr(),
        scale.data_ptr(), N, d, k, r, e, p.blocks,
        project_vector_flags(vq, w_top, a, w_bot, scratch))
    if err != 0:
        raise RuntimeError(f"batched_project_quantize kernel launch failed: "
                           f"CUDA error {err} at vq {tuple(vq.shape)}, a "
                           f"{tuple(a.shape)}, e {e}")
    project_quantize_launches += 1
    return values, scale
