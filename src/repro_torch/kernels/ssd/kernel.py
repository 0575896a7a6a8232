"""Wrapper of the hand-written Hopper SSD chunk scan (csrc/ssd.cu), which
replaces repro/kernels/ssd/kernel.py::ssd_pallas.

The wrapper takes CUDA tensors only (the registry sends CPU tensors to
``ref.py``), checks what the kernel accepts, allocates the output and, with
more than one chunk, the f32 scratch of the kernel's phases (each chunk's
state but the last, and its decay), launches on the current stream and
raises on a launch error.  ``launches`` counts its calls (one per call,
whatever number of phases it launched), so a run can show that its scans
went through the kernel, and ``launches_by_dtype`` splits them by u's
dtype.  Unlike the Pallas kernel it needs no padding:
positions past S and heads past the last head tile are masked in the
kernel.  It takes f32, bf16 and fp16 and any P and N: P in HEAD_DIMS with
N <= MAX_STATE (``is_whole``, every config of the repo) on the kernels as
they were, any other on their WIDE forms (``slices`` and ``state_chunks``
are how csrc/ssd.cu cuts them); float64 (which the reference turns into
f32 unless x64 is on) and a grid past the card's limit raise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64)    # the P the kernels take whole
MAX_STATE = 128             # the state columns a launch takes
SLICE = 64                  # the WIDE forms' slice of P
MAX_GRID_X = 2**31 - 1  # a grid's x dimension, which takes every block
launches = 0
launches_by_dtype: dict = {}   # by u's dtype


def is_whole(P: int, N: int) -> bool:
    """Whether csrc/ssd.cu runs P and N on the kernels as they were (one
    launch a phase), not on their WIDE forms."""
    return P in HEAD_DIMS and N <= MAX_STATE


def slices(P: int, N: int) -> list:
    """(first column, width, valid columns) of each slice of P that
    csrc/ssd.cu runs: (0, P, P) for a whole shape, else 64 wide, the last
    one's columns past P zero."""
    if is_whole(P, N):
        return [(0, P, P)]
    return [(p0, SLICE, min(SLICE, P - p0)) for p0 in range(0, P, SLICE)]


def state_rows(P: int, N: int) -> int:
    """The rows of the kernel's state scratch: the slices' widths."""
    return sum(width for _, width, _ in slices(P, N))


def state_chunks(N: int) -> list:
    """(first column, width) of each chunk of N a launch takes: 128
    columns, the rest last.  One chunk (0, N) at N <= MAX_STATE."""
    return [(n0, min(MAX_STATE, N - n0)) for n0 in range(0, N, MAX_STATE)]


class Plan(NamedTuple):
    chunks: int         # chunks of Q positions
    Q: int
    out_blocks: int     # the chunk outputs' grid (phase 3)
    state_blocks: int   # the chunk states' grid (phase 1; 0 for one chunk)
    pass_blocks: int    # the state pass's grid (phase 2; 0 for <= 2 chunks)


def plan(B: int, S: int, H: int, P: int, N: int, chunk: int) -> Plan:
    """The launches of csrc/ssd.cu, each on a one-dimensional grid in the
    order of a (x, y, B) grid with the batch rows last, so that B is bound
    by the grid's x limit and not by 65,535.  Phase 3: per batch row, per
    tile of HT heads, per chunk, per QB query rows (QB = 16, 32, 64 and HT
    = 4, 2, 2 for Q up to 16, up to 32, above); phase 1: per batch row,
    head and chunk but the last; phase 2: 256-thread blocks, one thread per
    4 state values of every (b, h) (the scratch's ``state_rows`` rows).
    Phases 1 and 3 launch once for each slice of P and chunk of N
    (``slices``, ``state_chunks``) on these grids.  Raises where a grid
    would pass the x limit."""
    Q = min(chunk, S)
    chunks = -(-S // Q)
    QB, HT = (16, 4) if Q <= 16 else (32, 2) if Q <= 32 else (64, 2)
    out = chunks * math.ceil(Q / QB) * math.ceil(H / HT) * B
    state = (chunks - 1) * H * B
    passes = math.ceil(B * H * state_rows(P, N) * N // 4 / 256) \
        if chunks > 2 else 0
    p = Plan(chunks, Q, out, state, passes)
    if max(out, state, passes) > MAX_GRID_X:
        raise ValueError(f"ssd_scan kernel's grid {p} is over the card's "
                         f"{MAX_GRID_X} (B {B}, S {S}, H {H})")
    return p


def ssd_scan(u: torch.Tensor, dlog: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked SSD scan for contiguous CUDA u (B, S, H, P), dlog
    (B, S, H) f32 and Bm, Cm (B, S, N) in u's dtype (f32, bf16 or fp16),
    any P and N, in chunks of ``min(chunk, S)`` positions; returns y like
    u."""
    global launches
    if u.dtype not in DTYPES or Bm.dtype != u.dtype or Cm.dtype != u.dtype \
            or dlog.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32, bfloat16 or float16 "
                        f"u, Bm, Cm of one dtype and float32 dlog, got "
                        f"{u.dtype}, {Bm.dtype}, {Cm.dtype}, {dlog.dtype}")
    for name, t in (("u", u), ("dlog", dlog), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"ssd_scan kernel needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan kernel needs a contiguous {name}, "
                             f"got strides {t.stride()}")
    if u.ndim != 4:
        raise ValueError(f"ssd_scan kernel needs u (B, S, H, P), got shape "
                         f"{tuple(u.shape)}")
    B, S, H, P = u.shape
    N = Bm.shape[-1]
    if dlog.shape != (B, S, H) or Bm.shape != (B, S, N) \
            or Cm.shape != Bm.shape:
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, dlog "
                         f"{tuple(dlog.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}")
    if chunk < 1:
        raise ValueError(f"ssd_scan kernel takes a positive chunk, got "
                         f"{chunk}")
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    if N == 0:      # no state: C B^T is 0
        return y.zero_()
    Q = plan(B, S, H, P, N, chunk).Q
    # the state each chunk but the last adds (the state pass turns it into
    # the state entering the next chunk) and its decay exp(A_end), and
    # with more than one chunk of N the f32 sum of y over them
    slots = -(-S // Q) - 1
    states = torch.empty((B, slots, H, state_rows(P, N), N),
                         dtype=torch.float32, device=u.device)
    keep = torch.empty((B, slots, H), dtype=torch.float32, device=u.device)
    yacc = torch.empty(u.shape if N > MAX_STATE else (0,),
                       dtype=torch.float32, device=u.device)
    err = build.launch(build.library("ssd").repro_ssd_scan, u.device,
                       u.data_ptr(), dlog.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                       keep.data_ptr(), yacc.data_ptr(), B, S, H, P, N, Q,
                       DTYPES[u.dtype])
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"at u {tuple(u.shape)}, N={N}, chunk={chunk} "
                           f"{u.dtype}")
    launches += 1
    launches_by_dtype[u.dtype] = launches_by_dtype.get(u.dtype, 0) + 1
    return y
