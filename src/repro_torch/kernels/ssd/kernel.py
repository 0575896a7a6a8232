"""Wrapper of the hand-written Hopper SSD chunk scan (csrc/ssd.cu), which
replaces repro/kernels/ssd/kernel.py::ssd_pallas.

The wrapper takes CUDA tensors only (the registry sends CPU tensors to
``ref.py``), checks what the kernel accepts, allocates the output and, with
more than one chunk, the f32 scratch of the kernel's phases (each chunk's
state but the last, and its decay), launches on the current stream and
raises on a launch error.  ``launches`` counts its calls (one per call,
whatever number of phases it launched), so a run can show that its scans
went through the kernel.  Unlike the Pallas kernel it needs no padding:
positions past S and heads past the last head tile are masked in the
kernel.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64)
MAX_STATE = 128
MAX_GRID_X = 2**31 - 1  # a grid's x dimension, which takes every block
launches = 0


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
    4 state values of every (b, h).  Raises where a grid would pass the
    x limit."""
    Q = min(chunk, S)
    chunks = -(-S // Q)
    QB, HT = (16, 4) if Q <= 16 else (32, 2) if Q <= 32 else (64, 2)
    out = chunks * math.ceil(Q / QB) * math.ceil(H / HT) * B
    state = (chunks - 1) * H * B
    passes = math.ceil(B * H * P * N // 4 / 256) if chunks > 2 else 0
    p = Plan(chunks, Q, out, state, passes)
    if max(out, state, passes) > MAX_GRID_X:
        raise ValueError(f"ssd_scan kernel's grid {p} is over the card's "
                         f"{MAX_GRID_X} (B {B}, S {S}, H {H})")
    return p


def ssd_scan(u: torch.Tensor, dlog: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked SSD scan for contiguous CUDA u (B, S, H, P), dlog
    (B, S, H) f32 and Bm, Cm (B, S, N) in u's dtype (f32 or bf16), P one of
    16, 32 and 64, N at most 128, in chunks of ``min(chunk, S)`` positions;
    returns y like u."""
    global launches
    if u.dtype not in DTYPES or Bm.dtype != u.dtype or Cm.dtype != u.dtype \
            or dlog.dtype != torch.float32:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16 u, Bm, "
                        f"Cm of one dtype and float32 dlog, got {u.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}, {dlog.dtype}")
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
    if P not in HEAD_DIMS or not 1 <= N <= MAX_STATE or chunk < 1:
        raise ValueError(f"ssd_scan kernel takes P in {HEAD_DIMS}, N up to "
                         f"{MAX_STATE} and a positive chunk, got P={P}, "
                         f"N={N}, B={B}, chunk={chunk}")
    y = torch.empty_like(u)
    if y.numel() == 0:
        return y
    Q = plan(B, S, H, P, N, chunk).Q
    # the state each chunk but the last adds (the state pass turns it into
    # the state entering the next chunk) and its decay exp(A_end)
    slots = -(-S // Q) - 1
    states = torch.empty((B, slots, H, P, N), dtype=torch.float32,
                         device=u.device)
    keep = torch.empty((B, slots, H), dtype=torch.float32, device=u.device)
    err = build.launch(build.library("ssd").repro_ssd_scan, u.device,
                       u.data_ptr(), dlog.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                       keep.data_ptr(), B, S, H, P, N, Q, DTYPES[u.dtype])
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"at u {tuple(u.shape)}, N={N}, chunk={chunk} "
                           f"{u.dtype}")
    launches += 1
    return y
