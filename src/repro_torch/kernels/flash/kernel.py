"""Wrapper of the hand-written Hopper flash attention forward
(csrc/flash.cu), which replaces
repro/kernels/flash/kernel.py::flash_attention_pallas.

The wrapper takes CUDA tensors only (the registry sends CPU tensors to
``ref.py``), checks what the kernel accepts, allocates the output, launches
on the current stream and raises on a launch error.  ``launches`` counts
its launches, so a run can show that its attention went through the
kernel.  ``plan`` is the launch arithmetic in plain Python (which kernel a
dtype takes, its tiles, grid and shared memory), mirrored by csrc/flash.cu
and tested on the CPU.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID = 65535        # a grid's y and z dimensions
MAX_GRID_X = 2**31 - 1
SMEM_LIMIT = 232_448    # dynamic shared memory a Hopper block can use
KEYS = 64               # keys per K/V tile (both kernels)
ALIGN = 16              # bytes: the bf16 kernel's cp.async chunks
SMS = 132               # the H100's streaming multiprocessors
HEAD_DIMS = tuple(range(16, 129, 16)) + (256,)
launches = 0


class Plan(NamedTuple):
    kernel: str         # "simt_f32" or "wgmma_bf16"
    block_m: int        # query rows per block
    threads: int
    grid: tuple         # (x, y, z)
    smem_bytes: int


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, B: int, Hq: int, S: int, hd: int) -> Plan:
    """The launch of the kernel for ``dtype`` at these sizes, as
    csrc/flash.cu makes it.  f32: the SIMT kernel, 64 query rows and 256
    threads a block, grid (query tiles, Hq, B), shared Q and K tiles
    [64][hd + 1], V [64][hd] and P [64][65] in f32.  bf16: the wgmma
    kernel, one warpgroup (128 threads) per 64 query rows, 128 rows a block
    where that still gives two blocks per SM (B * Hq * ceil(S / 128) >=
    2 * 132) and 64 otherwise (short sequences, few heads: twice the blocks,
    each with a shorter chain of key tiles), but 128 at hd 256 when S > 64
    (its tiles allow one block a SM whatever the rows, so the block takes
    two warpgroups), grid (B * Hq, query tiles),
    shared Q and two stages of K and V tiles in bf16 plus 256 bytes of
    alignment.  Raises where a grid dimension would overflow."""
    if dtype == torch.float32:
        grid = (math.ceil(S / KEYS), Hq, B)
        p = Plan("simt_f32", 64, 256, grid,
                 4 * (2 * 64 * (hd + 1) + 64 * hd + 64 * 65))
    elif dtype == torch.bfloat16:
        block_m = 128 if B * Hq * math.ceil(S / 128) >= 2 * SMS or \
            (hd > 128 and S > 64) else 64
        grid = (B * Hq, math.ceil(S / block_m), 1)
        p = Plan("wgmma_bf16", block_m, 2 * block_m, grid,
                 2 * (block_m * hd + 4 * KEYS * hd) + 256)
    else:
        raise TypeError(f"no flash_attention kernel for {dtype}")
    if p.grid[0] > MAX_GRID_X or max(p.grid[1:]) > MAX_GRID:
        raise ValueError(f"flash_attention kernel's grid {p.grid} is over "
                         f"the card's limits (B {B}, Hq {Hq}, S {S})")
    return p


def check_aligned(name: str, t: torch.Tensor, strides: tuple) -> None:
    """The bf16 kernel copies 16-byte chunks of each row: the base address
    and the batch, head and sequence ``strides`` (elements) of ``t`` must be
    multiples of 16 bytes (the model's (B, S, H, hd) tensors always are)."""
    nbytes = t.element_size()
    if t.data_ptr() % ALIGN or any(s * nbytes % ALIGN for s in strides[:3]):
        raise ValueError(f"flash_attention bf16 kernel needs {name}'s base "
                         f"and strides 16-byte aligned, got address "
                         f"{t.data_ptr()} and strides {strides}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward for CUDA q (B, Hq, S, hd) and k, v (B, Hkv, Sk, hd)
    of one dtype (f32 or bf16), Hq % Hkv == 0, hd a multiple of 16 up to
    128 or 256 (``HEAD_DIMS``), each with a contiguous last dim and any
    other strides (the model's (B, S, H, hd) tensors arrive as transposed
    views and are read in place;
    in bf16 the base and strides 16-byte aligned, ``check_aligned``).
    Causal attention needs S == Sk (query i sees keys j <= i).  Returns
    (B, Hq, S, hd) in q's dtype, stored (B, S, Hq, hd)."""
    global launches
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    dev = q.device
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        st = t.stride()
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention kernel needs CUDA tensors on "
                             f"one device, got {name} on {t.device}")
        if len(st) != 4 or st[3] != 1:
            raise ValueError(f"flash_attention kernel needs a 4-D {name} "
                             f"with a contiguous last dim, got shape "
                             f"{tuple(t.shape)} strides {st}")
        strides.append(st)
    B, Hq, S, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape != (B, Hkv, Sk, hd) or v.shape != k.shape or Hkv == 0 \
            or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes a head dim that is "
                         f"a multiple of 16 up to 128, or 256, got {hd}")
    if causal and S != Sk:
        raise ValueError(f"causal flash_attention kernel needs S == Sk, got "
                         f"{S} and {Sk}")
    if B * Hq * S == 0:
        return q.new_empty((B, S, Hq, hd)).transpose(1, 2)
    p = plan(q.dtype, B, Hq, S, hd)
    if p.kernel == "wgmma_bf16":
        for name, t, st in zip("qkv", (q, k, v), strides):
            check_aligned(name, t, st)
    out = q.new_empty((B, S, Hq, hd))             # stored (B, S, Hq, hd)
    # batch, sequence and head strides of q, k, v and the (B, Hq, S, hd)
    # view of out
    args = [x for st in strides for x in (st[0], st[2], st[1])]
    args += [S * Hq * hd, Hq * hd, hd]
    err = build.launch(build.library("flash").repro_flash_attention,
                       dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), *args, B, Hq, Hkv, S, Sk, hd,
                       int(causal), DTYPES[q.dtype], p.block_m)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype}")
    launches += 1
    return out.transpose(1, 2)
