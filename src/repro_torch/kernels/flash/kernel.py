"""Wrapper of the hand-written Hopper flash attention forward
(csrc/flash.cu), which replaces
repro/kernels/flash/kernel.py::flash_attention_pallas.

The wrapper takes CUDA tensors only (the registry sends CPU tensors to
``ref.py``), checks what the kernel accepts, allocates the output, launches
on the current stream and raises on a launch error.  ``launches`` counts
its launches, so a run can show that its attention went through the
kernel, and ``launches_by_dtype`` splits them by q's dtype.  ``plan`` is the launch arithmetic in plain Python (which kernel a
dtype and head dim take, its tiles, grid and shared memory), mirrored by
csrc/flash.cu and tested on the CPU.  The kernels take f32, bf16 and fp16
and any head dim; float64 (which the reference turns into f32 unless x64
is on) and a grid past the card's limits raise.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
WGMMA_KERNELS = {torch.bfloat16: "wgmma_bf16", torch.float16: "wgmma_f16"}
MAX_GRID = 65535        # a grid's y and z dimensions
MAX_GRID_X = 2**31 - 1
SMEM_LIMIT = 232_448    # dynamic shared memory a Hopper block can use
KEYS = 64               # keys per K/V tile (every kernel)
ALIGN = 16              # bytes: the 16-bit kernel's cp.async chunks
SMS = 132               # the H100's streaming multiprocessors
HEAD_DIMS = tuple(range(16, 129, 16)) + (256,)   # the instantiated widths
MAX_HEAD_DIM = 256      # the widest instantiated width
# a wider head runs on the wide kernel: Q K^T summed over chunks of
# WIDE_DEPTH of hd, WIDE_COLS columns of O a block
WIDE_DEPTH = 64
WIDE_COLS = 128
launches = 0
launches_by_dtype: dict = {}   # by q's dtype


def padded_head_dim(hd: int) -> int:
    """The width a head dim runs on (csrc/flash.cu): hd up to 128 rounded
    up to a multiple of 16, up to 256 the instantiated 256; above that the
    wide kernel, whose depth chunks round hd up to a multiple of 64.  Q, K
    and V are zero from hd up to it in shared memory."""
    if hd < 1:
        raise ValueError(f"flash_attention kernel takes a head dim of at "
                         f"least 1, got {hd}")
    if hd > MAX_HEAD_DIM:
        return -(-hd // WIDE_DEPTH) * WIDE_DEPTH
    return -(-hd // 16) * 16 if hd <= 128 else MAX_HEAD_DIM


class Plan(NamedTuple):
    kernel: str         # "simt_f32", "wgmma_bf16", "wgmma_f16" or "wide"
    block_m: int        # query rows per block
    threads: int
    grid: tuple         # (x, y, z)
    smem_bytes: int
    width: int          # the instantiated head dim (padded_head_dim)


@functools.lru_cache(maxsize=1024)
def plan(dtype: torch.dtype, B: int, Hq: int, S: int, hd: int) -> Plan:
    """The launch of the kernel for ``dtype`` at these sizes, as
    csrc/flash.cu makes it.  hd > 256, any dtype: the wide kernel, 64 query
    rows and 256 threads a block, grid (query tiles x ceil(hd / 128), Hq,
    B), shared Q and K depth chunks and P [64][65] and V's column slice
    [64][128] in f32.  f32: the SIMT kernel, 64 query rows and 256
    threads a block, grid (query tiles, Hq, B), shared Q and K tiles
    [64][hd + 1], V [64][hd] and P [64][65] in f32.  bf16 and fp16: the
    wgmma kernel, one warpgroup (128 threads) per 64 query rows, 128 rows a
    block where that still gives two blocks per SM (B * Hq * ceil(S / 128)
    >= 2 * 132) and 64 otherwise (short sequences, few heads: twice the
    blocks, each with a shorter chain of key tiles), but 128 at hd 256 when
    S > 64 (its tiles allow one block a SM whatever the rows, so the block
    takes two warpgroups), grid (B * Hq, query tiles), shared Q and two
    stages of K and V tiles in 16 bits plus 256 bytes of alignment.  Tiles
    and shared memory are those of the instantiated width
    ``padded_head_dim(hd)``.  Raises where a grid dimension would
    overflow."""
    if dtype not in DTYPES:
        raise TypeError(f"no flash_attention kernel for {dtype}")
    width = padded_head_dim(hd)
    if hd > MAX_HEAD_DIM:
        grid = (math.ceil(S / KEYS) * math.ceil(hd / WIDE_COLS), Hq, B)
        p = Plan("wide", 64, 256, grid,
                 4 * (3 * 64 * (WIDE_DEPTH + 1) + 64 * WIDE_COLS), width)
    elif dtype == torch.float32:
        grid = (math.ceil(S / KEYS), Hq, B)
        p = Plan("simt_f32", 64, 256, grid,
                 4 * (2 * 64 * (width + 1) + 64 * width + 64 * 65), width)
    else:
        block_m = 128 if B * Hq * math.ceil(S / 128) >= 2 * SMS or \
            (width > 128 and S > 64) else 64
        grid = (B * Hq, math.ceil(S / block_m), 1)
        p = Plan(WGMMA_KERNELS[dtype], block_m, 2 * block_m, grid,
                 2 * (block_m * width + 4 * KEYS * width) + 256, width)
    if p.grid[0] > MAX_GRID_X or max(p.grid[1:]) > MAX_GRID:
        raise ValueError(f"flash_attention kernel's grid {p.grid} is over "
                         f"the card's limits (B {B}, Hq {Hq}, S {S})")
    return p


def check_aligned(t: torch.Tensor, strides: tuple) -> bool:
    """Whether the 16-bit (bf16, fp16) kernel copies ``t`` in 16-byte
    chunks (cp.async): its head dim a multiple of 8 and its base address
    and batch, head and sequence ``strides`` (elements) multiples of 16
    bytes, as the model's (B, S, H, hd) tensors are at every ported config.
    Otherwise the kernel stages it one element a thread."""
    nbytes = t.element_size()
    return t.shape[-1] * nbytes % ALIGN == 0 and t.data_ptr() % ALIGN == 0 \
        and all(s * nbytes % ALIGN == 0 for s in strides[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward for CUDA q (B, Hq, S, hd) and k, v (B, Hkv, Sk, hd)
    of one dtype (f32, bf16 or fp16), Hq % Hkv == 0, any hd (run on
    ``padded_head_dim(hd)``), each with a contiguous last dim and any other
    strides (the model's (B, S, H, hd) tensors arrive as transposed views
    and are read in place; up to hd 256 in bf16 and fp16 in 16-byte chunks
    where ``check_aligned``, else element by element).  The causal mask is
    aligned at the end, as ``attention_ref``'s: query i sees keys j <= i +
    Sk - S, and a row that sees none is the uniform mean of V.  Returns
    (B, Hq, S, hd) in q's dtype, stored (B, S, Hq, hd)."""
    global launches
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32, bfloat16 "
                        f"or float16 q, k, v of one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
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
    padded_head_dim(hd)
    if B * Hq * S == 0:
        return q.new_empty((B, S, Hq, hd)).transpose(1, 2)
    p = plan(q.dtype, B, Hq, S, hd)
    chunked = sum(1 << i for i, (t, st) in enumerate(zip((q, k, v), strides))
                  if p.kernel in WGMMA_KERNELS.values()
                  and check_aligned(t, st))
    out = q.new_empty((B, S, Hq, hd))             # stored (B, S, Hq, hd)
    # batch, sequence and head strides of q, k, v and the (B, Hq, S, hd)
    # view of out
    args = [x for st in strides for x in (st[0], st[2], st[1])]
    args += [S * Hq * hd, Hq * hd, hd]
    err = build.launch(build.library("flash").repro_flash_attention,
                       dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), *args, B, Hq, Hkv, S, Sk, hd,
                       int(causal), DTYPES[q.dtype], p.block_m, chunked)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype}")
    launches += 1
    launches_by_dtype[q.dtype] = launches_by_dtype.get(q.dtype, 0) + 1
    return out.transpose(1, 2)
