"""Wrapper of the hand-written Hopper flash attention forward
(csrc/flash.cu), which replaces
repro/kernels/flash/kernel.py::flash_attention_pallas.

The wrapper takes CUDA tensors only (the registry sends CPU tensors to
``ref.py``), checks what the kernel accepts, allocates the output, launches
on the current stream and raises on a launch error.  ``launches`` counts
its launches, so a run can show that its attention went through the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID = 65535        # the grid's y (heads) and z (batch) dimensions
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward for CUDA q (B, Hq, S, hd) and k, v (B, Hkv, Sk, hd)
    of one dtype (f32 or bf16), Hq % Hkv == 0, hd a multiple of 16 up to
    128, each with a contiguous last dim and any other strides (the model's
    (B, S, H, hd) tensors arrive as transposed views and are read in place).
    Causal attention needs S == Sk (query i sees keys j <= i).  Returns
    (B, Hq, S, hd) in q's dtype, stored (B, S, Hq, hd)."""
    global launches
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention kernel needs CUDA tensors on "
                             f"one device, got {name} on {t.device}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel needs a 4-D {name} "
                             f"with a contiguous last dim, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    B, Hq, S, hd = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape != (B, Hkv, Sk, hd) or v.shape != k.shape or Hkv == 0 \
            or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if hd % 16 or not 16 <= hd <= 128:
        raise ValueError(f"flash_attention kernel takes a head dim that is "
                         f"a multiple of 16 up to 128, got {hd}")
    if causal and S != Sk:
        raise ValueError(f"causal flash_attention kernel needs S == Sk, got "
                         f"{S} and {Sk}")
    if B > MAX_GRID or Hq > MAX_GRID:
        raise ValueError(f"flash_attention kernel takes at most {MAX_GRID} "
                         f"batch rows and heads, got {B} and {Hq}")
    out = torch.empty((B, S, Hq, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = [x for t in (q, k, v, out)
               for x in (t.stride(0), t.stride(2), t.stride(1))]
    err = build.launch(build.library("flash").repro_flash_attention,
                       q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), *strides, B, Hq, Hkv, S, Sk, hd,
                       int(causal), DTYPES[q.dtype])
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)} {q.dtype}")
    launches += 1
    return out
