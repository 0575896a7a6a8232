"""The kernel set of the optimizer and the model, dispatched on the tensor's
device.

Port of repro/kernels/registry.py (``KernelSet`` :52) with the entries the
Sketchy training step, the serving path and the model's attention and
Mamba2 scan use.  There is no backend
choice: a CUDA tensor launches the hand-written Hopper kernel (which raises
if it cannot build or launch), a CPU tensor takes the plain PyTorch
version, and any other device raises.  Nothing falls back from the kernel
to the plain version.

    gram(a):                              (d, k) -> (k, k) f32
    batched_gram(a):                      (N, d, k) -> (N, k, k) f32
    batched_lowrank_apply(u, c, b, g):    (N, d, ell), (N, ell), (N,),
                                          (N, d, n) -> (N, d, n), g's dtype
                                          (the card takes an f32 or int8 u)
    lowrank_apply(u, c, b, g):            (d, ell), (ell,), (), (d, n)
                                          -> (d, n), g's dtype

    flash_attention(q, k, v, causal):     (B, Hq, S, hd), (B, Hkv, Sk, hd)
                                          -> (B, Hq, S, hd), q's dtype
    ssd_scan(u, dlog, Bm, Cm, chunk):     (B, S, H, P), (B, S, H) f32,
                                          (B, S, N) -> (B, S, H, P), u's
                                          dtype

The single-block entries serve one tall matrix (the FD sketches of the
serving path: the gradient monitor and S-AdaGrad over the flattened head);
their kernels split the reduction over d.  The attention and SSD entries
are the model's forward; kernels/flash/ops.py and kernels/ssd/ops.py wrap
them with their gradients.

Fused entries of int8 second-moment storage (core/quantize.py):

    batched_gram_mixed(vq, colw, a):      (N, d, k) int8, (N, k) f32,
                                          (N, d, r) f32 -> (N, k+r, k+r) f32,
                                          the Gram of [vq * colw, a]
    batched_lowrank_apply_quantized(values, scale, c, b, g):
                                          the apply with an int8 U; the block
                                          scale^2 is folded into c
    batched_project_quantize(vq, w_top, a, w_bot):
                                          f32(vq) w_top + a w_bot, requantized
                                          per block -> (int8 values, scale)
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import kernel as lowrank_kernel
from repro_torch.kernels.lowrank import ref as lowrank_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ref as ssd_ref


class KernelSet(NamedTuple):
    gram: Callable
    lowrank_apply: Callable
    batched_gram: Callable
    batched_lowrank_apply: Callable
    batched_gram_mixed: Callable
    batched_lowrank_apply_quantized: Callable
    batched_project_quantize: Callable
    flash_attention: Callable
    ssd_scan: Callable


def grad_of_plain(plain: Callable, saved, needs, grad: torch.Tensor
                  ) -> tuple:
    """The gradients of ``plain(*saved)`` against ``grad``, recomputed under
    autograd from the saved inputs, for each input whose entry of ``needs``
    is set (None for the rest): the backward of the differentiable kernels
    (kernels/flash/ops.py, kernels/ssd/ops.py), whose forwards launch the
    kernel and whose reference has no backward kernel."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        grads = iter(torch.autograd.grad(plain(*inputs), wanted, grad))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


def _route(t: torch.Tensor, on_card: Callable, on_cpu: Callable) -> Callable:
    if t.device.type == "cuda":
        return on_card
    if t.device.type in ("cpu", "meta"):
        return on_cpu
    raise ValueError(f"no kernel for device {t.device}")


def _config(config, kernel: str, shape: tuple, dtype) -> autotune.TileConfig:
    """An explicit config as the kernel launches it, else the tune cache's
    for this launch."""
    if config is not None:
        return autotune.effective(kernel, shape, config, dtype)
    return autotune.get_config(kernel, shape, dtype)


def gram(a: torch.Tensor) -> torch.Tensor:
    return _route(a, gram_kernel.gram, gram_ref.gram_ref)(a)


def lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor, base,
                  g: torch.Tensor) -> torch.Tensor:
    fn = _route(g, lowrank_kernel.lowrank_apply, lowrank_ref.lowrank_apply_ref)
    return fn(u, coeffs, base, g)


def batched_gram(a: torch.Tensor, *, config=None) -> torch.Tensor:
    """(N, d, k) -> (N, k, k); ``config`` has no choice here (fixed
    tiles)."""
    return _route(a, gram_kernel.batched_gram, gram_ref.batched_gram_ref)(a)


def _col_tile(config, u: torch.Tensor, g: torch.Tensor) -> int:
    return _config(config, "batched_lowrank_apply",
                   tuple(u.shape) + (g.shape[2],), u.dtype).col_tile


def batched_lowrank_apply(u: torch.Tensor, coeffs: torch.Tensor,
                          base: torch.Tensor, g: torch.Tensor, *,
                          config=None) -> torch.Tensor:
    card = lowrank_kernel.batched_lowrank_apply
    fn = _route(g, card, lowrank_ref.batched_lowrank_apply_ref)
    if fn is card:
        return fn(u, coeffs, base, g, col_tile=_col_tile(config, u, g))
    return fn(u, coeffs, base, g)


def batched_gram_mixed(vq: torch.Tensor, colw: torch.Tensor,
                       a: torch.Tensor, *, config=None) -> torch.Tensor:
    """``config`` has no choice here (fixed tiles)."""
    fn = _route(a, gram_kernel.batched_gram_mixed,
                gram_ref.batched_gram_mixed_ref)
    return fn(vq, colw, a)


def _fold_quantized_apply(values: torch.Tensor, scale: torch.Tensor,
                          coeffs: torch.Tensor, base: torch.Tensor,
                          g: torch.Tensor, config=None) -> torch.Tensor:
    """The int8 apply on the card (port of ``_fold_quantized_apply``,
    repro/kernels/registry.py:133): the block scale commutes out of
    ``U diag(c) U^T`` as ``scale^2``, so the apply kernel runs on the raw
    int8 values with ``c * scale^2``; its upcast in registers is the
    dequantize."""
    s2 = torch.square(scale.reshape(scale.shape[0], 1).float())
    return lowrank_kernel.batched_lowrank_apply(
        values, coeffs * s2, base, g, col_tile=_col_tile(config, values, g))


def batched_lowrank_apply_quantized(values: torch.Tensor, scale: torch.Tensor,
                                    coeffs: torch.Tensor, base: torch.Tensor,
                                    g: torch.Tensor, *, config=None
                                    ) -> torch.Tensor:
    fn = _route(g, _fold_quantized_apply,
                lowrank_ref.batched_lowrank_apply_quantized_ref)
    if fn is _fold_quantized_apply:
        return fn(values, scale, coeffs, base, g, config)
    return fn(values, scale, coeffs, base, g)


def batched_project_quantize(vq: torch.Tensor, w_top: torch.Tensor,
                             a: torch.Tensor, w_bot: torch.Tensor, *,
                             config=None) -> tuple:
    card = lowrank_kernel.batched_project_quantize
    fn = _route(a, card, lowrank_ref.batched_project_quantize_ref)
    if fn is card:
        blocks = _config(config, "batched_project_quantize",
                         tuple(vq.shape) + (a.shape[2], w_top.shape[2]),
                         vq.dtype).blocks
        return fn(vq, w_top, a, w_bot, blocks=blocks)
    return fn(vq, w_top, a, w_bot)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    fn = _route(q, flash_kernel.flash_attention, flash_ref.attention_ref)
    return fn(q, k, v, causal=causal)


def ssd_scan(u: torch.Tensor, dlog: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    return _route(u, ssd_kernel.ssd_scan, ssd_ref.ssd_ref)(u, dlog, Bm, Cm,
                                                          chunk)


# each kernel wrapper's launch counter: name -> (wrapper module, attribute)
LAUNCH_COUNTERS = {
    "batched_gram": (gram_kernel, "launches"),
    "batched_lowrank_apply": (lowrank_kernel, "launches"),
    "batched_gram_mixed": (gram_kernel, "mixed_launches"),
    "batched_project_quantize": (lowrank_kernel,
                                 "project_quantize_launches"),
    "batched_lowrank_apply_int8": (lowrank_kernel, "int8_launches"),
    "gram": (gram_kernel, "single_launches"),
    "lowrank_apply": (lowrank_kernel, "single_launches"),
    "flash_attention": (flash_kernel, "launches"),
    "ssd_scan": (ssd_kernel, "launches"),
}


# the wrappers that also count their launches by operand dtype: name ->
# (wrapper module, attribute of its {torch.dtype: launches} dict)
DTYPE_COUNTERS = {
    "batched_gram": (gram_kernel, "launches_by_dtype"),
    "batched_lowrank_apply": (lowrank_kernel, "apply_launches_by_dtype"),
    "flash_attention": (flash_kernel, "launches_by_dtype"),
    "ssd_scan": (ssd_kernel, "launches_by_dtype"),
}


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far, by name."""
    return {name: getattr(module, attr)
            for name, (module, attr) in LAUNCH_COUNTERS.items()}


def launch_counts_by_dtype() -> dict:
    """The DTYPE_COUNTERS wrappers' launches so far, by name and dtype:
    {"flash_attention float16": launches, ...}."""
    return {f"{name} {str(dt).removeprefix('torch.')}": n
            for name, (module, attr) in DTYPE_COUNTERS.items()
            for dt, n in getattr(module, attr).items()}


def zero_launch_counts() -> None:
    for module, attr in LAUNCH_COUNTERS.values():
        setattr(module, attr, 0)
    for module, attr in DTYPE_COUNTERS.values():
        getattr(module, attr).clear()


KERNELS = KernelSet(
    gram=gram,
    lowrank_apply=lowrank_apply,
    batched_gram=batched_gram,
    batched_lowrank_apply=batched_lowrank_apply,
    batched_gram_mixed=batched_gram_mixed,
    batched_lowrank_apply_quantized=batched_lowrank_apply_quantized,
    batched_project_quantize=batched_project_quantize,
    flash_attention=flash_attention,
    ssd_scan=ssd_scan)
