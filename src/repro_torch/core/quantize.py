"""Quantized storage of the second-moment state between steps (port of
repro/core/quantize.py).

Compute stays f32: the engine turns the stored pools into f32 at the
refresh/precondition boundary and stores the result back.  Three storage
modes (``EngineConfig.second_moment_dtype``):

  * ``"fp32"``: identity.
  * ``"bf16"``: every second-moment leaf (the FD eigenvectors, eigenvalues
    and rho; Shampoo's L and R) and every diagonal-fallback accumulator
    cast to bfloat16.
  * ``"int8"``: the second-moment stacks of ndim >= 3 (the (N, d, ell)
    eigenvector stacks, Shampoo's (N, d, d) L and R) stored as int8 values
    plus one f32 absmax scale per block, ``(N, 1, 1)``; the diagonal
    accumulators as int8 with one whole-leaf scale, ``(1,) * ndim``.  The
    eigenvalue ladder and rho stay f32: the deflation invariant
    ``s[-1] == 0`` and the ``rho * I`` compensation do not survive rounding.

The reference marks the second-moment leaves with ``Tagged``/``StateMeta``
roles; the port has no tags, so a stats NamedTuple declares its
second-moment fields in a class attribute ``second_moments`` (a tuple of
field names; a container without one is second moment throughout).  Only
those leaves are stored in low precision and counted by
``api.second_moment_bytes``: Shampoo's cached roots ``PL``/``PR``
(the reference's role ``"preconditioner"``) and Adam's ``mu`` (``"momentum"``)
stay f32 and uncounted.

Stochastic rounding takes a key: a tuple of ints, extended by ``fold_in``
as the reference's ``jax.random.fold_in`` extends a PRNG key, and turned
into a ``torch.Generator`` on the tensor's device.  It cannot give
``jax.random``'s bits; it gives the same distribution.
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple, Optional

import torch

SECOND_MOMENT_DTYPES = ("fp32", "bf16", "int8")

_INT8_MAX = 127.0


class QuantizedPool(NamedTuple):
    """One int8-quantized stack: int8 values and an f32 scale that keeps the
    values' rank (``(N, 1, 1)`` per block, or ``(1,) * ndim`` per leaf)."""
    values: torch.Tensor
    scale: torch.Tensor


def fold_in(key: Optional[tuple], i: int) -> Optional[tuple]:
    """The key of sub-stream ``i`` of ``key`` (None stays None)."""
    return None if key is None else key + (int(i),)


def generator(key: tuple, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``key`` (the same seed in every
    process)."""
    digest = hashlib.blake2b(repr(tuple(key)).encode(), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & (2 ** 63 - 1)
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Scale/round core


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """absmax -> f32 scale mapping ``|x| <= absmax`` onto the int8 range."""
    return torch.where(absmax > 0, absmax / _INT8_MAX, 1.0)


def round_int8(scaled: torch.Tensor,
               gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Round pre-scaled values to int8: to nearest, half to even (as
    ``jnp.round``), or stochastically with ``gen`` (uniform noise in
    [-0.5, 0.5) before rounding: unbiased).  An integer input is a fixed
    point of the first."""
    if gen is not None:
        noise = torch.rand(scaled.shape, generator=gen, dtype=torch.float32,
                           device=scaled.device) - 0.5
        scaled = scaled + noise
    return torch.clamp(torch.round(scaled), -_INT8_MAX, _INT8_MAX).to(
        torch.int8)


def quantize_like(x: torch.Tensor, scale_shape, *,
                  key: Optional[tuple] = None) -> QuantizedPool:
    """Quantize with the absmax taken over the axes where ``scale_shape`` is
    1: ``(N, 1, 1)`` gives a scale per block, ``(1,) * ndim`` one per
    tensor."""
    x32 = x.float()
    axes = tuple(i for i, n in enumerate(scale_shape) if n == 1)
    absmax = x32.abs()
    if axes:
        absmax = torch.amax(absmax, dim=axes, keepdim=True)
    scale = int8_scale(absmax)
    gen = None if key is None else generator(key, x.device)
    return QuantizedPool(values=round_int8(x32 / scale, gen), scale=scale)


def quantize_stack(x: torch.Tensor, *,
                   key: Optional[tuple] = None) -> QuantizedPool:
    """``(N, ...)`` float stack -> int8 values and one f32 scale per block."""
    return quantize_like(x, (x.shape[0],) + (1,) * (x.ndim - 1), key=key)


def dequantize_stack(values: torch.Tensor, scale: torch.Tensor
                     ) -> torch.Tensor:
    return values.float() * scale


# ---------------------------------------------------------------------------
# Storage transforms over a pool stack's tree (NamedTuples of tensors)


def _is_node(x) -> bool:
    return isinstance(x, (QuantizedPool, torch.Tensor))


def _flatten(x) -> list:
    return [leaf for _, leaf in _flatten_roles(x)]


def _flatten_roles(x, second: bool = True) -> list:
    """``[(is_second_moment, leaf), ...]`` in ``_flatten`` order: a field
    is second moment when every container above it declares it so in its
    ``second_moments`` (or declares nothing)."""
    if _is_node(x):
        return [(second, x)]
    declared = getattr(x, "second_moments", None)
    names = getattr(x, "_fields", ())
    out = []
    for i, item in enumerate(x):
        role = second and (declared is None or names[i] in declared)
        out += _flatten_roles(item, role)
    return out


def _unflatten(like, leaves) -> Any:
    return _build(like, iter(leaves))


def _build(x, it) -> Any:
    # recursion at module level: a nested function that calls itself is a
    # reference cycle, which would hold ``leaves`` (a sketch of 6.7 GB at
    # deepseek-moe-16b's head) until the cyclic collector runs
    if _is_node(x):
        return next(it)
    return type(x)(*(_build(item, it) for item in x))


def _map_second_moments(fn, tree) -> Any:
    """``fn`` over the second-moment leaves; the others pass through."""
    return _unflatten(tree, [fn(x) if second else x
                             for second, x in _flatten_roles(tree)])


def second_moment_tensors(tree) -> list:
    """The tensors of a stats tree (or a single tensor or container) that
    hold second-moment state, as stored: int8 values and their scales."""
    return [t for second, x in _flatten_roles(tree) if second
            for t in ((x,) if isinstance(x, torch.Tensor) else x)]


def _check(dtype: str) -> None:
    if dtype not in SECOND_MOMENT_DTYPES:
        raise ValueError(f"unknown second_moment_dtype {dtype!r}; expected "
                         f"one of {SECOND_MOMENT_DTYPES}")


def quantize_pool(stats: Any, dtype: str) -> Any:
    """f32 stats tree (one pool stack) -> its storage layout, rounded to
    nearest (the engine's init)."""
    _check(dtype)
    if dtype == "fp32":
        return stats
    if dtype == "bf16":
        return _map_second_moments(lambda x: x.to(torch.bfloat16), stats)
    return _map_second_moments(
        lambda x: quantize_stack(x) if x.ndim >= 3 else x, stats)


def quantize_leaf_state(stats: torch.Tensor, dtype: str) -> Any:
    """A diagonal-fallback accumulator -> its storage layout: bf16, or int8
    with one whole-leaf scale of shape ``(1,) * ndim``."""
    _check(dtype)
    if dtype == "fp32":
        return stats
    if dtype == "bf16":
        return stats.to(torch.bfloat16)
    return quantize_like(stats, (1,) * stats.ndim)


def dequantize_pool(stats: Any) -> Any:
    """Storage layout -> f32 compute tree (for fp32, the tree itself): the
    second-moment leaves dequantized or cast to f32, every other leaf (the
    rank budget's int32 active ranks, Shampoo's roots) as it is stored."""
    return _map_second_moments(lambda x: dequantize_stack(*x)
                               if isinstance(x, QuantizedPool) else x.float(),
                               stats)


def compute_view(stats: Any) -> Any:
    """Storage layout -> compute tree that keeps the int8 containers, for
    the fused int8 path: the FD functions (core/fd.py) run their int8
    kernels on them, and no f32 eigenvector stack is formed.  Other leaves
    as ``dequantize_pool`` gives them."""
    return _map_second_moments(lambda x: x if isinstance(x, QuantizedPool)
                               else x.float(), stats)


def requantize_pool(template: Any, raw: Any, *,
                    key: Optional[tuple] = None) -> Any:
    """Computed tree -> storage layout of ``template`` (the previous state).
    Leaf ``i`` under an int8 container is quantized with the key
    ``fold_in(key, i)``, unless it arrives already quantized (the fused
    path's write-back): that passes through, since quantizing it again
    would round twice.  Other leaves take the template's dtype."""
    flat_t, flat_r = _flatten(template), _flatten(raw)
    if len(flat_t) != len(flat_r):
        raise ValueError("template and computed trees differ in structure")
    out = []
    for i, (t, r) in enumerate(zip(flat_t, flat_r)):
        if isinstance(t, QuantizedPool):
            out.append(r if isinstance(r, QuantizedPool) else quantize_like(
                r, tuple(t.scale.shape), key=fold_in(key, i)))
        else:
            out.append(r.to(t.dtype))
    return _unflatten(template, out)
