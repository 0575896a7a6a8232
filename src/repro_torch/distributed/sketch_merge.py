"""Wire format and merge rules for exchanging FD sketch stacks between ranks
(port of repro/distributed/sketch_merge.py).

A pooled sketch stack ``FDState`` (eigvecs (N, d, ell), eigvals (N, ell),
rho (N,)) travels as its weighted factor ``B = U diag(sqrt(s))``:

  * the deflation invariant ``s[-1] == 0`` makes B's last column zero, so
    ``ell - 1`` columns go on the wire (``fd_weighted_factor(drop_deflated=
    True)``);
  * under ``wire_dtype="int8"`` the factor is stored as int8 with one f32
    absmax scale a block (``quantize.quantize_stack``): about ``(ell - 1) *
    d`` bytes a block instead of the ``d^2`` f32 of a dense statistic.

The rounding on the wire is to nearest, with no key, and both sides of a
merge go through it: a rank merges its own factor as its partner receives
it, so both ranks of a pair compute the same merged state from the same
bytes, and the statistics stay the same on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import quantize
from repro_torch.core.fd import (FDState, fd_merge_batched,
                                 fd_merge_factors_batched, fd_weighted_factor)

WIRE_DTYPES = ("int8", "fp32")


class WireSketch(NamedTuple):
    """One pooled sketch stack in exchange form.

    values: (N, d, r) factor, int8 under the int8 wire, f32 otherwise.
    scale:  (N, 1, 1) f32 absmax scales (ones under the f32 wire).
    rho:    (N,) f32 escaped mass carried beside it.
    """
    values: torch.Tensor
    scale: torch.Tensor
    rho: torch.Tensor


def pack_wire(state: FDState, wire_dtype: str = "int8") -> WireSketch:
    """Sketch stack -> wire form (without the deflated zero column)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}; expected one "
                         f"of {WIRE_DTYPES}")
    B = fd_weighted_factor(state, drop_deflated=True)   # (N, d, ell - 1)
    rho = state.rho.float()
    if wire_dtype == "fp32":
        ones = torch.ones((B.shape[0],) + (1,) * (B.ndim - 1),
                          dtype=torch.float32, device=B.device)
        return WireSketch(values=B.float(), scale=ones, rho=rho)
    qp = quantize.quantize_stack(B)      # to nearest: no key
    return WireSketch(values=qp.values, scale=qp.scale, rho=rho)


def unpack_wire(wire: WireSketch) -> tuple[torch.Tensor, torch.Tensor]:
    """Wire form -> (f32 weighted factor, rho)."""
    if wire.values.dtype == torch.float32:
        return wire.values, wire.rho
    return quantize.dequantize_stack(wire.values, wire.scale), wire.rho


def wire_bytes(wire: WireSketch) -> int:
    """Bytes one rank sends per exchange of this stack."""
    return sum(t.numel() * t.element_size() for t in wire)


def merge_wire(a: WireSketch, b: WireSketch, *, ell: int) -> FDState:
    """Merge two wire sketches into a rank-``ell`` stack, both sides read
    back from the wire's grid."""
    Ba, rho_a = unpack_wire(a)
    Bb, rho_b = unpack_wire(b)
    return fd_merge_factors_batched(Ba, rho_a, Bb, rho_b, ell=ell)


def merge_stack_states(states) -> FDState:
    """Exact (no wire) pairwise-tree merge of same-shaped sketch stacks, in
    list order: the sketches of ranks that leave fold into those that
    stay, and the statistics go on without a restart."""
    states = list(states)
    if not states:
        raise ValueError("merge_stack_states needs at least one state")
    while len(states) > 1:
        nxt = [fd_merge_batched(states[i], states[i + 1])
               for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]
