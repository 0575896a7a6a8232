"""Roofline analysis of the port's steps, and the card's constants (port of
repro/launch/roofline.py).

The constants below are the one set the package (and chip_smoke.py) uses
for a bound: the data sheet's numbers for the NVIDIA H100 80GB HBM3 (SXM)
at its 700.00 W power limit, dense, not measurements.  A card set below
700 W runs slower under load; a measurement stands beside the name and
power limit ``nvidia-smi`` reports.

``cost_of`` measures one eager call instead of a compiled program: the
flops ``torch.utils.flop_counter.FlopCounterMode`` counts, the bytes of
each aten op's operands and results (what eager execution moves through
device memory; views move nothing), and the bytes of each collective the
port calls (``c10d`` ops, under the reference's keys).  Eager execution
runs every layer, so a probe's cost is exact at its depth; the dry run
(launch/dryrun_lib.py) still solves the affine system over probes of 1-3
layers (``solve_affine``), as the reference does, to reach the full depth
without running it.  The reference's HLO-text parser (``collective_bytes``)
is not ported: nothing in the port produces HLO.

``LiveBytes`` tracks the bytes of live storages an eager call allocates
(on any device, meta included): the dry run's stand-in for XLA's
``memory_analysis()``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 80GB HBM3 (SXM), 700.00 W, dense: the data sheet's peaks
HBM_BYTES_PER_S = 3.35e12           # device memory
F32_FLOPS_PER_S = 67e12             # f32 outside the tensor cores
TF32_FLOPS_PER_S = 494.7e12         # tf32 on the tensor cores
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3   # error-compensated 3xTF32
BF16_FLOPS_PER_S = 989e12           # bf16 on the tensor cores
INT8_OPS_PER_S = 1979e12            # int8 on the tensor cores
NVLINK_BYTES_PER_S = 450e9          # NVLink 4, each direction
# what the card holds on chip at once: 132 SMs of 256 KiB of registers and
# 228 KiB of shared memory, and 50 MiB of L2
ONCHIP_BYTES = 132 * (256 + 228) * 1024 + 50 * 2 ** 20

# the roofline's compute term: the model's bf16 work
PEAK_FLOPS = BF16_FLOPS_PER_S

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# c10d op names (dist.* calls and functional collectives) -> the keys
_COLLECTIVE_OF = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "collective-permute",
}


@dataclasses.dataclass
class ProbeCost:
    flops: float
    bytes_accessed: float
    coll: Dict[str, float]


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpBytes(TorchDispatchMode):
    """Bytes each aten op reads and writes, and each collective's operand
    bytes, by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.coll = {k: 0.0 for k in COLLECTIVE_OPS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional"):
            kind = _COLLECTIVE_OF.get(func._schema.name.split("::")[-1])
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in _tensors(args))
        elif ns == "aten" and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in
                              _tensors(args) + _tensors(kwargs or {})
                              + _tensors(out))
        return out


def cost_of(fn: Callable, *args, **kwargs) -> ProbeCost:
    """The cost of one eager call of ``fn(*args, **kwargs)``."""
    counted = _OpBytes()
    with FlopCounterMode(display=False) as flops, counted:
        fn(*args, **kwargs)
    coll = dict(counted.coll)
    coll["total"] = float(sum(coll[k] for k in COLLECTIVE_OPS))
    return ProbeCost(flops=float(flops.get_total_flops()),
                     bytes_accessed=float(counted.bytes), coll=coll)


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages an eager call allocates, while they live:
    ``live`` now, ``peak`` the most at once.  Each op's outputs are
    followed by their storages (a view shares its base's); a storage is
    freed when the last tensor of it that the call made is (autograd's
    saved tensors keep theirs alive, as on the card).  Storages made
    before the call (the arguments) are not counted; ``was_read`` says
    whether an op read one."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._known = set()        # storages of the arguments
        self._read = set()         # storages an op took as an operand
        self._refs = {}            # storage -> (nbytes, tensors alive)

    def start(self, tensors) -> None:
        """Mark the storages of ``tensors`` (the arguments) as not the
        call's."""
        for t in _tensors(tensors):
            self._known.add(self._key(t))

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def was_read(self, t: torch.Tensor) -> bool:
        return self._key(t) in self._read

    def _release(self, key: int) -> None:
        nbytes, n = self._refs[key]
        if n > 1:
            self._refs[key] = (nbytes, n - 1)
            return
        del self._refs[key]
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in _tensors(args) + _tensors(kwargs or {}):
            self._read.add(self._key(t))
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            key = self._key(t)
            if key in self._refs:
                nbytes, n = self._refs[key]
                self._refs[key] = (nbytes, n + 1)
            elif key in self._known:
                continue
            else:
                nbytes = t.untyped_storage().nbytes()
                self._refs[key] = (nbytes, 1)
                self.live += nbytes
                self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, key)
        return out


def solve_affine(probe_counts: Sequence[Sequence[int]],
                 probe_costs: Sequence[ProbeCost],
                 full_counts: Sequence[int]) -> ProbeCost:
    """C(n) = outer + n . blocks; evaluate at full_counts."""
    A = np.array([[1.0] + list(c) for c in probe_counts])
    full = np.array([1.0] + list(full_counts))

    def solve(vals):
        coef, *_ = np.linalg.lstsq(A, np.array(vals, dtype=np.float64),
                                   rcond=None)
        return float(max(full @ coef, 0.0))

    flops = solve([p.flops for p in probe_costs])
    byts = solve([p.bytes_accessed for p in probe_costs])
    keys = set()
    for p in probe_costs:
        keys |= set(p.coll)
    coll = {k: solve([p.coll.get(k, 0.0) for p in probe_costs]) for k in keys}
    return ProbeCost(flops=flops, bytes_accessed=byts, coll=coll)


def roofline_terms(cost: ProbeCost) -> Dict[str, float]:
    """Per-device seconds for each roofline term."""
    t_compute = cost.flops / PEAK_FLOPS
    t_memory = cost.bytes_accessed / HBM_BYTES_PER_S
    t_coll = cost.coll.get("total", 0.0) / NVLINK_BYTES_PER_S
    dominant = max(
        (("compute", t_compute), ("memory", t_memory), ("collective", t_coll)),
        key=lambda kv: kv[1])[0]
    return {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
