"""Atomic, asynchronous checkpoints (port of repro/train/checkpoint.py).

On disk, as the reference writes them: a directory per step, one ``.npy``
per leaf (``leaf-%05d.npy``) and ``manifest.json`` with ``step``,
``extra`` and one record per leaf (``name``, ``file``, ``dtype``,
``shape``, ``meta``).  Writes go to ``<dir>/tmp-<step>`` and are renamed
with ``os.replace`` to ``<dir>/step-<step>``, so a crash mid-write leaves
the last checkpoint whole; the last three steps are kept.
``AsyncCheckpointer`` copies the state to host memory at once and writes it
on a worker thread.

Names are paths over the port's state: dict keys (in sorted order, as JAX
flattens them), sequence indices and NamedTuple fields (``.field``), joined
with ``::``.  ``meta`` records the leaf's role, or null for a leaf without
one (the parameters).  Roles come from the state's NamedTuples: a field in
``second_moments`` (core/quantize.py) is ``"second_moment"``, a field in
``roles`` has the role given there, any other field inherits its
container's; a container that declares ``second_moments`` must give every
other field a role.  ``restore`` refuses a role mismatch, as the reference
does.  The reference's names and roles cross to the port's through
``repro_torch.convert.convert_checkpoint``.

A Python int in the state (the step counts) is written as a 0-d int32 leaf
and restored as an int.  bf16 tensors are written as raw 2-byte records
(numpy ``|V2``) with the dtype string ``"bfloat16"``, as the reference's
``np.save`` of an ml_dtypes array writes them, and read back through int16.
Float leaves are cast onto the template's dtype; other leaves pass through.

Transient fields (``transient``: the async refresh's pending slot) are
derived state: never written, and rebuilt on restore as the engine's init
builds them, zeros with ``valid=False``.  So an inline and an async run's
checkpoints have the same manifest, and each restores into the other mode;
the first step after a restore commits no pending refresh.

Migration, as the reference's shims (:286, :392): a float stack restored
into an int8 template is quantized (round to nearest, so a restore is
reproducible), an int8 pair restored into a float template is dequantized
(``values * scale``), and a fixed-rank checkpoint restored into a budgeted
template keeps the template's uniform active ranks.  A pre-pool checkpoint
(the reference's per-leaf engine layout, :191, carried across by
``convert.convert_checkpoint``) is repacked into the template's pools.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import quantize

_SEP = "::"
_QP_VALUES = "::.values"    # an int8 stack: <base>::.values, <base>::.scale
_QP_SCALE = "::.scale"
_ACTIVE_RANK = "::.k"       # the rank budget's (N,) int32 active ranks
# What a pool stack holds, after ``<prefix>.pools::<KEY>::``: Sketchy's
# sketch pair (int8 eigenvectors as values and scale) and active ranks,
# Shampoo's factors (L and R, int8 alike) and roots
POOL_SUFFIX = (r"\.(?:left|right)::(?:\.eigvecs(?:::\.values|::\.scale)?"
               r"|\.eigvals|\.rho)|\.k|\.(?:L|R)(?:::\.values|::\.scale)?"
               r"|\.PL|\.PR")
_PRE_POOL_STATS = re.compile(rf"^(.*)\.leaves::(\d+)::\.stats::({POOL_SUFFIX})$")
_POOL_LEAF = re.compile(r"^(.*)\.pools::(\d+x\d+)::(.+)$")
_KEEP = 3


class Leaf(NamedTuple):
    """One leaf of a state: its name, value (a tensor or a Python int or
    bool), role (None for a leaf without one) and whether it is
    transient."""
    name: str
    value: Any
    role: Optional[str]
    transient: bool


def _join(prefix: str, part: str) -> str:
    return f"{prefix}{_SEP}{part}" if prefix else part


def map_leaves(fn: Callable, x, name: str = "",
               role: Optional[str] = None, transient: bool = False):
    """The state ``x`` with each leaf replaced by ``fn(Leaf)``, visiting
    the leaves in the manifest's order (dict keys sorted); ``name``,
    ``role`` and ``transient`` are those of ``x`` itself."""
    if isinstance(x, (torch.Tensor, int)):      # bool is an int
        return fn(Leaf(name or "leaf", x, role, transient))
    if x is None:
        return None
    if isinstance(x, dict):
        out = {k: map_leaves(fn, x[k], _join(name, str(k)), role, transient)
               for k in sorted(x)}
        return {k: out[k] for k in x}
    if hasattr(x, "_fields"):
        cls = type(x)
        declared = getattr(cls, "second_moments", None)
        roles = getattr(cls, "roles", {})
        items = []
        for field, item in zip(x._fields, x):
            if declared is not None and field in declared:
                r = "second_moment"
            elif field in roles:
                r = roles[field]
            elif declared is not None:
                raise TypeError(f"{cls.__name__}.{field} declares no "
                                "checkpoint role")
            else:
                r = role
            items.append(map_leaves(
                fn, item, _join(name, "." + field), r,
                transient or field in getattr(cls, "transient", ())))
        return cls(*items)
    if isinstance(x, (list, tuple)):
        return type(x)(map_leaves(fn, item, _join(name, str(i)), role,
                                  transient) for i, item in enumerate(x))
    raise TypeError(f"cannot checkpoint {type(x).__name__} at {name!r}")


def leaves(state) -> list:
    """Every leaf of ``state`` as a ``Leaf``, in the manifest's order,
    transient ones included."""
    out: list = []
    map_leaves(lambda leaf: out.append(leaf) or leaf.value, state)
    return out


def _to_numpy(value) -> np.ndarray:
    """A host copy of one leaf, as written: bf16 as raw 2-byte records, a
    Python int as a 0-d int32."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value, np.int32)
    t = value.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _snapshot(state) -> list:
    """``(name, array, role)`` of each leaf that is written: host copies,
    so the caller may change the state at once."""
    return [(leaf.name, _to_numpy(leaf.value), leaf.role)
            for leaf in leaves(state) if not leaf.transient]


def _write(directory: str, step: int, records: list,
           extra: Optional[dict]) -> str:
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, arr, role) in enumerate(records):
        fname = f"leaf-{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "name": name, "file": fname,
            "dtype": "bfloat16" if arr.dtype.kind == "V" else str(arr.dtype),
            "shape": list(arr.shape),
            "meta": None if role is None else {"role": role}})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory)
    return final


def save(directory: str, step: int, state, *,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic save of ``state`` as ``step``; returns the final
    path.  Transient leaves are not written."""
    return _write(directory, step, _snapshot(state), extra)


def _gc(directory: str) -> None:
    for s in all_steps(directory)[:-_KEEP]:
        shutil.rmtree(os.path.join(directory, f"step-{s}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step-"):
            try:
                out.append(int(d.split("-", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _load_rec(path: str, rec: dict) -> torch.Tensor:
    """One manifest record as a CPU tensor; a raw 2-byte record of dtype
    ``"bfloat16"`` is read through int16."""
    arr = np.load(os.path.join(path, rec["file"]))
    if arr.dtype.kind == "V":
        if rec["dtype"] != "bfloat16" or arr.dtype.itemsize != 2:
            raise ValueError(f"{rec['name']}: raw record of dtype "
                             f"{rec['dtype']!r} cannot be read")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.c_contiguous else arr.copy())


def _check_role(leaf: Leaf, rec: dict) -> None:
    rec_role = (rec.get("meta") or {}).get("role")
    if leaf.role is not None and rec_role is not None \
            and rec_role != leaf.role:
        raise ValueError(f"state-role mismatch at {leaf.name}: checkpoint "
                         f"has {rec_role!r}, template expects {leaf.role!r}")


def _cast(t: torch.Tensor, like) -> torch.Tensor:
    """A float leaf cast onto the template's float dtype (fp32 <-> bf16);
    other leaves pass through."""
    if isinstance(like, torch.Tensor) and t.dtype != like.dtype \
            and t.is_floating_point() and like.is_floating_point():
        return t.to(like.dtype)
    return t


def _load(path: str, rec: dict, leaf: Leaf) -> torch.Tensor:
    _check_role(leaf, rec)
    return _cast(_load_rec(path, rec), leaf.value)


def _migrate_pre_pool(path: str, recs: dict, kept: list) -> Optional[list]:
    """A pre-pool checkpoint into the pooled template (reference :191).
    The old layout keeps each leaf's block stacks at
    ``<prefix>.leaves::<j>::.stats::<suffix>``; the template's
    ``<prefix>.pools::<KEY>::<suffix>`` concatenates its member leaves'
    stacks in leaf order, core/pool.py's pack order.  Leaf j belongs to
    the one group whose stacks match its suffixes and per-block shapes.
    None when the checkpoint is not of the old layout."""
    targets = [(i, _POOL_LEAF.match(leaf.name))
               for i, leaf in enumerate(kept)]
    targets = [(i, m) for i, m in targets if m]
    old: dict = {}      # prefix -> leaf j -> {suffix: record}
    for name, rec in recs.items():
        m = _PRE_POOL_STATS.match(name)
        if m:
            old.setdefault(m.group(1), {}).setdefault(
                int(m.group(2)), {})[m.group(3)] = rec
    if not targets or not old:
        return None
    want: dict = {}     # prefix -> KEY -> {suffix: (template index, shape)}
    for i, m in targets:
        want.setdefault(m.group(1), {}).setdefault(m.group(2), {})[
            m.group(3)] = (i, tuple(kept[i].value.shape))
    out: dict = {}
    consumed: set = set()
    for prefix, groups in want.items():
        members = old.get(prefix, {})
        assign: dict = {key: [] for key in groups}
        for j in sorted(members):
            matches = [key for key, sfxs in groups.items()
                       if set(sfxs) == set(members[j]) and all(
                           tuple(members[j][sfx]["shape"])[1:] == shp[1:]
                           for sfx, (_, shp) in sfxs.items())]
            if len(matches) != 1:
                raise ValueError(
                    f"pre-pool migration: leaf {prefix}.leaves::{j} matches "
                    f"{len(matches)} shape groups: cannot regroup")
            assign[matches[0]].append(j)
        for key, ids in assign.items():
            for sfx, (i, shp) in groups[key].items():
                parts = [members[j][sfx] for j in ids]
                if not parts:
                    raise ValueError(f"pre-pool migration: no leaf fills "
                                     f"{kept[i].name!r}")
                _check_role(kept[i], parts[0])
                consumed.update(r["name"] for r in parts)
                arr = torch.cat([_load_rec(path, r) for r in parts])
                if tuple(arr.shape) != shp:
                    raise ValueError(
                        f"pre-pool migration: pool {kept[i].name} expects "
                        f"{shp}, regrouped stacks give {tuple(arr.shape)}")
                out[i] = _cast(arr, kept[i].value)
    loaded = []
    for i, leaf in enumerate(kept):
        if i in out:
            loaded.append(out[i])
            continue
        if leaf.name not in recs:
            raise ValueError(f"pre-pool migration: template leaf "
                             f"{leaf.name!r} missing from checkpoint")
        loaded.append(_load(path, recs[leaf.name], leaf))
        consumed.add(leaf.name)
    _check_consumed("pre-pool", recs, consumed)
    return loaded


def _migrate_quantized(path: str, recs: dict, kept: list) -> Optional[list]:
    """Stacks across second-moment storages (reference :286): a template
    int8 pair ``<base>::.values`` / ``<base>::.scale`` from a checkpointed
    float ``<base>`` (quantized to nearest, the absmax over the axes where
    the template's scale is 1), and a template float ``<base>`` from a
    checkpointed int8 pair (``values * scale``).  None when no such rename
    is involved."""
    names = {leaf.name for leaf in kept}

    def base_of(name):
        for sfx in (_QP_VALUES, _QP_SCALE):
            if name.endswith(sfx):
                return name[:-len(sfx)]
        return None

    involved = any(
        (base_of(n) is not None and base_of(n) in recs)
        or (n + _QP_VALUES) in recs for n in names if n not in recs)
    if not involved:
        return None
    scale_shapes = {leaf.name[:-len(_QP_SCALE)]: tuple(leaf.value.shape)
                    for leaf in kept if leaf.name.endswith(_QP_SCALE)}
    quantized: dict = {}
    consumed: set = set()
    out = []
    for leaf in kept:
        name, base = leaf.name, base_of(leaf.name)
        if name in recs:
            out.append(_load(path, recs[name], leaf))
            consumed.add(name)
        elif base is not None and base in recs:
            if base not in quantized:
                _check_role(leaf, recs[base])
                src = _load_rec(path, recs[base]).float()
                quantized[base] = quantize.quantize_like(
                    src, scale_shapes.get(base, (src.shape[:1] or (1,))
                                          + (1,) * (src.ndim - 1)))
                consumed.add(base)
            out.append(quantized[base][0 if name.endswith(_QP_VALUES)
                                       else 1])
        elif (name + _QP_VALUES) in recs and (name + _QP_SCALE) in recs:
            vrec, srec = recs[name + _QP_VALUES], recs[name + _QP_SCALE]
            _check_role(leaf, vrec)
            out.append(_cast(quantize.dequantize_stack(
                _load_rec(path, vrec), _load_rec(path, srec)), leaf.value))
            consumed.update((vrec["name"], srec["name"]))
        elif name.endswith(_ACTIVE_RANK) and leaf.role == "count":
            # a dtype change together with a fixed-rank checkpoint
            out.append(leaf.value.clone())
        else:
            raise ValueError(
                f"quantized-state migration: template leaf {name!r} has no "
                "source in the checkpoint")
    _check_consumed("quantized-state", recs, consumed)
    return out


def _migrate_fixed_rank(path: str, recs: dict, kept: list) -> Optional[list]:
    """A fixed-rank checkpoint into a budgeted template (reference :392):
    the missing active ranks keep the template's uniform allocation, every
    other leaf must match.  None when no active-rank leaf is missing."""
    def missing_rank(leaf):
        return leaf.name not in recs and leaf.name.endswith(_ACTIVE_RANK) \
            and leaf.role == "count"

    if not any(missing_rank(leaf) for leaf in kept):
        return None
    out = []
    for leaf in kept:
        if missing_rank(leaf):
            out.append(leaf.value.clone())
        elif leaf.name in recs:
            out.append(_load(path, recs[leaf.name], leaf))
        else:
            raise ValueError(f"fixed-rank migration: template leaf "
                             f"{leaf.name!r} missing from checkpoint")
    _check_consumed("fixed-rank", recs,
                    {leaf.name for leaf in kept if leaf.name in recs})
    return out


def _check_consumed(what: str, recs: dict, consumed: set) -> None:
    leftover = set(recs) - consumed
    if leftover:
        raise ValueError(
            f"{what} migration: {len(leftover)} checkpoint leaves were not "
            f"consumed (e.g. {sorted(leftover)[:3]}): incompatible states")


def _restored(leaf: Leaf, value) -> Any:
    """The restored value of a template leaf: on its device and of its
    shape, an int for an int."""
    like = leaf.value
    if not isinstance(like, torch.Tensor):
        if value.dim() != 0:
            raise ValueError(f"{leaf.name}: a count of shape "
                             f"{tuple(value.shape)}")
        return type(like)(value.item())
    if tuple(value.shape) != tuple(like.shape):
        raise ValueError(f"{leaf.name}: checkpoint shape "
                         f"{tuple(value.shape)}, template "
                         f"{tuple(like.shape)}")
    return value.to(like.device)


def _empty(leaf: Leaf) -> Any:
    """A transient leaf as init builds it: zeros, ``valid=False``."""
    if isinstance(leaf.value, torch.Tensor):
        return torch.zeros_like(leaf.value)
    return type(leaf.value)(0)


def restore(directory: str, template, *, step: Optional[int] = None
            ) -> tuple:
    """Load ``step`` (default: the latest) into the structure of
    ``template``, onto its devices; returns ``(state, step, extra)``."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step-{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    kept = [leaf for leaf in leaves(template) if not leaf.transient]
    records = manifest["leaves"]
    recs = {r["name"]: r for r in records}
    loaded = None
    if [leaf.name for leaf in kept] != [r["name"] for r in records]:
        loaded = _migrate_pre_pool(path, recs, kept)
        if loaded is None:
            loaded = _migrate_quantized(path, recs, kept)
        if loaded is None:
            loaded = _migrate_fixed_rank(path, recs, kept)
        if loaded is None and len(kept) != len(records):
            raise ValueError(f"checkpoint has {len(records)} leaves, "
                             f"template has {len(kept)}: incompatible "
                             "structures")
    if loaded is None:
        loaded = []
        for leaf, rec in zip(kept, records):
            if leaf.name != rec["name"]:
                raise ValueError(f"leaf mismatch: {leaf.name} vs "
                                 f"{rec['name']}")
            loaded.append(_load(path, rec, leaf))
    by_name = {leaf.name: _restored(leaf, value)
               for leaf, value in zip(kept, loaded)}
    state = map_leaves(lambda leaf: _empty(leaf) if leaf.transient
                 else by_name[leaf.name], template)
    return state, step, manifest.get("extra", {})


class AsyncCheckpointer:
    """Snapshot to host memory at once (a copy: the caller may change the
    state as soon as ``save`` returns), write to disk on a worker thread;
    one write outstanding at a time, and a write's error raised by the
    next ``wait`` (or ``save``)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state) -> None:
        self.wait()
        records = _snapshot(state)

        def work():
            try:
                _write(self.directory, step, records, None)
            except BaseException as e:   # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
