"""Shape-aware autotuner of the batched Hopper kernels (port of
repro/kernels/autotune.py, with the choices the port's kernels have in
place of the reference's Pallas tiles ``(bn_stack, bk, bd, bn)``).

The tunables:

  * ``batched_lowrank_apply`` (kernels 2 and 2', csrc/lowrank.cu): the
    column tile ``col_tile``, the columns of G a block takes, 8, 16, 32 or
    64, among those whose shared memory fits at the shape's ell and U's
    dtype (``lowrank.kernel.apply_col_tiles``).  The default is the widest.
  * ``batched_project_quantize`` (kernel 6, csrc/project_quantize.cu): the
    stream-K block count ``blocks`` of its first pass, a multiple of the
    card's 132 SMs up to four waves of them or the shape's units, whichever
    is fewer.  The default is ``lowrank.kernel.project_plan``'s, as many as
    are resident at once (396 on the H100).
  * ``batched_gram`` and ``batched_gram_mixed`` (kernels 1 and 5,
    csrc/gram.cu) have fixed 128 x 128 tiles: their candidate set is the
    default alone.

A config's fields that a kernel does not use are pinned to 0, and
``effective`` resolves a 0 to the default the kernel would take, so
equivalent configs compare equal.  Keys are ``"<device>|<kernel>|<NxDx...>|
<dtype>"``, the device ``torch.cuda.get_device_name()`` (the reference's
``cpu|...`` entries belong to its Pallas kernels and are never read here);
dtype is U's for the apply ("float32" or "int8") and the stored factor's
for the others.  The registry (kernels/registry.py) resolves the config of
a CUDA launch once per (kernel, shape, dtype) through ``get_config`` and
keeps it; a CPU tensor takes the plain version, which has no tiles.

Tune modes (``REPRO_TUNE_MODE``, default ``"auto"``):

  * ``"off"``   every lookup returns the default.
  * ``"auto"``  a cache hit wins, a miss takes the default; nothing is
                measured implicitly.
  * ``"force"`` a miss runs the measured search (on the card) and saves the
                winner; for offline cache generation (the CLI).

The cache defaults to the committed fixture beside this module
(``tune_cache.json``: the winners the card found for the main path's
shapes; ``validate_cache`` checks it against the candidate space);
``REPRO_TUNE_CACHE`` points lookups at another path.

    python -m repro_torch.kernels.autotune validate
    python -m repro_torch.kernels.autotune show
    python -m repro_torch.kernels.autotune tune --kernel \\
        batched_lowrank_apply --shape 68x1024x64x768 --cache build/tune.json
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import zlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.lowrank import kernel as lowrank_kernel

TUNE_MODES = ("auto", "off", "force")
ENV_CACHE = "REPRO_TUNE_CACHE"
ENV_MODE = "REPRO_TUNE_MODE"
DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tune_cache.json")
CACHE_VERSION = 1


class TileConfig(NamedTuple):
    """Launch choices of the batched kernels (module docstring); 0 is the
    kernel's default."""
    col_tile: int = 0
    blocks: int = 0


DEFAULT_CONFIG = TileConfig()

KERNELS = ("batched_gram", "batched_gram_mixed", "batched_lowrank_apply",
           "batched_project_quantize")
# the dims of each kernel's shape: (N, d, k), (N, d, k, r), (N, d, ell, n),
# (N, d, k, r, e)
SHAPE_DIMS = {"batched_gram": 3, "batched_gram_mixed": 4,
              "batched_lowrank_apply": 4, "batched_project_quantize": 5}
DTYPES = {"float32": 4, "int8": 1}     # name -> bytes of an element
# the write-back's block counts: waves of the H100's SMs
PROJECT_BLOCKS = tuple(lowrank_kernel.SMS * w for w in (1, 2, 3, 4))


def _dtype_name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def _check(kernel: str, shape: tuple) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of "
                         f"{KERNELS}")
    if len(shape) != SHAPE_DIMS[kernel]:
        raise ValueError(f"{kernel} takes a {SHAPE_DIMS[kernel]}-dim shape, "
                         f"got {tuple(shape)}")


def _project_units(shape: tuple) -> int:
    """The write-back's units at ``shape``: panels of its output tiles,
    the most blocks its first pass takes."""
    p = lowrank_kernel.project_plan(*shape)
    return p.tiles[0] * p.tiles[1] * p.tiles[2] * p.panels


# --------------------------------------------------------------- candidates


def effective(kernel: str, shape: tuple, config: TileConfig,
              dtype="float32") -> TileConfig:
    """``config`` as the kernel would launch it at ``shape``: a 0 resolved
    to the default, a column tile that does not fit clamped to the widest
    narrower one that does, blocks clamped to the shape's units, and the
    fields the kernel does not use pinned to 0."""
    _check(kernel, tuple(shape))
    if kernel == "batched_lowrank_apply":
        tiles = lowrank_kernel.apply_col_tiles(shape[2],
                                               DTYPES[_dtype_name(dtype)])
        if not tiles:
            return TileConfig(col_tile=lowrank_kernel.APPLY_COL_TILES[-1])
        want = config.col_tile or tiles[0]
        return TileConfig(col_tile=max((t for t in tiles if t <= want),
                                       default=tiles[-1]))
    if kernel == "batched_project_quantize":
        default = lowrank_kernel.project_plan(*shape).blocks
        if not config.blocks:
            return TileConfig(blocks=default)
        return TileConfig(blocks=max(min(config.blocks,
                                         _project_units(shape)), 1))
    return DEFAULT_CONFIG


def candidates(kernel: str, shape: tuple, dtype="float32") -> list:
    """The distinct configs the kernel can launch at ``shape``; the
    effective default first (ties in the measured search keep it)."""
    if kernel == "batched_lowrank_apply":
        menu = [TileConfig(col_tile=t) for t in
                lowrank_kernel.APPLY_COL_TILES]
    elif kernel == "batched_project_quantize":
        menu = [TileConfig(blocks=b) for b in PROJECT_BLOCKS]
    else:
        menu = []
    out = [effective(kernel, shape, DEFAULT_CONFIG, dtype)]
    for cand in menu:
        eff = effective(kernel, shape, cand, dtype)
        if eff not in out:
            out.append(eff)
    return out


# -------------------------------------------------------------- cache state


@functools.lru_cache(maxsize=None)
def device_name() -> str:
    """The key's device: the card's name, probed once a process."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"


def key_for(kernel: str, shape: tuple, dtype, device: Optional[str] = None
            ) -> str:
    dims = "x".join(str(int(s)) for s in shape)
    return f"{device or device_name()}|{kernel}|{dims}|{_dtype_name(dtype)}"


def parse_key(key: str) -> tuple:
    """``device|kernel|NxDx...|dtype`` -> (device, kernel, shape, dtype)."""
    parts = key.split("|")
    if len(parts) != 4:
        raise ValueError(f"malformed tune-cache key {key!r}")
    dev, kernel, dims, dtype = parts
    try:
        shape = tuple(int(s) for s in dims.split("x"))
    except ValueError:
        raise ValueError(f"malformed tune-cache key {key!r}") from None
    return dev, kernel, shape, dtype


# path, mode, entries (key -> TileConfig) and the registry's resolutions
# ((kernel, shape, dtype) -> TileConfig), dropped whenever entries change
_STATE: dict = {"path": None, "mode": None, "entries": None, "resolved": {}}


def _load_entries(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    problems = validate_cache(data)
    if problems:
        raise ValueError(f"invalid tune cache {path}: {problems[0]}"
                         + (f" (+{len(problems) - 1} more)"
                            if len(problems) > 1 else ""))
    return {k: TileConfig(**v) for k, v in data.get("entries", {}).items()}


def _resolve() -> dict:
    """The cache path and mode from the environment, read once a process
    (until ``reload``)."""
    if _STATE["entries"] is None:
        path = os.environ.get(ENV_CACHE) or DEFAULT_CACHE_PATH
        mode = os.environ.get(ENV_MODE) or "auto"
        if mode not in TUNE_MODES:
            raise ValueError(f"{ENV_MODE}={mode!r}; expected one of "
                             f"{TUNE_MODES}")
        _STATE.update(path=path, mode=mode, entries=_load_entries(path),
                      resolved={})
    return _STATE


def reload(path: Optional[str] = None, mode: Optional[str] = None) -> None:
    """Re-read the cache (optionally from another path, in another mode);
    the registry's next launch of each shape resolves anew."""
    cur = _resolve()
    path = path if path is not None else cur["path"]
    mode = mode if mode is not None else cur["mode"]
    if mode not in TUNE_MODES:
        raise ValueError(f"tune mode {mode!r}; expected one of {TUNE_MODES}")
    _STATE.update(path=path, mode=mode, entries=_load_entries(path),
                  resolved={})


def get_config(kernel: str, shape: tuple, dtype) -> TileConfig:
    """The config a kernel launches with at ``shape`` on this process's
    card, resolved once per (kernel, shape, dtype) and kept; measures only
    in ``"force"`` mode on a cache miss."""
    st = _resolve()
    memo = (kernel, tuple(shape), _dtype_name(dtype))
    hit = st["resolved"].get(memo)
    if hit is not None:
        return hit
    out = effective(kernel, shape, DEFAULT_CONFIG, dtype)
    if st["mode"] != "off":
        key = key_for(kernel, shape, dtype)
        entry = st["entries"].get(key)
        if entry is not None:
            out = effective(kernel, shape, entry, dtype)
        elif st["mode"] == "force":
            out, _ = tune(kernel, shape, dtype)
            st["entries"][key] = out
            try:
                save(st["path"])
            except OSError:
                pass    # a read-only cache: keep the entry in process only
    st["resolved"][memo] = out
    return out


# ------------------------------------------------------------ measured search


def _operands(kernel: str, shape: tuple, dtype, device) -> tuple:
    """Synthetic operands of exactly the tuned shape on ``device``, the
    same for a key in every process (a generator seeded from the key)."""
    _check(kernel, tuple(shape))
    gen = torch.Generator(device=device).manual_seed(
        zlib.crc32(key_for(kernel, shape, dtype, "operands").encode()))

    def normal(*s):
        return torch.randn(s, generator=gen, device=device)

    def int8(*s):
        return normal(*s).mul_(40).round_().clamp_(-127, 127).to(torch.int8)

    if kernel == "batched_gram":
        return (normal(*shape),)
    if kernel == "batched_gram_mixed":
        N, d, k, r = shape
        return int8(N, d, k), normal(N, k).abs_().add_(0.1), normal(N, d, r)
    if kernel == "batched_lowrank_apply":
        N, d, ell, n = shape
        if _dtype_name(dtype) == "int8":
            # the fused path's coefficients carry the block scale^2
            # (registry ``_fold_quantized_apply``): a scale of 1/127
            return (int8(N, d, ell), normal(N, ell).div_(127.0 ** 2),
                    normal(N).abs_(), normal(N, d, n))
        return (normal(N, d, ell), normal(N, ell), normal(N).abs_(),
                normal(N, d, n))
    N, d, k, r, e = shape
    return int8(N, d, k), normal(N, k, e), normal(N, d, r), normal(N, r, e)


def _runner(kernel: str):
    """``fn(config, *operands)`` launching the hand-written kernel with the
    config's choices (CUDA operands)."""
    from repro_torch.kernels.gram import kernel as gram_kernel
    if kernel == "batched_gram":
        return lambda c, a: gram_kernel.batched_gram(a)
    if kernel == "batched_gram_mixed":
        return lambda c, vq, colw, a: gram_kernel.batched_gram_mixed(
            vq, colw, a)
    if kernel == "batched_lowrank_apply":
        return lambda c, u, co, b, g: lowrank_kernel.batched_lowrank_apply(
            u, co, b, g, col_tile=c.col_tile)
    if kernel == "batched_project_quantize":
        return lambda c, vq, wt, a, wb: \
            lowrank_kernel.batched_project_quantize(vq, wt, a, wb,
                                                    blocks=c.blocks)
    raise ValueError(f"unknown kernel {kernel!r}")


def _plain(kernel: str):
    """``fn(*operands)``: the kernel's plain PyTorch version."""
    from repro_torch.kernels.gram import ref as gram_ref
    from repro_torch.kernels.lowrank import ref as lowrank_ref
    if kernel == "batched_lowrank_apply":
        return lambda u, co, b, g: lowrank_ref.batched_lowrank_apply_ref(
            u.float(), co, b, g)
    return {"batched_gram": gram_ref.batched_gram_ref,
            "batched_gram_mixed": gram_ref.batched_gram_mixed_ref,
            "batched_project_quantize":
                lowrank_ref.batched_project_quantize_ref}[kernel]


def time_config(kernel: str, config: TileConfig, ops: tuple, *,
                repeats: int = 3, calls: int = 10) -> float:
    """Seconds a launch of ``config`` takes on ``ops``: the best of
    ``repeats`` runs of ``calls`` launches timed with CUDA events, after
    one warm-up launch."""
    fn = _runner(kernel)
    fn(config, *ops)
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(config, *ops)
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1e3 / calls)
    return best


def tune(kernel: str, shape: tuple, dtype, *, repeats: int = 3
         ) -> tuple[TileConfig, dict]:
    """Measured search on the card: time every candidate, return (winner,
    table config -> seconds).  A candidate that fails to launch is
    recorded as ``inf`` and never wins; the default is timed first and wins
    ties."""
    if not torch.cuda.is_available():
        raise RuntimeError("tuning measures the kernels on a CUDA card")
    ops = _operands(kernel, shape, dtype, torch.device("cuda"))
    cands = candidates(kernel, shape, dtype)
    table: dict = {}
    for cand in cands:
        try:
            table[cand] = time_config(kernel, cand, ops, repeats=repeats)
        except (RuntimeError, ValueError):
            table[cand] = float("inf")
    winner = min(table, key=lambda c: (table[c], cands.index(c)))
    if table[winner] == float("inf"):
        raise RuntimeError(
            f"every candidate failed for {kernel} {shape} {dtype}")
    return winner, table


def tune_into_cache(specs, *, path: Optional[str] = None) -> dict:
    """Tune each ``(kernel, shape, dtype)`` of ``specs`` that the cache
    misses into the in-process cache (and ``path`` if given); returns
    {key: TileConfig}."""
    st = _resolve()
    out = {}
    for kernel, shape, dtype in specs:
        key = key_for(kernel, shape, dtype)
        if key not in st["entries"]:
            st["entries"][key], _ = tune(kernel, shape, dtype)
        out[key] = st["entries"][key]
    st["resolved"] = {}
    if path is not None:
        save(path)
    return out


# ------------------------------------------------------- persistence / schema


def save(path: Optional[str] = None) -> str:
    st = _resolve()
    path = path or st["path"]
    data = {"version": CACHE_VERSION,
            "entries": {k: v._asdict()
                        for k, v in sorted(st["entries"].items())}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_cache(data: Any) -> list:
    """Schema check of a loaded cache: every key parses, the kernel and
    dtype are known, and the config is one of the candidates at its key's
    shape (the committed fixture is held to this)."""
    problems = []
    if not isinstance(data, dict):
        return [f"cache root must be an object, got {type(data).__name__}"]
    if data.get("version") != CACHE_VERSION:
        problems.append(f"version {data.get('version')!r} != {CACHE_VERSION}")
    entries = data.get("entries", {})
    if not isinstance(entries, dict):
        return problems + ["'entries' must be an object"]
    for key, v in entries.items():
        try:
            _, kernel, shape, dtype = parse_key(key)
        except ValueError as e:
            problems.append(str(e))
            continue
        if kernel not in KERNELS:
            problems.append(f"{key}: unknown kernel {kernel!r}")
            continue
        if len(shape) != SHAPE_DIMS[kernel]:
            problems.append(f"{key}: {kernel} takes a "
                            f"{SHAPE_DIMS[kernel]}-dim shape")
            continue
        if dtype not in DTYPES:
            problems.append(f"{key}: unknown dtype {dtype!r}")
            continue
        if not isinstance(v, dict) or set(v) != set(TileConfig._fields):
            problems.append(f"{key}: config fields must be "
                            f"{list(TileConfig._fields)}, got "
                            f"{sorted(v) if isinstance(v, dict) else v!r}")
            continue
        if not all(isinstance(x, int) and not isinstance(x, bool)
                   for x in v.values()):
            problems.append(f"{key}: config fields must be ints")
            continue
        cfg = TileConfig(**v)
        if cfg not in candidates(kernel, shape, dtype):
            problems.append(
                f"{key}: config {tuple(cfg)} outside the candidate space "
                f"for shape {shape}")
    return problems


# ------------------------------------------------------------------------ CLI


def _main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description="Tune-cache maintenance for the batched Hopper kernels.")
    sub = p.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("validate", help="schema-check a cache file")
    v.add_argument("--cache", default=DEFAULT_CACHE_PATH)
    t = sub.add_parser("tune", help="measure one (kernel, shape, dtype) on "
                                    "the card and write the winner into a "
                                    "cache file")
    t.add_argument("--kernel", required=True, choices=KERNELS)
    t.add_argument("--shape", required=True,
                   help="operand dims, e.g. 68x1024x64x768")
    t.add_argument("--dtype", default="float32", choices=list(DTYPES))
    t.add_argument("--cache", default=DEFAULT_CACHE_PATH)
    s = sub.add_parser("show", help="print the resolved entries")
    s.add_argument("--cache", default=None)
    args = p.parse_args(argv)

    if args.cmd == "validate":
        if not os.path.exists(args.cache):
            print(f"FAIL: no cache at {args.cache}")
            return 1
        with open(args.cache) as f:
            data = json.load(f)
        problems = validate_cache(data)
        for pr in problems:
            print(f"FAIL: {pr}")
        if not problems:
            print(f"tune cache OK: {len(data.get('entries', {}))} entries "
                  f"validated against the candidate space")
        return 1 if problems else 0

    if args.cmd == "tune":
        shape = tuple(int(x) for x in args.shape.split("x"))
        reload(path=args.cache, mode="force")
        best, table = tune(args.kernel, shape, args.dtype)
        key = key_for(args.kernel, shape, args.dtype)
        _resolve()["entries"][key] = best
        save(args.cache)
        for cfg, t_s in sorted(table.items(), key=lambda kv: kv[1]):
            mark = " <-- saved" if cfg == best else ""
            print(f"{dict(cfg._asdict())}: {t_s * 1e6:.1f} us{mark}")
        print(f"wrote {key} to {args.cache}")
        return 0

    if args.cache:
        reload(path=args.cache)
    for k, cfg in sorted(_resolve()["entries"].items()):
        print(f"{k}: {dict(cfg._asdict())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
