"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  All sources build at once, one ``nvcc`` each, in parallel,
on the first call to ``library``.  Outputs go to ``build/repro_torch/`` at
the repository root, named by a hash of the sources and flags, so an edited
source builds anew and an unchanged one is reused.  ``nvcc -Xptxas -v``
reports each kernel's registers, shared memory and spills; the build prints
that summary and keeps it beside the library (``resources`` parses it per
kernel).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points of each library: library -> {function: argtypes}
SIGNATURES = {
    "gram": {
        "repro_batched_gram": [_P, _P, _I, _I, _I, _I, _P],
        "repro_batched_gram_mixed": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "lowrank": {
        "repro_batched_lowrank_apply":
            [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "gram_tall": {
        "repro_gram_tall": [_P, _P, _P, _LL, _I, _I, _I, _LL, _P],
    },
    "lowrank_tall": {
        "repro_lowrank_tall":
            [_P, _P, _P, _P, _I, _P, _P, _P, _LL, _I, _I, _I, _LL, _P],
    },
    "project_quantize": {
        "repro_batched_project_quantize":
            [_P] * 7 + [_I] * 7 + [_P],
    },
    "flash": {
        "repro_flash_attention":
            [_P, _P, _P, _P] + [_LL] * 12 + [_I] * 9 + [_P],
    },
    "ssd": {
        "repro_ssd_scan": [_P] * 7 + [_I] * 7 + [_P],
    },
}


def resources(name: str) -> list:
    """Per kernel of library ``name``: (mangled name, registers, static
    shared memory bytes, spill store bytes, spill load bytes), as ``ptxas
    -v`` reported them when the library was built (its log beside it)."""
    log = _build_all()[name].with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    out = []
    for block in text.split("Compiling entry function")[1:]:
        fn = re.search(r"'([^']+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", block)
        spill = tuple(map(int, spills.groups())) if spills else (None, None)
        out.append((fn.group(1) if fn else "?",
                    int(regs.group(1)) if regs else None,
                    int(smem.group(1)) if smem else 0, *spill))
    return out


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def start_nvcc(source, out) -> subprocess.Popen:
    """``nvcc`` with the port's flags, started on ``source`` (a shared
    library to ``out``); its output, ptxas's report included, is read from
    the process's stdout."""
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                             str(source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@functools.lru_cache(maxsize=None)
def _build_all() -> dict:
    """Compile every ``csrc/*.cu`` that has no library yet; return paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    digest = _digest()
    outputs = {name: BUILD_DIR / f"{name}-{digest}.so" for name in SIGNATURES}
    jobs = {}
    for name, out in outputs.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs[name] = (start_nvcc(CSRC / f"{name}.cu", tmp), tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        print(f"[build] nvcc {name}.cu (exit {proc.returncode})")
        for line in log.splitlines():
            if proc.returncode != 0 or any(
                    w in line for w in ("ptxas", "spill", "warning")):
                print(f"[build]   {line.strip()}")
        if proc.returncode != 0:
            failed.append(name)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}; see the log above")
    return outputs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SIGNATURES``), with its
    entry points' ``argtypes``/``restype`` declared."""
    return load(_build_all()[name], name)


def load(path, name: str) -> ctypes.CDLL:
    """The shared library at ``path``, built from ``csrc/<name>.cu`` or an
    edited copy of it, with the entry points of ``SIGNATURES[name]``
    declared."""
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(fn, device: torch.device, *args) -> int:
    """Call the C entry point ``fn`` with ``args`` and the current stream of
    ``device`` last, with ``device`` current (made so for the call when it
    is not); returns its CUDA error code.  The stream comes from PyTorch's
    raw getter, which builds no Stream object (the launch-bound calls of
    the model's attention are host-bound)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream
    if index != current:
        with torch.cuda.device(index):
            return fn(*args, stream(index))
    return fn(*args, stream(index))


def build_all() -> None:
    """Build and load every kernel library (the chip smoke run's first
    phase)."""
    for name in SIGNATURES:
        library(name)
