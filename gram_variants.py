"""A/B builds of the batched Gram kernel (src/repro_torch/csrc/gram.cu) on
one NVIDIA card.

    python3 gram_variants.py

Each variant is the kernel's source with a few named text edits (VARIANTS),
built with the port's nvcc flags into build/gram_variants/ and called
through the port's own wrappers (kernels/gram/kernel.py), the library
swapped in.  For each, the script prints what ptxas reported (registers,
spills, serialized wgmma), the largest error against cuBLAS's f32 product
as a share of the tolerance the tests hold the Gram to (chip_smoke.py
tolerance_share) on two inputs, and the summed device time of one
refresh's 8 calls of each entry point at the main path's shapes
(chip_smoke.py main_path_shapes and cuda_ms), variants timed in turns.
The last two variants only time the kernel's two halves; their outputs are
wrong by design.  An edit that no longer applies to the source fails the
run: the variants describe the source as it is, and go with it when it is
rewritten.  Needs a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ref as gram_ref

OUT = Path(chip_smoke.ROOT) / "build" / "gram_variants"

# name -> [(file, old text, new text)]
VARIANTS = {
    "as is": [],
    # tf32 rounding by the conversion instruction, not by integer operations
    "cvt.rna": [("hopper.cuh",
                 "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : "
                 "\"f\"(x));\n  return r;")],
    # the tensor core accumulates over all of d; no promotion into the sum
    # (f32 and mixed stacks: their first product of a chunk is hi.lo)
    "no promotion": [
        ("gram.cu",
         "desc(b_lo + 32 * j),\n                           j > 0);",
         "desc(b_lo + 32 * j),\n                           1);"),
        ("gram.cu", "for (int i = 0; i < 64; ++i) sum[i] += acc[i];",
         "for (int i = 0; i < 64; ++i) sum[i] = acc[i];")],
    # a warp loads 8 rows of 16 columns (no column permutation needed)
    "8-row lane map": [
        ("gram.cu",
         "  const int quad = warp;\n  const int col = 4 * lane;\n"
         "  const int rot = (lane >> 1) & 3;",
         "  const int quad = lane & 7;\n"
         "  const int col = 16 * warp + 4 * (lane >> 3);\n"
         "  const int rot = 0;")],
    # a quarter-warp spans 4 depth quads and 2 column groups: its stores
    # land on 8 bank groups with no permutation, and a warp's loads still
    # cover 4 whole 128-byte lines
    "4-quad lane map": [
        ("gram.cu",
         "  const int quad = warp;\n  const int col = 4 * lane;\n"
         "  const int rot = (lane >> 1) & 3;",
         "  const int quad = 4 * (warp & 1) + (lane & 3);\n"
         "  const int col = 32 * (warp >> 1) + 4 * (lane >> 2);\n"
         "  const int rot = 0;")],
    # timing only (their outputs are wrong): the products with no staging of
    # later chunks, and the staging with no products
    "products only": [("gram.cu",
                       "    if (ch + 1 < chunks) {\n      store_unit",
                       "    if (false) {\n      store_unit")],
    "staging only": [("gram.cu",
                      "    issue<SPLIT>(acc, a_hi, a_lo, b_hi, b_lo);",
                      "    if (d < 0) issue<SPLIT>(acc, a_hi, a_lo, b_hi, "
                      "b_lo);")],
}


def _source(name: str, edits) -> Path:
    """A build directory holding gram.cu and its headers with ``edits``."""
    out = OUT / "".join(c if c.isalnum() else "_" for c in name)
    out.mkdir(parents=True, exist_ok=True)
    for f in ("gram.cu", "hopper.cuh", "tile.cuh"):
        text = (build.CSRC / f).read_text()
        for fe, old, new in edits:
            if fe == f:
                if old not in text:
                    raise RuntimeError(f"edit no longer applies to {f}: "
                                       f"{old!r}")
                text = text.replace(old, new)
        (out / f).write_text(text)
    return out


def _build() -> dict:
    """Every variant built at once, one nvcc each; name -> library."""
    procs = {}
    for name, edits in VARIANTS.items():
        lib = _source(name, edits) / "gram.so"
        procs[name] = (lib, build.start_nvcc(lib.with_suffix(".cu"), lib))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"nvcc failed for variant {name!r}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or \
                    "spill" in line or "C7511" in line or "C7518" in line:
                print(f"[{name}] {line.strip()[-120:]}")
        libs[name] = build.load(lib, "gram")
    return libs


def _as(lib):
    """The port's wrappers launching from ``lib`` instead of gram.cu."""
    return mock.patch.object(build, "library", lambda name: lib)


def main() -> int:
    if not torch.cuda.is_available():
        print("gram_variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = _build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for N, d, k, mean in [(8, 768, 1088, 0.0), (8, 1024, 832, 3.0)]:
        a = torch.randn(N, d, k, generator=gen, device=dev) + mean
        want = gram_ref.batched_gram_ref(a)
        shares = []
        for name, lib in libs.items():
            with _as(lib):
                got = gram_kernel.batched_gram(a)
            shares.append(f"{name} "
                          f"{chip_smoke.tolerance_share(got, want, d)[1]:.3f}")
        print(f"error / tolerance, batched_gram {(N, d, k)} mean {mean}: "
              + ", ".join(shares))
    refresh, _ = chip_smoke.main_path_shapes()
    dense = dict.fromkeys(libs, 0.0)
    mixed = dict.fromkeys(libs, 0.0)
    for N, d, ell, r in refresh:
        a = torch.randn(N, d, ell + r, generator=gen, device=dev)
        vq = torch.randint(-127, 128, (N, d, ell), generator=gen, device=dev,
                           dtype=torch.int8)
        colw = torch.rand(N, ell, generator=gen, device=dev) / 127
        am = torch.randn(N, d, r, generator=gen, device=dev)
        for name, lib in list(libs.items()) + list(libs.items())[::-1]:
            with _as(lib):
                dense[name] += chip_smoke.cuda_ms(
                    lambda: gram_kernel.batched_gram(a), 5) / 2
                mixed[name] += chip_smoke.cuda_ms(
                    lambda: gram_kernel.batched_gram_mixed(vq, colw, am),
                    5) / 2
    for name in libs:
        print(f"one refresh, {name}: batched_gram {dense[name]:.4f} ms, "
              f"batched_gram_mixed {mixed[name]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
