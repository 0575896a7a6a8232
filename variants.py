"""A/B builds of a hand-written kernel on one NVIDIA card.

    python3 variants.py gram     # csrc/gram.cu: the batched Grams
    python3 variants.py apply    # csrc/lowrank.cu: the batched apply

Each variant is the kernel's source with a few named text edits (a table
below per kernel), built with the port's nvcc flags into
build/variants/<kernel>/ and called through the port's own wrappers, the
library swapped in.  For each, the script prints what ptxas reported
(registers, spills, serialized wgmma), the largest error against the plain
f32 version as a share of the tolerance the tests hold the kernel to
(chip_smoke.py tolerance_share), and the summed device time of one main
path's calls at the main path's shapes (chip_smoke.py main_path_shapes and
cuda_ms), variants timed in turns:

  gram   two inputs' errors (rows of mean 0 and 3); one refresh's 8 calls
         of batched_gram and of batched_gram_mixed.
  apply  errors on G of mean 3 with an f32 and an int8 U (the latter
         through the registry's scale-folded entry); one training step's 8
         calls with each U.

Variants marked "timing only" leave out or redirect one part of the work,
so their outputs may be wrong by design: they say what that part costs.
An edit that no longer applies to the source fails the run: the variants
describe the source as it is, and go with it when it is rewritten.  Needs
a CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from unittest import mock

import torch

import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels import registry
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import kernel as lowrank_kernel
from repro_torch.kernels.lowrank import ref as lowrank_ref

OUT = Path(chip_smoke.ROOT) / "build" / "variants"

# name -> [(file, old text, new text)]
GRAM = {
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
    # timing only: the products with no staging of later chunks, and the
    # staging with no products
    "products only": [("gram.cu",
                       "    if (ch + 1 < chunks) {\n      store_unit",
                       "    if (false) {\n      store_unit")],
    "staging only": [("gram.cu",
                      "    issue<SPLIT>(acc, a_hi, a_lo, b_hi, b_lo);",
                      "    if (d < 0) issue<SPLIT>(acc, a_hi, a_lo, b_hi, "
                      "b_lo);")],
}

APPLY = {
    "as is": [],
    # G's (d, bn) column tile kept in shared memory, read from device memory
    # once: the stages hold U alone, bn 32 where d 1024 fits (one block an
    # SM), narrower at larger d
    "G staged once": [
        ("lowrank.cu",
         "  const int first = kRows1 * (usize == 4 ? kEll + 8 : kEll + 16) "
         "* usize +\n                    kRows1 * g_stride(bn) * 4;\n"
         "  const int second = kRows2 * (usize == 4 ? kEll + 8 : kEll + 16) "
         "* usize +\n                     kRows2 * g_stride(bn) * 4;",
         "  const int first = kRows1 * (usize == 4 ? kEll + 8 : kEll + 16) "
         "* usize;\n"
         "  const int second = kRows2 * (usize == 4 ? kEll + 8 : kEll + 16) "
         "* usize;"),
        ("lowrank.cu",
         "size_t smem_bytes(int ell, int bn, int usize) {",
         "size_t smem_bytes(int ell, int bn, int usize, int d) {"),
        ("lowrank.cu",
         "         2ull * 4 * cols * p_stride(bn);",
         "         2ull * 4 * cols * p_stride(bn) +\n"
         "         4ull * ((d + kRows2 - 1) / kRows2 * kRows2) * "
         "g_stride(bn);"),
        ("lowrank.cu", "sizeof(TU)) <= kMaxSmem", "sizeof(TU), d) <= "
         "kMaxSmem"),
        ("lowrank.cu", "smem_bytes(ell, 8 * NT, sizeof(TU));",
         "smem_bytes(ell, 8 * NT, sizeof(TU), d);"),
        ("lowrank.cu", "__launch_bounds__(kThreads, 2)",
         "__launch_bounds__(kThreads, 1)"),
        ("lowrank.cu",
         "  uint32_t* pl = ph + groups * kEll * PS;  // P's hi and lo, "
         "[ell / 2][PS][2]",
         "  uint32_t* pl = ph + groups * kEll * PS;  // P's hi and lo, "
         "[ell / 2][PS][2]\n"
         "  float* gk = reinterpret_cast<float*>(pl + groups * kEll * PS);"),
        ("lowrank.cu",
         "      copy_g(reinterpret_cast<float*>(sk + kRows1 * US * "
         "sizeof(TU)),\n             ch * kRows1, kRows1);",
         "      if (gi == 0) copy_g(gk + ch * kRows1 * GS, ch * kRows1, "
         "kRows1);"),
        ("lowrank.cu",
         "      if (gi == groups - 1) {  // the epilogue's G, read a second "
         "time\n        copy_g(reinterpret_cast<float*>(sk + kRows2 * US * "
         "sizeof(TU)),\n               ch * kRows2, kRows2);\n      }\n", ""),
        ("lowrank.cu",
         "      const float* sg =\n          reinterpret_cast<const float*>"
         "(sk + kRows1 * US * sizeof(TU));",
         "      const float* sg = gk + ch * kRows1 * GS;"),
        ("lowrank.cu",
         "        const float* sg =\n            reinterpret_cast<const "
         "float*>(sk + kRows2 * US * sizeof(TU));",
         "        const float* sg = gk + ch * kRows2 * GS;")],
    # one more unit in flight: an f32 U's stages then leave room for one
    # block an SM, an int8 U's for two
    "3 stages": [("lowrank.cu", "constexpr int kStages = 2;",
                  "constexpr int kStages = 3;")],
    # hi.hi alone: one tf32 product a multiply-add (accuracy)
    "one tf32 product": [("lowrank.cu",
                          "  mma_tf32(acc, a_hi, b_lo);\n"
                          "  if (!EXACT) mma_tf32(acc, a_lo, b_hi);\n", "")],
    # timing only: no copies after the first units
    "no copies": [("lowrank.cu",
                   "    if (k + kStages - 1 < units) "
                   "issue(k + kStages - 1);", "")],
    # timing only: the second product's units do not read G again
    "no second read of G": [("lowrank.cu",
                             "      if (gi == groups - 1) {  // the "
                             "epilogue's G, read a second time",
                             "      if (false) {")],
    # timing only: the second read of G goes to a copy of G that nothing
    # has read (the script's G has a second copy past its end), so it
    # cannot hit L2; against "as is" it says what L2 saves that read
    "second read of G cold": [
        ("lowrank.cu", "auto copy_g = [&](float* sg, int r0, int rows) {",
         "auto copy_g = [&](float* sg, int r0, int rows, const float* gn) {"),
        ("lowrank.cu", "             ch * kRows1, kRows1);",
         "             ch * kRows1, kRows1, gn);"),
        ("lowrank.cu", "               ch * kRows2, kRows2);",
         "               ch * kRows2, kRows2,\n"
         "               gn + gridDim.y * static_cast<long long>(d) * m);")],
    # timing only: no tensor-core products (a cheap use of the operands)
    "no products": [("lowrank.cu", '  asm("mma.sync.aligned.m16n8k8',
                     "  d[0] += __uint_as_float(a[0] ^ b[0]);\n"
                     "  d[1] += __uint_as_float(a[1] ^ b[1]);\n"
                     '  if (false) asm("mma.sync.aligned.m16n8k8')],
    # timing only: operands not split (hi = lo = the f32 bits)
    "no split": [("lowrank.cu",
                  "    hi[i] = repro::tf32_rna(x[i]);\n"
                  "    lo[i] = repro::tf32_rna(x[i] - "
                  "__uint_as_float(hi[i]));",
                  "    hi[i] = __float_as_uint(x[i]);\n"
                  "    lo[i] = __float_as_uint(x[i]);")],
}


def _source(out: Path, files: tuple, edits) -> None:
    """``files`` of csrc/ with ``edits`` into the directory ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    for f in files:
        text = (build.CSRC / f).read_text()
        for fe, old, new in edits:
            if fe == f:
                if old not in text:
                    raise RuntimeError(f"edit no longer applies to {f}: "
                                       f"{old!r}")
                text = text.replace(old, new)
        (out / f).write_text(text)


def _build(lib: str, files: tuple, variants: dict) -> dict:
    """Every variant of csrc/<lib>.cu built at once, one nvcc each; name ->
    library."""
    procs = {}
    for name, edits in variants.items():
        out = OUT / lib / "".join(c if c.isalnum() else "_" for c in name)
        _source(out, files, edits)
        so = out / f"{lib}.so"
        procs[name] = (so, build.start_nvcc(out / f"{lib}.cu", so))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"nvcc failed for variant {name!r}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or \
                    ("spill" in line and " 0 bytes spill" not in line) or \
                    "C7511" in line or "C7518" in line:
                print(f"[{name}] {line.strip()[-120:]}")
        libs[name] = build.load(so, lib)
    return libs


def _in_turns(libs: dict, calls: dict) -> dict:
    """Summed over ``calls`` (label -> fn), each variant's ``cuda_ms`` with
    its library swapped in, variants in turns (forward, then backward);
    label -> name -> ms."""
    ms = {label: dict.fromkeys(libs, 0.0) for label in calls}
    for name, lib in list(libs.items()) + list(libs.items())[::-1]:
        with mock.patch.object(build, "library", lambda _, lib=lib: lib):
            for label, fn in calls.items():
                ms[label][name] += chip_smoke.cuda_ms(fn, 5) / 2
    return ms


def _gram(libs: dict, dev, gen) -> None:
    for N, d, k, mean in [(8, 768, 1088, 0.0), (8, 1024, 832, 3.0)]:
        a = torch.randn(N, d, k, generator=gen, device=dev) + mean
        want = gram_ref.batched_gram_ref(a)
        shares = []
        for name, lib in libs.items():
            with mock.patch.object(build, "library", lambda _: lib):
                got = gram_kernel.batched_gram(a)
            shares.append(f"{name} "
                          f"{chip_smoke.tolerance_share(got, want, d)[1]:.3f}")
        print(f"error / tolerance, batched_gram {(N, d, k)} mean {mean}: "
              + ", ".join(shares))
    refresh, _ = chip_smoke.main_path_shapes()
    total = {"batched_gram": dict.fromkeys(libs, 0.0),
             "batched_gram_mixed": dict.fromkeys(libs, 0.0)}
    for N, d, ell, r in refresh:
        a = torch.randn(N, d, ell + r, generator=gen, device=dev)
        vq = torch.randint(-127, 128, (N, d, ell), generator=gen, device=dev,
                           dtype=torch.int8)
        colw = torch.rand(N, ell, generator=gen, device=dev) / 127
        am = torch.randn(N, d, r, generator=gen, device=dev)
        ms = _in_turns(libs, {
            "batched_gram": lambda: gram_kernel.batched_gram(a),
            "batched_gram_mixed":
                lambda: gram_kernel.batched_gram_mixed(vq, colw, am)})
        for label in total:
            for name in libs:
                total[label][name] += ms[label][name]
    for name in libs:
        print(f"one refresh, {name}: batched_gram "
              f"{total['batched_gram'][name]:.4f} ms, batched_gram_mixed "
              f"{total['batched_gram_mixed'][name]:.4f} ms")


def _apply_inputs(N: int, d: int, ell: int, n: int, gen, dev, mean: float):
    """(u, vq, scale, g, c, b); g is the first half of a buffer holding it
    twice (the cold-read variant reads the second half)."""
    u = torch.randn(N, d, ell, generator=gen, device=dev)
    vq = torch.randint(-127, 128, (N, d, ell), generator=gen, device=dev,
                       dtype=torch.int8)
    scale = torch.rand(N, 1, 1, generator=gen, device=dev) / 127
    g = torch.randn(N, d, n, generator=gen, device=dev) + mean
    g = torch.cat([g, g])[:N]
    c = torch.rand(N, ell, generator=gen, device=dev)
    b = torch.rand(N, generator=gen, device=dev)
    return u, vq, scale, g, c, b


def _apply(libs: dict, dev, gen) -> None:
    _, apply_main = chip_smoke.main_path_shapes()
    N, d, ell, n = apply_main[0]
    u, vq, scale, g, c, b = _apply_inputs(N, d, ell, n, gen, dev, 3.0)
    want = lowrank_ref.batched_lowrank_apply_ref(u, c, b, g)
    want8 = lowrank_ref.batched_lowrank_apply_quantized_ref(vq, scale, c, b,
                                                            g)
    shares = []
    for name, lib in libs.items():
        with mock.patch.object(build, "library", lambda _: lib):
            got = lowrank_kernel.batched_lowrank_apply(u, c, b, g)
            got8 = registry.batched_lowrank_apply_quantized(vq, scale, c, b,
                                                            g)
        shares.append(f"{name} "
                      f"{chip_smoke.tolerance_share(got, want, d)[1]:.3f} / "
                      f"{chip_smoke.tolerance_share(got8, want8, d)[1]:.3f}")
    print(f"error / tolerance (f32 / int8 U), batched_lowrank_apply "
          f"{(N, d, ell, n)}, G of mean 3: " + ", ".join(shares))
    del u, vq, g, want, want8
    total = {"f32": dict.fromkeys(libs, 0.0), "int8": dict.fromkeys(libs, 0.0)}
    for N, d, ell, n in apply_main:
        u, vq, scale, g, c, b = _apply_inputs(N, d, ell, n, gen, dev, 0.0)
        ms = _in_turns(libs, {
            "f32": lambda: lowrank_kernel.batched_lowrank_apply(u, c, b, g),
            "int8": lambda: registry.batched_lowrank_apply_quantized(
                vq, scale, c, b, g)})
        for label in total:
            for name in libs:
                total[label][name] += ms[label][name]
    for name in libs:
        print(f"one step, {name}: f32 U {total['f32'][name]:.4f} ms, int8 U "
              f"{total['int8'][name]:.4f} ms")


# kernel -> (library, its sources, variants, the script's calls)
KERNELS = {
    "gram": ("gram", ("gram.cu", "hopper.cuh", "tile.cuh"), GRAM, _gram),
    "apply": ("lowrank", ("lowrank.cu", "hopper.cuh"), APPLY, _apply),
}


def main(argv: list) -> int:
    if len(argv) != 1 or argv[0] not in KERNELS:
        print(f"usage: python3 variants.py {{{','.join(KERNELS)}}}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, files, variants, run = KERNELS[argv[0]]
    libs = _build(lib, files, variants)
    dev = torch.device("cuda", 0)
    run(libs, dev, torch.Generator(device=dev).manual_seed(0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
