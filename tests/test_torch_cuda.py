"""The hand-written Hopper kernels against their plain PyTorch versions, on
the card.  Every test here is marked ``cuda`` and skips on a host without
one; the file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: f32 ``atol = 1e-4 * sqrt(d)``,
``rtol = 1e-5``; bf16 inputs (Gram only) 10x that.  The single-block Gram
and apply (split over d) take f32, bf16 and fp16 and are held to the same
tolerances (a half-precision apply result also one rounding step of its
dtype), and two runs on the same inputs must give the same bits: their
partial sums are added in a fixed order.  The batched Grams (kernels 1 and 5,
3xTF32 on the tensor cores) keep the f32 tolerance, give the same bits on
two runs, and the mixed one weights its output inside the kernel.  So does
the batched apply (kernels 2 and 2', one pass in 3xTF32), held also at its
column tile's edges and on G of mean 3, and it allocates nothing but its
output.  The int8 write-back's
scales agree to ``rtol = 1e-5`` (the absmax of U_new summed in another
order), and a value may differ by 1, only where the plain version's
U_new / scale lies within 1e-3 of a step of a .5 boundary (a few hundred
ulp at the int8 range's top: the kernel sums the k + r products in another
order).

The flash attention kernel (kernel 7) and the SSD chunk scan (kernel 8) are
held to the tolerances of the reference's own sweeps
(tests/test_kernels.py:210 and :230): against the plain version on the
f32 upcast inputs, attention ``atol = 2e-5`` in f32 and 0.05 in bf16, the
scan ``atol = 5e-6 * S`` in f32 and 0.15 in bf16.  Both kernels' sums run
in a fixed order, so two runs give the same bits (the scan's cases cross
the seams of its three phases: one, two and 17 chunks, a ragged last
chunk, Q < 16, head counts no multiple of its head tile).  Their gradients (the
plain version differentiated, ``kernels/*/ops.py``) match autograd of the
plain version on the card to ``rtol = 1e-5, atol = 1e-6``: the same
backward on forwards that differ by the kernel's rounding.  The bf16
attention kernel (``wgmma``) is also held at its own edges (every head dim,
sequences that fill no tile, Sk != S, one KV head, more blocks than SMs) to
a relative error of the whole output of 1e-2 beside the atol, and raises on
a view that is not 16-byte aligned.

Past the limits of a 2-D grid (one launch each): kernels 1, 2, 2', 5 and 6
at 66,536 blocks of d 16, k 8, and kernel 8 at 70,000 batch rows, at the
tolerances above; kernel 7 causal with S != Sk (aligned at the end as
``attention_ref``; rows that see no key are the mean of V) and at head dims
8, 40, 72, 100, 144, 200 and 240 (GQA and MHA), both dtypes.

Past the old capacity limits (every shape and dtype the reference takes),
each call one launch of its wrapper and the same bits twice: kernel 8 at
P 8, 48, 128 and 192 (slices of P) with N 1, 96, 256 and 384 (chunks of
N) over three chunks of 16 in f32, bf16 and fp16, and in fp16 at the
sweep's shapes; kernel 7 past hd 256 (the wide kernel: 264, 320, 512, GQA
and MHA, causal and not, in f32, bf16 and fp16) and in fp16 at every
FLASH_CASES shape and head dim 8 to 240 (atol 0.05 and 1e-2 in norm, as
bf16); kernels 2 and 2' at ell 1,985, 2,100 and 4,000 (chunks of U's
columns, U scaled by 1 / sqrt(ell)); kernel 4 at ell 1,025, 4,096 and
8,192 (227 KB of shared memory, then chunks) in f32, bf16 and fp16; kernel
1 in fp16 at GRAM_CASES (bf16's tolerance).  The reduced paper-lm-100m,
zamba2-7b, mamba2-370m and deepseek-moe-16b at float16 with the "dots"
remat policy and bf16 attention logits on the card against the CPU,
through chip_smoke.py's phase 8d (its kernels 7 and 8 launched in fp16).

The sharded statistics: kernel 1 at the butterfly merge's Gram shapes (k
126 and 22) and the shrink merge's (k 128 and 24) against its plain
version, and the FD merge and ``merge_sketches_on_shrink`` on the card
against the CPU (covariance, ladder and rho within 1e-4 of the largest
eigenvalue).

The paper's baselines: kernel 1 at the seven shapes of Shampoo's per-step
L and R Grams at full width (data of mean 3, the f32 tolerance), and two
reduced training steps of Shampoo and of Adam through the launcher on the
card against the CPU from the same weights (losses ``rtol=1e-4``,
parameters ``rtol=1e-3, atol=1e-4``), with their kernels' launch counts.

The refresh modes and the rank budget: the masked FD refresh (kernel 1, or
kernels 5 and 6 on int8 eigenvectors) and one staggered sub-stack refresh
of the engine against the same work through the plain versions on the
card (ladders ``rtol=1e-4`` plus 1e-4 of the largest eigenvalue;
covariances ``U diag(s) U^T``, never raw U, within 1e-4 of their largest
magnitude, two int8 steps under int8; the columns past a block's rank and
the blocks not due untouched), and the async engine's committed state
against the inline engine's after each of 6 steps, bit for bit.

The dense configs with one feature each, the moe configs and the vlm and
audio configs (reduced, on their own inputs: embeddings, or tokens of 4
codebooks): logits, a teacher-forced decode and one Sketchy step on the
card against the CPU, through chip_smoke.py's phase 8c (one
implementation for both).  Flash attention also at gemma-2b's head dim
256, at qwen2-vl-72b's (GQA 64/8, hd 128) and musicgen-large's (MHA
32/32, hd 64) full-width training shapes, and at deepseek-moe-16b's
expert-parallel shape (B 4, 16 heads, S 512, hd 128).

Checkpoints: the reduced model's fp32 and int8 states saved and restored
on the card bit for bit, and the next step from the restored state bit for
bit the live state's (or within the difference of that step run twice).

The autotuner (kernels/autotune.py): every candidate of kernels 2, 2' and
6 (the apply's column tiles, the write-back's block counts) against the
plain version at the main path's shapes and ragged ones, at the kernels'
tolerances above; an explicit column tile reaches csrc/lowrank.cu (a
tile the C entry does not take returns cudaErrorInvalidValue, a tile
whose shared memory does not fit too, the default 0 gives the widest
tile's bits); the registry passes a config through.  A microbatched
training step (4 microbatches, reduced model, f32, Sketchy) on the card
against the CPU from the same weights (losses ``rtol=1e-4``, parameters
``rtol=1e-3, atol=1e-4``), with kernel 7's launches four times the
whole batch's.
"""
import numpy as np
import pytest
import torch
from torch_parity import chip_smoke

from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import ref as lowrank_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ALL_DTYPES = dict(DTYPES, float16=torch.float16)


def _tol(d: int, dtype: str) -> dict:
    scale = 1 if dtype == "float32" else 10
    return dict(atol=1e-4 * np.sqrt(d) * scale, rtol=1e-5 * scale)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


GRAM_CASES = [(1, 16, 4), (3, 20, 6), (5, 100, 30), (7, 33, 9), (2, 12, 780),
              (2, 768, 76), (48, 768, 832),
              # the 128-wide tile's edges, d no multiple of the 32-row
              # chunk, N = 1, and the largest main-path shape
              (1, 33, 127), (2, 1000, 128), (1, 100, 129), (1, 1000, 1088),
              (104, 768, 1088)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,k,mean", [(*c, 0.0) for c in GRAM_CASES] + [
    # entries of mean 3: without the promotion of the tensor core's
    # accumulator every 32-row chunk, 3xTF32 misses the tolerance here
    (8, 1024, 832, 3.0)])
@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_gram_kernel_matches_plain_on_card(card, N, d, k, mean, dtype):
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(d)
    a = (torch.randn(N, d, k, generator=gen, device=card)
         + mean).to(ALL_DTYPES[dtype])
    before = kernel.launches
    got = kernel.batched_gram(a)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(got, gram_ref.batched_gram_ref(a),
                               **_tol(d, dtype))


# (N, d, ell, n) of the batched apply: ragged shapes, then the main path's;
# then its tiles' edges (m no multiple of the column tile, d 1000, 1400 and
# 3000 no multiple of its units, ell 12 and 17, ell over one 64-column
# group, N 1; ell 300, 700 and 1300, whose P takes the narrower column
# tiles of 32, 16 and 8 with an f32 U, and with an int8 one 64, 16 and 8)
APPLY_CASES = [(1, 32, 4, 8), (3, 24, 6, 10), (7, 123, 17, 50),
               (2, 12, 12, 768), (2, 768, 64, 12), (48, 768, 64, 768),
               (1, 1000, 17, 45), (2, 1000, 12, 33), (1, 12, 12, 100),
               (2, 1400, 64, 40), (1, 3000, 64, 20), (2, 300, 130, 70),
               (1, 200, 300, 40), (1, 100, 700, 24), (1, 60, 1300, 20),
               (1, 1024, 64, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,ell,n,mean", [(*c, 0.0) for c in APPLY_CASES]
                         + [(68, 1024, 64, 768, 3.0)])
def test_lowrank_kernel_matches_plain_on_card(card, N, d, ell, n, mean):
    """f32, the one dtype of G the apply kernel takes; G of mean 3 at a main
    path shape too, where the 3xTF32 products' sums are large."""
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(d)
    u = torch.randn(N, d, ell, generator=gen, device=card)
    g = torch.randn(N, d, n, generator=gen, device=card) + mean
    coeffs = torch.rand(N, ell, generator=gen, device=card)
    base = torch.rand(N, generator=gen, device=card)
    before = kernel.launches
    got = kernel.batched_lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    torch.testing.assert_close(
        got, lowrank_ref.batched_lowrank_apply_ref(u, coeffs, base, g),
        **_tol(d, "float32"))


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(card):
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.lowrank import kernel as lowrank_kernel
    a = torch.zeros(2, 8, 4, device=card)
    with pytest.raises(TypeError):
        gram_kernel.batched_gram(a.double())
    with pytest.raises(ValueError, match="contiguous"):
        gram_kernel.batched_gram(a.mT)
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernel.batched_gram(a.cpu())
    u, g = torch.zeros(2, 8, 3, device=card), torch.zeros(2, 8, 5, device=card)
    c, b = torch.zeros(2, 3, device=card), torch.zeros(2, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lowrank_kernel.batched_lowrank_apply(u, c, b, g.mT.contiguous().mT)
    with pytest.raises(TypeError, match="float32"):
        lowrank_kernel.batched_lowrank_apply(u.bfloat16(), c, b,
                                             g.bfloat16())
    with pytest.raises(ValueError, match="ell"):
        lowrank_kernel.batched_lowrank_apply(
            torch.zeros(2, 8, 0, device=card),
            torch.zeros(2, 0, device=card), b, g)


# (N, d, ell, r): ragged, then the main path's shapes (left and right side
# of each full-width pool group at rank 64)
INT8_CASES = [(1, 16, 4, 1), (3, 20, 12, 5), (2, 12, 12, 30), (5, 100, 30, 2),
              (4, 70, 12, 1), (2, 12, 12, 768), (2, 768, 64, 12),
              (48, 768, 64, 768), (68, 1024, 64, 768), (104, 768, 64, 1024),
              # the write-back's 128-row blocks and 32-deep panels: d no
              # multiple of 128, r no multiple of 32, k and r no multiple of
              # the 16-byte vector (scalar loads), e = k over 64 (two column
              # blocks)
              (3, 200, 64, 40), (2, 1000, 64, 50), (2, 200, 12, 45),
              (2, 130, 80, 20)]


def _int8(n, d, k, gen, card):
    return torch.randint(-127, 128, (n, d, k), generator=gen, device=card,
                         dtype=torch.int8)


# the mixed Gram's own edges: k + r across the 128-wide tile (127, 128,
# 129, 1088), d no multiple of the 32-row chunk, N = 1, and ell or r no
# multiple of 4 (element-by-element loads, a 4-column group across ell)
GRAM_MIXED_EDGES = [(1, 33, 64, 63), (2, 1000, 64, 64), (1, 100, 12, 117),
                    (1, 1000, 64, 1024), (2, 40, 10, 30), (3, 70, 12, 45)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,ell,r,mean", [
    (*c, 0.0) for c in INT8_CASES + GRAM_MIXED_EDGES] + [
    # A of mean 3, as the f32 Gram's case of that mean
    (8, 1024, 64, 768, 3.0)])
def test_gram_mixed_kernel_matches_plain_on_card(card, N, d, ell, r, mean):
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(d + ell)
    vq = _int8(N, d, ell, gen, card)
    colw = torch.rand(N, ell, generator=gen, device=card) / 127
    a = torch.randn(N, d, r, generator=gen, device=card) + mean
    before = kernel.mixed_launches
    got = kernel.batched_gram_mixed(vq, colw, a)
    torch.cuda.synchronize()
    assert kernel.mixed_launches == before + 1
    torch.testing.assert_close(got, gram_ref.batched_gram_mixed_ref(vq, colw,
                                                                    a),
                               **_tol(d, "float32"))


@pytest.mark.cuda
def test_gram_kernels_give_the_same_bits_twice(card):
    """One block owns each output tile over all of d: no atomics, no split,
    so two calls on the same input agree bit for bit."""
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(5)
    a = torch.randn(68, 1024, 832, generator=gen, device=card)
    assert torch.equal(kernel.batched_gram(a), kernel.batched_gram(a))
    vq = _int8(104, 768, 64, gen, card)
    colw = torch.rand(104, 64, generator=gen, device=card) / 127
    a = torch.randn(104, 768, 1024, generator=gen, device=card)
    assert torch.equal(kernel.batched_gram_mixed(vq, colw, a),
                       kernel.batched_gram_mixed(vq, colw, a))


@pytest.mark.cuda
def test_gram_mixed_weights_in_the_kernel(card):
    """The column weights are applied in the kernel's epilogue: one launch,
    and nothing allocated beyond the (N, k + r, k + r) output."""
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(6)
    N, d, ell, r = 48, 768, 64, 768
    vq = _int8(N, d, ell, gen, card)
    colw = torch.rand(N, ell, generator=gen, device=card) / 127
    a = torch.randn(N, d, r, generator=gen, device=card)
    kernel.batched_gram_mixed(vq, colw, a)     # build and load first
    torch.cuda.synchronize()
    before = kernel.mixed_launches
    torch.cuda.reset_peak_memory_stats(card)
    held = torch.cuda.memory_allocated(card)
    got = kernel.batched_gram_mixed(vq, colw, a)
    torch.cuda.synchronize()
    assert kernel.mixed_launches == before + 1
    out_bytes = -(-N * (ell + r) ** 2 * 4 // 512) * 512   # allocator blocks
    assert torch.cuda.max_memory_allocated(card) - held <= out_bytes
    torch.testing.assert_close(got, gram_ref.batched_gram_mixed_ref(vq, colw,
                                                                    a),
                               **_tol(d, "float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gram_kernels_take_unaligned_stacks(card, dtype):
    """A contiguous stack whose base is not 16-byte aligned (a view at an
    odd offset) takes the element-by-element loads."""
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(7)
    N, d, k = 3, 70, 132
    flat = torch.randn(N * d * k + 1, generator=gen, device=card)
    a = flat.to(DTYPES[dtype])[1:].view(N, d, k)
    assert a.data_ptr() % 8 != 0
    torch.testing.assert_close(kernel.batched_gram(a),
                               gram_ref.batched_gram_ref(a), **_tol(d, dtype))
    if dtype == "float32":
        vq = torch.randint(-127, 128, (N * d * 12 + 1,), generator=gen,
                           device=card, dtype=torch.int8)[1:].view(N, d, 12)
        colw = torch.rand(N, 12, generator=gen, device=card) / 127
        torch.testing.assert_close(
            kernel.batched_gram_mixed(vq, colw, a),
            gram_ref.batched_gram_mixed_ref(vq, colw, a),
            **_tol(d, "float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,k,r", INT8_CASES)
def test_project_quantize_kernel_matches_plain_on_card(card, N, d, k, r):
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(d + k)
    vq = _int8(N, d, k, gen, card)
    w_top = torch.randn(N, k, k, generator=gen, device=card) / 127
    a = torch.randn(N, d, r, generator=gen, device=card)
    w_bot = torch.randn(N, r, k, generator=gen, device=card)
    before = kernel.project_quantize_launches
    got = kernel.batched_project_quantize(vq, w_top, a, w_bot)
    torch.cuda.synchronize()
    assert kernel.project_quantize_launches == before + 1
    lowrank_ref.project_quantize_differences(got, vq, w_top, a, w_bot)


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,ell,n,mean", [(*c, 0.0) for c in APPLY_CASES]
                         + [(68, 1024, 64, 768, 3.0)])
def test_int8_apply_kernel_matches_plain_on_card(card, N, d, ell, n, mean):
    from repro_torch.kernels import registry
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(d + 1)
    vq = _int8(N, d, ell, gen, card)
    scale = torch.rand(N, 1, 1, generator=gen, device=card) / 127
    coeffs = torch.rand(N, ell, generator=gen, device=card)
    base = torch.rand(N, generator=gen, device=card)
    g = torch.randn(N, d, n, generator=gen, device=card) + mean
    before = (kernel.launches, kernel.int8_launches)
    got = registry.batched_lowrank_apply_quantized(vq, scale, coeffs, base, g)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.int8_launches) == \
        (before[0], before[1] + 1)
    torch.testing.assert_close(
        got, lowrank_ref.batched_lowrank_apply_quantized_ref(
            vq, scale, coeffs, base, g), **_tol(d, "float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype", ["float32", "int8"])
def test_apply_kernel_gives_the_same_bits_and_no_scratch(card, u_dtype):
    """At a main-path shape: two calls give the same bits (no split over d,
    no atomics), and a call allocates its output and nothing else (the
    one-pass kernel has no (N, ell, m) scratch)."""
    from repro_torch.kernels.lowrank import kernel
    N, d, ell, n = 68, 1024, 64, 768
    gen = torch.Generator(device=card).manual_seed(17)
    u = (_int8(N, d, ell, gen, card) if u_dtype == "int8"
         else torch.randn(N, d, ell, generator=gen, device=card))
    g = torch.randn(N, d, n, generator=gen, device=card)
    coeffs = torch.rand(N, ell, generator=gen, device=card) / 127 ** 2
    base = torch.rand(N, generator=gen, device=card)
    got = kernel.batched_lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    del got
    torch.cuda.reset_peak_memory_stats(card)
    before = torch.cuda.memory_allocated(card)
    got = kernel.batched_lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(card) - before <= \
        got.numel() * got.element_size()
    again = kernel.batched_lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_int8_wrappers_reject_what_they_do_not_take(card):
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.lowrank import kernel as lowrank_kernel
    vq = torch.zeros(2, 8, 3, dtype=torch.int8, device=card)
    a = torch.zeros(2, 8, 4, device=card)
    with pytest.raises(TypeError, match="int8"):
        gram_kernel.batched_gram_mixed(vq.float(), torch.zeros(2, 3,
                                                               device=card), a)
    with pytest.raises(ValueError, match="contiguous"):
        gram_kernel.batched_gram_mixed(vq, torch.zeros(2, 3, device=card),
                                       a.mT.contiguous().mT)
    w_top = torch.zeros(2, 3, 3, device=card)
    w_bot = torch.zeros(2, 4, 3, device=card)
    with pytest.raises(TypeError, match="float32"):
        lowrank_kernel.batched_project_quantize(vq, w_top.double(), a, w_bot)
    with pytest.raises(ValueError, match="shape"):
        lowrank_kernel.batched_project_quantize(vq, w_top, a,
                                                w_bot[:, :2].contiguous())
    v, s = lowrank_kernel.batched_project_quantize(vq[:0], w_top[:0], a[:0],
                                                   w_bot[:0])
    assert v.shape == (0, 8, 3) and s.shape == (0, 1, 1)


SINGLE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _single_tol(d: int, dtype: str) -> dict:
    return _tol(d, "float32" if dtype == "float32" else "bfloat16")


# (d, k): ragged, the rows path's bounds (k = 1, 16), the tiled path
# (k = 17, 30, 300), and tall ones (the serving shape's k = 9)
GRAM_SINGLE = [(1, 1), (33, 9), (100, 16), (100, 17), (70, 30), (513, 300),
               (4096, 9), (1_000_003, 9), (25_165_824, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", GRAM_SINGLE)
@pytest.mark.parametrize("dtype", list(SINGLE))
def test_single_gram_kernel_matches_plain_on_card(card, d, k, dtype):
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(d + k)
    a = torch.randn(d, k, generator=gen, device=card).to(SINGLE[dtype])
    before = kernel.single_launches
    got = kernel.gram(a)
    again = kernel.gram(a)
    torch.cuda.synchronize()
    assert kernel.single_launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, gram_ref.gram_ref(a),
                               **_single_tol(d, dtype))


LOWRANK_SINGLE = [(1, 1, 1), (24, 6, 1), (123, 17, 5), (70, 8, 9),
                  (1000, 300, 3), (4096, 8, 1), (25_165_824, 8, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,ell,n", LOWRANK_SINGLE)
@pytest.mark.parametrize("dtype", list(SINGLE))
def test_single_lowrank_kernel_matches_plain_on_card(card, d, ell, n, dtype):
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(d + ell + n)
    u = torch.randn(d, ell, generator=gen, device=card)
    g = torch.randn(d, n, generator=gen, device=card).to(SINGLE[dtype])
    coeffs = torch.rand(ell, generator=gen, device=card)
    base = torch.rand((), generator=gen, device=card)
    before = kernel.single_launches
    got = kernel.lowrank_apply(u, coeffs, base, g)
    again = kernel.lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    assert kernel.single_launches == before + 2
    assert got.dtype == g.dtype and torch.equal(got, again)
    tol = _single_tol(d, dtype)
    if dtype != "float32":
        tol["rtol"] = max(tol["rtol"], torch.finfo(g.dtype).eps)
    torch.testing.assert_close(
        got.float(),
        lowrank_ref.lowrank_apply_ref(u, coeffs, base, g).float(), **tol)


@pytest.mark.cuda
def test_single_wrappers_reject_what_they_do_not_take(card):
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.lowrank import kernel as lowrank_kernel
    a = torch.zeros(8, 4, device=card)
    with pytest.raises(TypeError):
        gram_kernel.gram(a.double())
    with pytest.raises(ValueError, match="contiguous"):
        gram_kernel.gram(a.T)
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernel.gram(a.cpu())
    assert torch.equal(gram_kernel.gram(a[:0]), torch.zeros(4, 4,
                                                            device=card))
    u, g = torch.zeros(8, 3, device=card), torch.zeros(8, 2, device=card)
    c = torch.zeros(3, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        lowrank_kernel.lowrank_apply(u, c, 1.0, g.T.contiguous().T)
    with pytest.raises(TypeError, match="float32"):
        lowrank_kernel.lowrank_apply(u.bfloat16(), c, 1.0, g)
    with pytest.raises(ValueError, match="shape"):
        lowrank_kernel.lowrank_apply(u, c[:2], 1.0, g)


# (B, Hq, Hkv, S, hd, causal): tests/test_kernels.py:196-201's sweep, the
# dense training shape, zamba2-7b's feedback shape, head dims 48 and 128,
# a ragged one, gemma-2b's head dim 256 (MQA) at S 128 and ragged, and the
# launcher's batch 8 x seq 128 at qwen2-vl-72b's and musicgen-large's
# full-width heads (chip_smoke.py phase 9a)
FLASH_CASES = [(1, 2, 2, 64, 16, True), (2, 4, 2, 96, 32, True),
               (1, 8, 1, 128, 64, True), (2, 2, 2, 80, 16, False),
               (8, 12, 12, 128, 64, True), (4, 32, 32, 16, 112, True),
               (2, 6, 3, 130, 48, True), (1, 2, 1, 70, 128, False),
               (1, 8, 1, 128, 256, True), (2, 4, 1, 70, 256, False),
               (8, 64, 8, 128, 128, True), (8, 32, 32, 128, 64, True),
               # deepseek-moe-16b's expert-parallel run (phase 4d)
               (4, 16, 16, 512, 128, True)]


def _flash_inputs(card, B, Hq, Hkv, S, hd, dtype, seed):
    """q (B, Hq, S, hd) and k, v (B, Hkv, S, hd) as the model hands them
    over: transposed views of (B, S, H, hd) tensors."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(B, S, h, hd, generator=gen, device=card)
            .to(ALL_DTYPES[dtype]).transpose(1, 2) for h in (Hq, Hkv, Hkv)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_flash_kernel_matches_plain_on_card(card, B, Hq, Hkv, S, hd, causal,
                                            dtype):
    from repro_torch.kernels.flash import kernel
    from repro_torch.kernels.flash import ref
    q, k, v = _flash_inputs(card, B, Hq, Hkv, S, hd, dtype, S + hd)
    before = kernel.launches
    got = kernel.flash_attention(q, k, v, causal=causal)
    again = kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.testing.assert_close(got.float(), want, atol=HALF_ATOL[dtype],
                               rtol=0)
    if dtype == "float16":   # the wgmma kernel's .f16 form
        assert kernel.plan(q.dtype, B, Hq, S, hd).kernel in (
            "wgmma_f16", "wide")
        assert float((got.float() - want).norm() / want.norm()) <= 1e-2


# bf16 only, the edges of the wgmma kernel (B, Hq, Hkv, S, Sk, hd, causal):
# every head dim at S 130 (no multiple of the 128-row query tile or the
# 64-key tile), hd 112 at S 4096, not causal with Sk != S, GQA with one KV
# head, B * Hq = 160 blocks (over the card's 132 SMs), and S <= 64 (a
# 64-row block, one warpgroup); head dim 256 also at gemma-2b's S 4096
# and at S <= 64
FLASH_BF16_CASES = [(1, 4, 2, 130, 130, hd, True)
                    for hd in list(range(16, 129, 16)) + [256]]
FLASH_BF16_CASES += [(1, 8, 1, 4096, 4096, 256, True),
                     (2, 8, 1, 40, 40, 256, True),
                     (1, 4, 1, 200, 333, 256, False)]
FLASH_BF16_CASES += [(1, 32, 32, 4096, 4096, 112, True),
                     (2, 4, 4, 200, 72, 64, False),
                     (1, 4, 2, 200, 333, 112, False),
                     (2, 8, 1, 256, 256, 64, True),
                     (5, 32, 8, 100, 100, 64, True),
                     (3, 6, 2, 40, 40, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,Sk,hd,causal", FLASH_BF16_CASES)
def test_flash_bf16_kernel_edges_on_card(card, B, Hq, Hkv, S, Sk, hd,
                                         causal):
    """The reference's bf16 tolerance (atol 0.05 on the f32 upcast inputs)
    and, as chip_smoke.py's MODEL_RTOL, a relative error of the whole
    output of at most 1e-2 (at S 4096 the outputs are ~0.03 each)."""
    from repro_torch.kernels.flash import kernel
    from repro_torch.kernels.flash import ref
    gen = torch.Generator(device=card).manual_seed(S + Sk + hd)
    q = torch.randn(B, S, Hq, hd, generator=gen, device=card).bfloat16()
    k, v = (torch.randn(B, Sk, Hkv, hd, generator=gen, device=card)
            .bfloat16().transpose(1, 2) for _ in "kv")
    q = q.transpose(1, 2)
    before = kernel.launches
    got = kernel.flash_attention(q, k, v, causal=causal)
    again = kernel.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    torch.testing.assert_close(got.float(), want, atol=0.05, rtol=0)
    assert float((got.float() - want).norm() / want.norm()) <= 1e-2


@pytest.mark.cuda
def test_flash_bf16_kernel_rejects_misaligned_views(card):
    """A bf16 view whose base or strides are no multiple of 16 bytes is no
    longer refused: the kernel stages it element by element (the 16-byte
    chunks need alignment) and matches the plain version at the bf16
    tolerances (atol 0.05 and 1e-2 in norm); the f32 kernel has no such
    rule.  The name is the one the test had when such views raised."""
    from repro_torch.kernels.flash import kernel
    from repro_torch.kernels.flash import ref
    gen = torch.Generator(device=card).manual_seed(9)
    flat = torch.randn(8 * 2 * 64 + 1, generator=gen, device=card).bfloat16()
    wide = torch.randn(1, 8, 2, 68, generator=gen, device=card).bfloat16()
    for q in (flat[1:].view(1, 8, 2, 64).transpose(1, 2),   # base 2 B off
              wide[..., :64].transpose(1, 2)):              # rows 136 B
        assert not kernel.check_aligned(q, q.stride())
        before = kernel.launches
        got = kernel.flash_attention(q, q, q)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = ref.attention_ref(q.float(), q.float(), q.float())
        torch.testing.assert_close(got.float(), want, atol=0.05, rtol=0)
        assert float((got.float() - want).norm() / want.norm()) <= 1e-2
    before = kernel.launches
    kernel.flash_attention(q.float(), q.float(), q.float())
    assert kernel.launches == before + 1


# (B, S, H, P, N, chunk): tests/test_kernels.py:215-219's sweep, zamba2-7b's
# feedback shape, a chunk of 256 at N = 64 and 128, and S and H that are no
# multiple of the chunk or the head tile; then the seams of the three
# phases: one chunk (S = chunk, and S < chunk with Q = 70 no multiple of
# 16), 2 and 17 chunks, a ragged last chunk at 4096 + 40, Q < 16 (chunk 8)
# over several chunks, H no multiple of the head tile at Q = 16 and 256, N
# 128 at P 16, and B > 1 with several chunks
SSD_CASES = [(1, 32, 4, 16, 16, 8), (2, 64, 8, 16, 32, 16),
             (1, 48, 6, 32, 64, 16), (4, 16, 112, 64, 64, 16),
             (1, 512, 8, 64, 64, 256), (1, 512, 4, 64, 128, 256),
             (2, 70, 5, 32, 48, 32),
             (1, 256, 8, 64, 64, 256), (2, 70, 4, 64, 64, 256),
             (1, 272, 4, 32, 32, 16), (1, 4136, 4, 64, 64, 256),
             (2, 40, 3, 32, 64, 8), (1, 16, 7, 64, 64, 16),
             (1, 300, 3, 64, 64, 256), (1, 512, 4, 16, 128, 256),
             (3, 200, 6, 64, 64, 64)]


def _ssd_inputs(card, B, S, H, P, N, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    u = (torch.randn(B, S, H, P, generator=gen, device=card) * 0.5)
    dlog = -torch.randn(B, S, H, generator=gen, device=card).abs() * 0.1
    Bm = torch.randn(B, S, N, generator=gen, device=card) * 0.3
    Cm = torch.randn(B, S, N, generator=gen, device=card) * 0.3
    dt = ALL_DTYPES[dtype]
    return u.to(dt), dlog, Bm.to(dt), Cm.to(dt)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_ssd_kernel_matches_plain_on_card(card, B, S, H, P, N, chunk, dtype):
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd import ref
    u, dlog, Bm, Cm = _ssd_inputs(card, B, S, H, P, N, dtype, S + N)
    before = kernel.launches
    got = kernel.ssd_scan(u, dlog, Bm, Cm, chunk)
    again = kernel.ssd_scan(u, dlog, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got.dtype == u.dtype and got.shape == u.shape
    assert torch.equal(got, again)
    want = ref.ssd_ref(u.float(), dlog, Bm.float(), Cm.float(), chunk)
    atol = 5e-6 * S if dtype == "float32" else 0.15
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_and_ssd_gradients_on_card(card, dtype):
    """The Functions' gradients (kernel forward, plain backward) against
    autograd of the plain version, and each forward launches once."""
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.flash import ops as flash_ops
    from repro_torch.kernels.flash import ref as flash_ref
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    qkv = _flash_inputs(card, 2, 4, 2, 40, 32, dtype, 1)
    ssd_in = _ssd_inputs(card, 2, 48, 6, 32, 64, dtype, 2)
    cases = [(flash_kernel, lambda *t: flash_ops.flash_attention(*t),
              lambda *t: flash_ref.attention_ref(*t), qkv),
             (ssd_kernel, lambda *t: ssd_ops.ssd_scan(*t, 16),
              lambda *t: ssd_ref.ssd_ref(*t, 16), ssd_in)]
    for kernel, fn, plain, inputs in cases:
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        before = kernel.launches
        out = fn(*leaves)
        assert kernel.launches == before + 1
        w = torch.randn(out.shape, device=card).to(out.dtype)
        got = torch.autograd.grad((out.float() * w).sum(), leaves)
        want = torch.autograd.grad((plain(*leaves).float() * w).sum(),
                                   leaves)
        assert kernel.launches == before + 1
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_flash_and_ssd_wrappers_reject_what_they_do_not_take(card):
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    q = torch.zeros(1, 2, 8, 32, device=card)
    with pytest.raises(TypeError):
        flash_kernel.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        flash_kernel.flash_attention(q.half(), q, q)
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q.cpu(), q, q)
    with pytest.raises(ValueError, match="contiguous last dim"):
        flash_kernel.flash_attention(q.mT, q.mT, q.mT)
    empty = torch.zeros(1, 2, 8, 0, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_kernel.flash_attention(empty, empty, empty)
    with pytest.raises(ValueError, match="shape"):
        flash_kernel.flash_attention(q, q[:, :1].expand(1, 3, 8, 32),
                                     q[:, :1].expand(1, 3, 8, 32))
    u, dlog = torch.zeros(1, 8, 2, 16, device=card), torch.zeros(1, 8, 2,
                                                                 device=card)
    bc = torch.zeros(1, 8, 4, device=card)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(u, dlog.bfloat16(), bc, bc, 4)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(u.bfloat16(), dlog, bc, bc, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(u, dlog.cpu(), bc, bc, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.ssd_scan(u, dlog, bc.mT.contiguous().mT, bc, 4)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(u.double(), dlog, bc.double(), bc.double(), 4)
    with pytest.raises(ValueError, match="chunk"):
        ssd_kernel.ssd_scan(u, dlog, bc, bc, 0)
    with pytest.raises(ValueError, match="shape"):
        ssd_kernel.ssd_scan(u, dlog[:, :4], bc, bc, 4)



# kernel 1 at Shampoo's per-step statistics at full width (paper-lm-100m,
# block 1024): per pool group the Gram of G^T (L) and of G (R); the norm
# group's L is (2, 768, 12), a 12-wide output in one partial tile, and its R
# (2, 12, 768) sums d = 12 rows, less than one 32-row chunk
SHAMPOO_GRAM_CASES = [(68, 768, 1024), (68, 1024, 768), (104, 1024, 768),
                      (104, 768, 1024), (48, 768, 768), (2, 768, 12),
                      (2, 12, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,k", SHAMPOO_GRAM_CASES)
def test_gram_kernel_at_shampoo_shapes_on_card(card, N, d, k):
    """Data of mean 3, as the Sketchy main path's hardest case."""
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(N * d + k)
    a = torch.randn(N, d, k, generator=gen, device=card) + 3.0
    got = kernel.batched_gram(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gram_ref.batched_gram_ref(a),
                               **_tol(d, "float32"))


# the sharded statistics' merge Grams at full width (chip_smoke.py
# merge_gram_shapes): two rank-64 sketches of ell - 1 = 63 columns a side,
# k = 126, and k = 22 for the 12-row side of the norm group; and the
# shrink merge's (shrink_merge_gram_shapes, phase 4d): both whole factors,
# k = 2 ell = 128, and 24 for the 12-row side
MERGE_GRAM_CASES = [(68, 1024, 126), (68, 768, 126), (2, 12, 22),
                    (2, 768, 126), (104, 768, 126), (104, 1024, 126),
                    (48, 768, 126),
                    (68, 1024, 128), (68, 768, 128), (2, 12, 24),
                    (2, 768, 128), (104, 768, 128), (104, 1024, 128),
                    (48, 768, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,k", MERGE_GRAM_CASES)
def test_gram_kernel_at_merge_shapes_on_card(card, N, d, k):
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator(device=card).manual_seed(N * d + k)
    a = torch.randn(N, d, k, generator=gen, device=card)
    got = kernel.batched_gram(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gram_ref.batched_gram_ref(a),
                               **_tol(d, "float32"))


@pytest.mark.cuda
def test_fd_merge_on_card_matches_cpu(card):
    """``fd_merge_factors_batched`` at a merge shape on the card (kernel 1
    once) and on the CPU: the same covariance ``U diag(s) U^T`` and ladder
    within 1e-4 of their largest magnitude, the same rho."""
    from repro_torch.core import fd
    from repro_torch.kernels.gram import kernel
    gen = torch.Generator().manual_seed(0)
    Ba, Bb = (torch.randn(4, 768, 63, generator=gen) for _ in range(2))
    rho_a, rho_b = torch.rand(4, generator=gen), torch.rand(4, generator=gen)
    before = kernel.launches
    got = fd.fd_merge_factors_batched(*(t.to(card) for t in (Ba, rho_a)),
                                      *(t.to(card) for t in (Bb, rho_b)),
                                      ell=64)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = fd.fd_merge_factors_batched(Ba, rho_a, Bb, rho_b, ell=64)
    cov = lambda st: torch.einsum("nde,ne,nfe->ndf", st.eigvecs.cpu().double(),
                                  st.eigvals.cpu().double(),
                                  st.eigvecs.cpu().double())
    for a, b in ((cov(got), cov(want)), (got.eigvals.cpu(), want.eigvals),
                 (got.rho.cpu(), want.rho)):
        scale = float(want.eigvals.abs().max())
        torch.testing.assert_close(a.double(), b.double(), rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.cuda
def test_shrink_merge_on_card_matches_cpu(card):
    """``elastic.merge_sketches_on_shrink`` of four pools of sketches on the
    card (kernel 1 once a merge of a stack: 3 x 2 sides) and on the CPU:
    the same covariance, ladder and rho within 1e-4 of the largest
    eigenvalue, the other leaves passed through."""
    from repro_torch.core import fd, sketchy
    from repro_torch.kernels.gram import kernel
    from repro_torch.train import elastic
    gen = torch.Generator().manual_seed(1)
    pools = []
    for _ in range(4):
        sides = [fd.fd_update_batched(fd.fd_init(64, 8, num_blocks=3),
                                      torch.randn(3, 64, 5, generator=gen))
                 for _ in range(2)]
        pools.append({"64x64": sketchy.SketchyBlockStats(*sides),
                      "n": torch.tensor(len(pools))})
    on_card = [{"64x64": sketchy.SketchyBlockStats(*(
        fd.FDState(*(t.to(card) for t in side)) for side in p["64x64"])),
        "n": p["n"]} for p in pools]
    before = kernel.launches
    got = elastic.merge_sketches_on_shrink(on_card)
    torch.cuda.synchronize()
    assert kernel.launches == before + 6
    want = elastic.merge_sketches_on_shrink(pools)
    assert int(got["n"]) == 0
    cov = lambda st: torch.einsum("nde,ne,nfe->ndf", st.eigvecs.cpu().double(),
                                  st.eigvals.cpu().double(),
                                  st.eigvecs.cpu().double())
    for a, b in zip(got["64x64"], want["64x64"]):
        scale = float(b.eigvals.abs().max())
        for x, y in ((cov(a), cov(b)), (a.eigvals.cpu(), b.eigvals),
                     (a.rho.cpu(), b.rho)):
            torch.testing.assert_close(x.double(), y.double(), rtol=1e-4,
                                       atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["shampoo", "adam"])
def test_baseline_training_on_card_matches_cpu(card, optimizer):
    """Two steps of the reduced model through ``repro_torch.launch.train``
    (Shampoo's roots at both) on the card and on the CPU from the same
    weights: the same losses (``rtol=1e-4``) and parameters (``rtol=1e-3``,
    ``atol=1e-4``: Shampoo's roots of one-gradient statistics take eigh
    noise, tests/test_torch_optimizers.py); on the card Shampoo's L and R
    run kernel 1 (two a pool group a step), both optimizers' attention
    kernel 7, and Adam no optimizer kernel."""
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core import pool
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.launch import train
    from repro_torch.models import model
    cfg = registry.get_reduced("paper-lm-100m")
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    argv = ["--reduced", "--steps", "2", "--seq", "16", "--batch", "4",
            "--block-size", "32", "--update-every", "1", "--optimizer",
            optimizer]
    runs = {}
    for device in (card, torch.device("cpu")):
        start = tree.unflatten(params, [p.to(device)
                                        for p in tree.flatten(params)])
        before = (gram_kernel.launches, flash_kernel.launches)
        runs[device.type] = train.train(
            train.parse_args(argv + ["--device", str(device)]), start)
        if device.type == "cuda":
            groups = pool.build_index(tuple(
                tuple(p.shape) for p in tree.flatten(params)), 32).groups
            grams = 2 * 2 * len(groups) if optimizer == "shampoo" else 0
            assert (gram_kernel.launches - before[0],
                    flash_kernel.launches - before[1]) == \
                (grams, 2 * cfg.num_layers)
    (card_run, card_log), (cpu_run, cpu_log) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose([r["loss"] for r in card_log],
                               [r["loss"] for r in cpu_log], rtol=1e-4)
    for got, want in zip(tree.flatten(card_run.params),
                         tree.flatten(cpu_run.params)):
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   rtol=1e-3, atol=1e-4)


NEW_ARCHS = ["phi3-mini-3.8b", "qwen2.5-32b", "qwen3-32b", "gemma-2b",
             "deepseek-moe-16b", "kimi-k2-1t-a32b", "qwen2-vl-72b",
             "musicgen-large"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_archs_on_card_match_cpu(card, arch):
    """The reduced dense configs with one feature each, the moe configs and
    the vlm and audio configs, on the card (kernel 7 in the forward, once a
    layer) and on the CPU from the same weights, on each family's own
    inputs, through chip_smoke.py's phase 8c
    (``phase_new_arch_reference``, which raises on a disagreement): logits
    and a teacher-forced decode within ``rtol=1e-4, atol=1e-4``, and one
    Sketchy step through ``repro_torch.launch.train`` (rank 8, block 32, a
    refresh at the step): the same loss (relative 1e-4) and parameters
    (``rtol=1e-3, atol=1e-4``)."""
    smoke = chip_smoke()
    assert arch in smoke.NEW_ARCHS
    smoke.phase_new_arch_reference(card, arch)


def _plain_on_card(monkeypatch) -> None:
    """Route every kernel-set entry to its plain version, on the card's
    tensors too."""
    from repro_torch.kernels import registry
    monkeypatch.setattr(registry, "_route",
                        lambda t, on_card, on_cpu: on_cpu)


def _cov(U, s) -> torch.Tensor:
    U, s = U.double(), s.double()
    return torch.einsum("nde,ne,nfe->ndf", U, s, U)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_masked_refresh_on_card_matches_plain(card, quantized, monkeypatch):
    """The rank budget's masked FD refresh (kernel 1, or kernels 5 and 6 on
    int8 eigenvectors) against the same refresh through the plain versions
    on the card, the same ``eigh``: from one warm sketch (an unmasked
    refresh through the kernels), a masked refresh at active ranks from 1
    to the capacity 64 (d 768, 32 new columns).  (From two warm sketches,
    one each way, the int8 write-backs' one-step differences at .5
    boundaries move the next ladder by up to 1 %.)
    The ladders at the f32 tolerance of ``ell + r`` sums, the covariance
    ``U diag(s) U^T`` (never raw U) within 1e-4 of its largest magnitude
    (int8: one quantization step, 1/127 of it), and the columns past each
    block's rank exactly zero in both."""
    from repro_torch.core import fd, quantize
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.lowrank import kernel as lowrank_kernel
    gen = torch.Generator(device=card).manual_seed(11)
    N, d, ell, r = 5, 768, 64, 32
    k = torch.tensor([1, 17, 64, 40, 8], dtype=torch.int32, device=card)
    state = fd.fd_init(d, ell, num_blocks=N, device=card)
    if quantized:
        state = state._replace(eigvecs=quantize.quantize_stack(state.eigvecs))
    state = fd.fd_update_batched(
        state, torch.randn(N, d, 2 * ell, generator=gen, device=card), 0.99)
    new = torch.randn(N, d, r, generator=gen, device=card)
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            _plain_on_card(monkeypatch)
        before = (gram_kernel.launches, gram_kernel.mixed_launches,
                  lowrank_kernel.project_quantize_launches)
        st = fd.fd_update_batched(state, new, 0.99, active_k=k)
        torch.cuda.synchronize()
        after = (gram_kernel.launches, gram_kernel.mixed_launches,
                 lowrank_kernel.project_quantize_launches)
        runs[route] = (st, [b - a for a, b in zip(before, after)])
    (got, launched), (want, none) = runs["kernel"], runs["plain"]
    assert launched == ([0, 1, 1] if quantized else [1, 0, 0])
    assert none == [0, 0, 0]
    torch.testing.assert_close(got.eigvals, want.eigvals, rtol=1e-4,
                               atol=1e-4 * float(want.eigvals.abs().max()))
    torch.testing.assert_close(got.rho, want.rho, rtol=1e-4,
                               atol=1e-4 * float(want.eigvals.abs().max()))
    U = {name: quantize.dequantize_stack(*st.eigvecs) if quantized
         else st.eigvecs for name, st in (("got", got), ("want", want))}
    c_got, c_want = _cov(U["got"], got.eigvals), _cov(U["want"], want.eigvals)
    frac = 2.0 / 127 if quantized else 1e-4
    torch.testing.assert_close(c_got, c_want, rtol=0,
                               atol=frac * float(c_want.abs().max()))
    for st in (got, want):
        vals = st.eigvecs.values if quantized else st.eigvecs
        for b in range(N):
            assert not vals[b, :, int(k[b]):].any()
            assert not st.eigvals[b, int(k[b]):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_staggered_substack_refresh_on_card_matches_plain(card, storage,
                                                          monkeypatch):
    """One staggered step of the engine on the card (a sub-stack of the due
    blocks through the kernels) against the plain refresh of the same
    blocks on the card: the due blocks' ladders at the f32 tolerance and
    their covariances as in the masked test above; every other block's
    stored tensors untouched, bit for bit."""
    from repro_torch.core import pool, quantize
    from repro_torch.core.sketchy import (RankBudget, SketchyConfig,
                                          SketchyPreconditioner, sketchy)
    cfg = SketchyConfig(rank_budget=RankBudget(min_k=16, max_k=16),
                        block_size=128, update_every=4,
                        refresh_schedule="staggered",
                        second_moment_dtype=storage)
    tx = sketchy(cfg)
    gen = torch.Generator(device=card).manual_seed(12)
    params = [torch.zeros(640, 384, device=card)]     # 15 blocks
    state = tx.init(params)
    grads = [[torch.randn(640, 384, generator=gen, device=card)]
             for _ in range(4)]
    for g in grads[:3]:
        _, state = tx.update(g, state, params)
    _, after = tx.update(grads[3], state, params)     # count 3
    grp = pool.build_index(((640, 384),), 128).groups[0]
    due = pool.due_blocks(grp, 3, 4)
    assert due == [1, 5, 9, 13]
    idx = torch.tensor(due, device=card)
    _plain_on_card(monkeypatch)
    sub = pool.map_stacks(lambda x: x.index_select(0, idx),
                          quantize.compute_view(state.pools[grp.key]))
    gb = pool.pack(pool.build_index(((640, 384),), 128),
                   [grads[3][0]])[grp.key].index_select(0, idx)
    want = SketchyPreconditioner(cfg).refresh_batched(sub, gb)
    got, before = after.pools[grp.key], state.pools[grp.key]
    for side in ("left", "right"):
        g_side, w_side = getattr(got, side), getattr(want, side)
        ladder = float(w_side.eigvals.abs().max())
        torch.testing.assert_close(g_side.eigvals[idx], w_side.eigvals,
                                   rtol=1e-4, atol=1e-4 * ladder)
        U_got = g_side.eigvecs
        U_want = w_side.eigvecs
        if storage == "int8":
            U_got = quantize.dequantize_stack(*U_got)
            U_want = quantize.dequantize_stack(*U_want)
        c_want = _cov(U_want, w_side.eigvals)
        torch.testing.assert_close(
            _cov(U_got[idx], g_side.eigvals[idx]), c_want, rtol=0,
            atol=(2.0 / 127 if storage == "int8" else 1e-4)
            * float(c_want.abs().max()))
    keep = torch.tensor([b for b in range(grp.num_blocks) if b not in due],
                        device=card)
    for a, b in zip(quantize.second_moment_tensors(got),
                    quantize.second_moment_tensors(before)):
        assert torch.equal(a.index_select(0, keep), b.index_select(0, keep))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["synchronized", "staggered"])
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_async_step_shifted_on_card(card, schedule, storage):
    """Sketchy inline and async over the same gradients on the card: after
    each of 6 steps the async state's committed pools equal the inline
    pools bit for bit (the kernels and ``eigh`` give the same bits on the
    same inputs)."""
    from repro_torch.core import api, quantize
    from repro_torch.core.sketchy import RankBudget, SketchyConfig, sketchy
    txs = {mode: sketchy(SketchyConfig(
        rank_budget=RankBudget(min_k=16, max_k=16), block_size=128,
        update_every=2, refresh_schedule=schedule, refresh_mode=mode,
        second_moment_dtype=storage)) for mode in ("inline", "async")}
    params = [torch.zeros(640, 384, device=card),
              torch.zeros(256, 256, device=card)]
    states = {mode: tx.init(params) for mode, tx in txs.items()}
    gen = torch.Generator(device=card).manual_seed(13)
    for t in range(6):
        g = [torch.randn(p.shape, generator=gen, device=card)
             for p in params]
        for mode, tx in txs.items():
            _, states[mode] = tx.update(g, states[mode], params)
        committed = api.committed_pools(states["async"])
        for key, live in states["inline"].pools.items():
            for a, b in zip(quantize.second_moment_tensors(committed[key]),
                            quantize.second_moment_tensors(live)):
                assert torch.equal(a, b), (t, key)


def _state_bits(a, b) -> tuple:
    """(bit for bit equal, largest absolute difference) of two states."""
    from repro_torch.train import checkpoint as ckpt
    la, lb = ckpt.leaves(a), ckpt.leaves(b)
    assert [x.name for x in la] == [x.name for x in lb]
    same, worst = True, 0.0
    for x, y in zip(la, lb):
        if not isinstance(x.value, torch.Tensor):
            same &= x.value == y.value
        elif not torch.equal(x.value, y.value):
            same = False
            worst = max(worst, float((x.value.double()
                                      - y.value.double()).abs().max()))
    return same, worst


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_checkpoint_round_trip_and_continuation_on_card(card, tmp_path,
                                                        storage):
    """The reduced model trained 3 steps on the card, saved and restored
    into a fresh template: every leaf comes back bit for bit, on the card;
    step 3 from the restored state equals step 3 from the live one bit for
    bit, or within the difference of the same step run twice from the live
    state (a witness of what the card repeats)."""
    from repro_torch.launch import train as train_lib
    from repro_torch.train import checkpoint as ckpt
    args = train_lib.parse_args([
        "--reduced", "--steps", "6", "--seq", "16", "--batch", "4",
        "--rank", "4", "--block-size", "32", "--update-every", "2",
        "--second-moment-dtype", storage])
    run = train_lib.start(args)
    for i in range(3):
        run.step(i)
    live = (run.params, run.opt_state)
    ckpt.save(str(tmp_path), 2, live)
    fresh = train_lib.start(args)
    restored, step, _ = ckpt.restore(str(tmp_path),
                                     (fresh.params, fresh.opt_state))
    assert step == 2
    assert _state_bits(restored, live) == (True, 0.0)
    # on the template's devices: the card, but the chain's hyperparameters
    # (host scalars, as the engine makes them)
    devices = [(leaf.value.device, want.value.device) for leaf, want in
               zip(ckpt.leaves(restored), ckpt.leaves(live))
               if isinstance(leaf.value, torch.Tensor)]
    assert all(got == want for got, want in devices)
    assert sum(got.type == "cuda" for got, _ in devices) > 40

    def copy(state):
        return ckpt.map_leaves(
            lambda leaf: leaf.value.detach().clone()
            if isinstance(leaf.value, torch.Tensor) else leaf.value, state)

    def step_from(state):
        run.params, run.opt_state = state
        run.step(3)
        torch.cuda.synchronize()
        return run.params, run.opt_state

    a, b = step_from(copy(live)), step_from(copy(live))
    witness_same, witness = _state_bits(a, b)
    same, diff = _state_bits(step_from(restored), a)
    assert same or (not witness_same and diff <= witness), (diff, witness)


# the autotuner's candidates: (N, d, ell, n) of the apply and (N, d, k, r)
# of the write-back (e = k): main-path shapes and ragged ones
TUNE_APPLY = [(68, 1024, 64, 768), (2, 12, 12, 768), (2, 768, 64, 12),
              (3, 300, 130, 70), (1, 200, 300, 40), (2, 1000, 17, 45)]
TUNE_PROJECT = [(68, 1024, 64, 768), (2, 768, 64, 12), (3, 200, 64, 40),
                (2, 130, 80, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,ell,n", TUNE_APPLY)
@pytest.mark.parametrize("u_dtype", ["float32", "int8"])
def test_every_apply_candidate_matches_plain_on_card(card, N, d, ell, n,
                                                     u_dtype):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.lowrank import kernel
    shape = (N, d, ell, n)
    u, c, b, g = autotune._operands("batched_lowrank_apply", shape, u_dtype,
                                    card)
    want = lowrank_ref.batched_lowrank_apply_ref(u.float(), c, b, g)
    cands = autotune.candidates("batched_lowrank_apply", shape, u_dtype)
    assert len(cands) > 1
    for cand in cands:
        got = kernel.batched_lowrank_apply(u, c, b, g, col_tile=cand.col_tile)
        torch.testing.assert_close(got, want, **_tol(d, "float32"),
                                   msg=lambda m: f"{cand}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("N,d,k,r", TUNE_PROJECT)
def test_every_project_candidate_matches_plain_on_card(card, N, d, k, r):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(d + k)
    vq = _int8(N, d, k, gen, card)
    w_top = torch.randn(N, k, k, generator=gen, device=card) / 127
    a = torch.randn(N, d, r, generator=gen, device=card)
    w_bot = torch.randn(N, r, k, generator=gen, device=card)
    for cand in autotune.candidates("batched_project_quantize",
                                    (N, d, k, r, k)):
        got = kernel.batched_project_quantize(vq, w_top, a, w_bot,
                                              blocks=cand.blocks)
        lowrank_ref.project_quantize_differences(got, vq, w_top, a, w_bot)


@pytest.mark.cuda
def test_column_tile_reaches_the_apply_kernel(card):
    from repro_torch.kernels import autotune, build, registry
    from repro_torch.kernels.lowrank import kernel
    shape = (2, 300, 64, 200)
    u, c, b, g = autotune._operands("batched_lowrank_apply", shape,
                                    "float32", card)
    default = kernel.batched_lowrank_apply(u, c, b, g)
    widest = kernel.batched_lowrank_apply(u, c, b, g, col_tile=64)
    assert torch.equal(default, widest)
    pinned = registry.batched_lowrank_apply(
        u, c, b, g, config=autotune.TileConfig(col_tile=8))
    torch.testing.assert_close(pinned, default, **_tol(300, "float32"))
    out = torch.empty_like(g)
    lib = build.library("lowrank").repro_batched_lowrank_apply
    for tile in (24, 128):          # no such template instance
        assert build.launch(lib, g.device, u.data_ptr(), 0, c.data_ptr(),
                            b.data_ptr(), g.data_ptr(), out.data_ptr(),
                            *shape, tile) == 1      # cudaErrorInvalidValue
    big = torch.zeros(1, 8, 1984, device=card)
    cb = torch.zeros(1, 1984, device=card)
    assert build.launch(lib, g.device, big.data_ptr(), 0, cb.data_ptr(),
                        b.data_ptr(), g.data_ptr(), out.data_ptr(), 1, 8,
                        1984, 8, 64) == 1           # P does not fit
    with pytest.raises(ValueError, match="column tile 64 does not launch"):
        kernel.batched_lowrank_apply(big, cb, b[:1],
                                     torch.zeros(1, 8, 8, device=card),
                                     col_tile=64)


@pytest.mark.cuda
def test_microbatched_step_on_card_matches_cpu(card):
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core.factory import OptimizerConfig, make_optimizer
    from repro_torch.data import pipeline
    from repro_torch.kernels.flash import kernel as flash_kernel
    from repro_torch.models import model
    from repro_torch.train import trainer
    cfg = registry.get_reduced("paper-lm-100m")
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    batch = pipeline.SyntheticLM(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=8,
        seed=0)).batch(0)
    runs = {}
    for device in (card, torch.device("cpu")):
        p = tree.unflatten(params, [x.to(device)
                                    for x in tree.flatten(params)])
        tx = make_optimizer(OptimizerConfig(
            name="sketchy", learning_rate=3e-3, total_steps=20, rank=4,
            block_size=32, update_every=1))
        state = tx.init(tree.flatten(p))
        step = trainer.make_train_step(cfg, tx, microbatches=4)
        before = flash_kernel.launches
        p, state, m = step(p, state, {k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()})
        if device.type == "cuda":
            assert flash_kernel.launches - before == 4 * cfg.num_layers
        runs[device.type] = (float(m["loss"]), tree.flatten(p))
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-4)
    for got, want in zip(runs["cuda"][1], runs["cpu"][1]):
        torch.testing.assert_close(got.detach().cpu(), want.detach(),
                                   rtol=1e-3, atol=1e-4)


# ---- the kernels past the grid's y/z limit, causal S != Sk, any head dim

# N = 65,536 + 1,000 small blocks, one launch each, against the plain
# versions at the tolerances above (d 16, k 8: kernels 1, 2, 2', 5, 6)
MANY = 65_536 + 1_000


@pytest.mark.cuda
def test_batched_kernels_take_more_than_65535_blocks(card):
    from repro_torch.kernels import registry
    from repro_torch.kernels.gram import kernel as gram_kernel
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(11)
    N, d, k = MANY, 16, 8
    a = torch.randn(N, d, k, generator=gen, device=card)
    before = gram_kernel.launches
    torch.testing.assert_close(gram_kernel.batched_gram(a),
                               gram_ref.batched_gram_ref(a), **_tol(d,
                                                                    "float32"))
    vq = _int8(N, d, k, gen, card)
    colw = torch.rand(N, k, generator=gen, device=card) / 127
    r = torch.randn(N, d, 4, generator=gen, device=card)
    mixed = gram_kernel.mixed_launches
    torch.testing.assert_close(gram_kernel.batched_gram_mixed(vq, colw, r),
                               gram_ref.batched_gram_mixed_ref(vq, colw, r),
                               **_tol(d, "float32"))
    u = torch.randn(N, d, k, generator=gen, device=card)
    g = torch.randn(N, d, 12, generator=gen, device=card)
    coeffs = torch.rand(N, k, generator=gen, device=card)
    base = torch.rand(N, generator=gen, device=card)
    applies = (kernel.launches, kernel.int8_launches)
    torch.testing.assert_close(
        kernel.batched_lowrank_apply(u, coeffs, base, g),
        lowrank_ref.batched_lowrank_apply_ref(u, coeffs, base, g),
        **_tol(d, "float32"))
    scale = torch.rand(N, 1, 1, generator=gen, device=card) / 127
    torch.testing.assert_close(
        registry.batched_lowrank_apply_quantized(vq, scale, coeffs, base, g),
        lowrank_ref.batched_lowrank_apply_quantized_ref(vq, scale, coeffs,
                                                        base, g),
        **_tol(d, "float32"))
    w_top = torch.randn(N, k, k, generator=gen, device=card) / 127
    w_bot = torch.randn(N, 4, k, generator=gen, device=card)
    writes = kernel.project_quantize_launches
    got = kernel.batched_project_quantize(vq, w_top, r, w_bot)
    lowrank_ref.project_quantize_differences(got, vq, w_top, r, w_bot)
    torch.cuda.synchronize()
    assert (gram_kernel.launches, gram_kernel.mixed_launches,
            kernel.launches, kernel.int8_launches,
            kernel.project_quantize_launches) == (
        before + 1, mixed + 1, applies[0] + 1, applies[1] + 1, writes + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_kernel_takes_more_than_65535_batch_rows(card, dtype):
    """70,000 rows of a 40-position sequence in chunks of 16 (all three
    phases), one launch, against the plain version."""
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd import ref
    B, S, H, P, N, chunk = 70_000, 40, 2, 16, 16, 16
    u, dlog, Bm, Cm = _ssd_inputs(card, B, S, H, P, N, dtype, 12)
    before = kernel.launches
    got = kernel.ssd_scan(u, dlog, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = ref.ssd_ref(u.float(), dlog, Bm.float(), Cm.float(), chunk)
    atol = 5e-6 * S if dtype == "float32" else 0.15
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


# causal attention with S != Sk, aligned at the end (query i sees keys j <=
# i + Sk - S; with S > Sk the first S - Sk rows see none: the uniform mean
# of V), and head dims that are no instantiated width, GQA and MHA
FLASH_OFFSET_CASES = [(2, 4, 2, 64, 192), (1, 8, 2, 128, 4096),
                      (2, 4, 4, 192, 64)]
FLASH_ANY_HD = [8, 40, 72, 100, 144, 200, 240]


def _flash_pair(card, B, Hq, Hkv, S, Sk, hd, dtype, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn(B, S, Hq, hd, generator=gen, device=card)
    k, v = (torch.randn(B, Sk, Hkv, hd, generator=gen, device=card)
            for _ in "kv")
    return [t.to(ALL_DTYPES[dtype]).transpose(1, 2) for t in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,Sk", FLASH_OFFSET_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_causal_with_s_not_sk(card, B, Hq, Hkv, S, Sk, dtype):
    from repro_torch.kernels.flash import kernel
    from repro_torch.kernels.flash import ref
    q, k, v = _flash_pair(card, B, Hq, Hkv, S, Sk, 64, dtype, S + Sk)
    before = kernel.launches
    got = kernel.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.isfinite(got.float()).all()
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True)
    atol = 2e-5 if dtype == "float32" else 0.05
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
    if dtype == "bfloat16":     # outputs ~0.03 at Sk 4096: atol alone is blind
        assert float((got.float() - want).norm() / want.norm()) <= 1e-2
    if S > Sk:      # rows that see no key: the mean of V over the Sk keys
        mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(
            Hq // Hkv, dim=1)
        torch.testing.assert_close(got[:, :, :S - Sk].float(),
                                   mean.expand(-1, -1, S - Sk, -1),
                                   atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FLASH_ANY_HD)
@pytest.mark.parametrize("Hkv", [2, 8])
@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_flash_kernel_at_any_head_dim(card, hd, Hkv, dtype):
    """GQA (8 query heads on 2 KV heads) and MHA, causal at S 130 and not
    causal at Sk 70; bf16 and fp16 also within 1e-2 of the plain version in
    norm, as test_flash_bf16_kernel_edges_on_card."""
    from repro_torch.kernels.flash import kernel
    from repro_torch.kernels.flash import ref
    atol = HALF_ATOL[dtype]
    for S, Sk, causal in ((130, 130, True), (130, 70, False)):
        q, k, v = _flash_pair(card, 2, 8, Hkv, S, Sk, hd, dtype, hd + Sk)
        before = kernel.launches
        got = kernel.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.shape == q.shape and got.dtype == q.dtype
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)
        if dtype != "float32":
            assert float((got.float() - want).norm() / want.norm()) <= 1e-2


# Every shape and dtype the reference takes: kernel 8 at any P (slices of
# 64) and any N (chunks of 128 summed in f32), kernel 7 past hd 256 (the
# wide kernel) and in fp16 (the wgmma kernel's .f16 form), kernels 2 and
# 2' past ell 1,984 (chunks of 256 of U's columns), kernel 4 past ell
# 1,024 (227 KB of shared memory, then chunks past 7,264) and kernel 1 in
# fp16.  Each call one launch of its wrapper.
HALF_ATOL = {"float32": 2e-5, "bfloat16": 0.05, "float16": 0.05}


def _ssd_any(card, B, S, H, P, N, dtype, seed):
    """_ssd_inputs with B and C scaled by sqrt(64 / N) past N 64, so that C
    B^T stays within the sizes it has in the sweep (N <= 128) at any N;
    below N 64 they are the sweep's, unscaled."""
    u, dlog, Bm, Cm = _ssd_inputs(card, B, S, H, P, N, "float32", seed)
    s = min(1.0, (64 / N) ** 0.5)
    dt = ALL_DTYPES[dtype]
    return u.to(dt), dlog, (Bm * s).to(dt), (Cm * s).to(dt)


@pytest.mark.cuda
def test_wrappers_count_their_launches_by_dtype(card):
    """Each call that launches adds one under its operand's dtype beside
    its total, a call that returns unlaunched adds nothing, and
    zero_launch_counts clears both."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash import kernel as flash
    from repro_torch.kernels.gram import kernel as gram
    from repro_torch.kernels.lowrank import kernel as lowrank
    from repro_torch.kernels.ssd import kernel as ssd
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(2, 32, 16, generator=gen, device=card)
    q = torch.randn(1, 2, 16, 64, generator=gen, device=card).half()
    u = torch.randn(2, 32, 8, generator=gen, device=card)
    u8 = (u * 40).round().to(torch.int8)
    coeffs = torch.rand(2, 8, generator=gen, device=card)
    base = torch.rand(2, generator=gen, device=card)
    g = torch.randn(2, 32, 4, generator=gen, device=card)
    scan = _ssd_inputs(card, 1, 32, 2, 16, 16, "float16", 0)
    registry.zero_launch_counts()
    gram.batched_gram(a)
    gram.batched_gram(a.half())
    gram.batched_gram(a[:0])
    flash.flash_attention(q, q, q, causal=True)
    ssd.ssd_scan(*scan, 16)
    lowrank.batched_lowrank_apply(u, coeffs, base, g)
    lowrank.batched_lowrank_apply(u8, coeffs, base, g)
    torch.cuda.synchronize()
    assert registry.launch_counts_by_dtype() == {
        "batched_gram float32": 1, "batched_gram float16": 1,
        "flash_attention float16": 1, "ssd_scan float16": 1,
        "batched_lowrank_apply float32": 1,
        "batched_lowrank_apply int8": 1}
    counts = registry.launch_counts()
    assert (counts["batched_gram"], counts["flash_attention"],
            counts["ssd_scan"], counts["batched_lowrank_apply"],
            counts["batched_lowrank_apply_int8"]) == (2, 1, 1, 1, 1)
    registry.zero_launch_counts()
    assert registry.launch_counts_by_dtype() == {}


@pytest.mark.cuda
@pytest.mark.parametrize("P", [8, 48, 128, 192])
@pytest.mark.parametrize("N", [1, 96, 256, 384])
@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_ssd_kernel_at_any_p_and_n(card, P, N, dtype):
    """Three chunks of 16 (all three phases) at S 40, 3 heads (no multiple
    of the head tile), against the plain version at the sweep's
    tolerances (fp16 at bf16's), the same bits twice."""
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd import ref
    B, S, H, chunk = 2, 40, 3, 16
    u, dlog, Bm, Cm = _ssd_any(card, B, S, H, P, N, dtype, P + N)
    before = kernel.launches
    got = kernel.ssd_scan(u, dlog, Bm, Cm, chunk)
    again = kernel.ssd_scan(u, dlog, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert got.dtype == u.dtype and got.shape == u.shape
    assert torch.equal(got, again)
    want = ref.ssd_ref(u.float(), dlog, Bm.float(), Cm.float(), chunk)
    atol = 5e-6 * S if dtype == "float32" else 0.15
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [264, 320, 512])
@pytest.mark.parametrize("Hkv", [2, 8])
@pytest.mark.parametrize("dtype", list(ALL_DTYPES))
def test_flash_kernel_past_head_dim_256(card, hd, Hkv, dtype):
    """The wide kernel, GQA and MHA, causal at S 130 and not causal at Sk
    70; bf16 and fp16 also within 1e-2 of the plain version in norm."""
    from repro_torch.kernels.flash import kernel
    from repro_torch.kernels.flash import ref
    assert kernel.plan(ALL_DTYPES[dtype], 2, 8, 130, hd).kernel == "wide"
    for S, Sk, causal in ((130, 130, True), (130, 70, False)):
        gen = torch.Generator(device=card).manual_seed(hd + Sk)
        q = torch.randn(2, S, 8, hd, generator=gen, device=card)
        k, v = (torch.randn(2, Sk, Hkv, hd, generator=gen, device=card)
                for _ in "kv")
        q, k, v = (t.to(ALL_DTYPES[dtype]).transpose(1, 2) for t in (q, k, v))
        before = kernel.launches
        got = kernel.flash_attention(q, k, v, causal=causal)
        again = kernel.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        assert got.shape == q.shape and got.dtype == q.dtype
        assert torch.equal(got, again)
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal)
        torch.testing.assert_close(got.float(), want, atol=HALF_ATOL[dtype],
                                   rtol=0)
        if dtype != "float32":
            assert float((got.float() - want).norm() / want.norm()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("ell", [1985, 2100, 4000])
@pytest.mark.parametrize("u_dtype", ["float32", "int8"])
def test_batched_apply_past_ell_1984(card, ell, u_dtype):
    """U's columns in chunks (lowrank.apply_chunks), one wrapper launch, at
    the f32 tolerance and the same bits twice; U scaled by 1 / sqrt(ell),
    as orthonormal columns would keep Y's size."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.lowrank import kernel
    assert len(kernel.apply_chunks(ell)) > 1
    gen = torch.Generator(device=card).manual_seed(ell)
    N, d, n = 3, 96, 40
    g = torch.randn(N, d, n, generator=gen, device=card)
    coeffs = torch.rand(N, ell, generator=gen, device=card)
    base = torch.rand(N, generator=gen, device=card)
    if u_dtype == "float32":
        u = torch.randn(N, d, ell, generator=gen, device=card) / ell ** 0.5
        count = "launches"
        run = lambda: kernel.batched_lowrank_apply(u, coeffs, base, g)
        want = lowrank_ref.batched_lowrank_apply_ref(u, coeffs, base, g)
    else:
        vq = _int8(N, d, ell, gen, card)
        scale = torch.rand(N, 1, 1, generator=gen, device=card) / 127 \
            / ell ** 0.5
        count = "int8_launches"
        run = lambda: registry.batched_lowrank_apply_quantized(
            vq, scale, coeffs, base, g)
        want = lowrank_ref.batched_lowrank_apply_quantized_ref(
            vq, scale, coeffs, base, g)
    before = getattr(kernel, count)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert getattr(kernel, count) == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **_tol(d, "float32"))


@pytest.mark.cuda
@pytest.mark.parametrize("ell", [1025, 4096, 8192])
@pytest.mark.parametrize("dtype", list(SINGLE))
def test_single_apply_past_ell_1024(card, ell, dtype):
    """The expand pass with 227 KB of shared memory (ell 1,025 and 4,096)
    and in chunks past 7,264 (8,192), one wrapper launch, the same bits
    twice, at the single apply's tolerances."""
    from repro_torch.kernels.lowrank import kernel
    gen = torch.Generator(device=card).manual_seed(ell)
    d, n = 3000, 9
    u = torch.randn(d, ell, generator=gen, device=card) / ell ** 0.5
    g = torch.randn(d, n, generator=gen, device=card).to(SINGLE[dtype])
    coeffs = torch.rand(ell, generator=gen, device=card)
    base = torch.rand((), generator=gen, device=card)
    before = kernel.single_launches
    got = kernel.lowrank_apply(u, coeffs, base, g)
    again = kernel.lowrank_apply(u, coeffs, base, g)
    torch.cuda.synchronize()
    assert kernel.single_launches == before + 2
    assert got.dtype == g.dtype and torch.equal(got, again)
    tol = _single_tol(d, dtype)
    if dtype != "float32":
        tol["rtol"] = max(tol["rtol"], torch.finfo(g.dtype).eps)
    torch.testing.assert_close(
        got.float(),
        lowrank_ref.lowrank_apply_ref(u, coeffs, base, g).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["paper-lm-100m", "zamba2-7b",
                                  "mamba2-370m", "deepseek-moe-16b"])
def test_fp16_dots_models_on_card_match_cpu(card, arch):
    """The reduced family at float16 with remat_policy="dots" and bf16
    attention logits, on the card and on the CPU from the same weights,
    through chip_smoke.py's phase 8d (``phase_settings_reference``, which
    raises on a disagreement): the loss and every gradient at the bf16
    tolerances of the port's CPU tests, and the kernels' launches."""
    smoke = chip_smoke()
    smoke.phase_settings_reference(card, arch)
