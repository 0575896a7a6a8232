"""The port's kernel entries against the JAX Pallas kernels.

On the CPU the port's entries are the plain PyTorch versions; they are held
against ``batched_gram_pallas`` / ``batched_lowrank_apply_pallas`` (and the
single-block ``gram_pallas`` / ``lowrank_apply_pallas``, at ragged and tall
(d, k) and (d, ell, n), in f32, bf16 and fp16) run in interpret mode, over
the ragged shapes of tests/test_kernels.py, in f32 and bf16, with empty
pools; and the int8 entries against
``batched_gram_mixed_pallas``, ``batched_project_quantize_pallas`` and the
reference registry's scale-folded apply over ragged shapes with ell = 12
(a 64-wide tile straddles the int8/f32 boundary), r = 1, d not a multiple
of 64, and N = 0.  tests/test_torch_cuda.py holds the hand-written Hopper
kernels against the plain versions on the card.

Tolerances: f32 ``atol = 1e-4 * sqrt(d)``, ``rtol = 1e-5`` (the two sides
sum d products in different orders); bf16 inputs 10x that.  A bf16 output
(the low-rank apply keeps G's dtype) is also allowed one bf16 rounding step,
at most 2^-7 of the value: both sides compute in f32 and round once, and f32
results a few ulps apart can round to neighbouring bf16 values.  The int8
write-back's values are bit for bit on inputs whose products and sums are
exact in f32 (any summation order gives the same U_new), and so are its
scales against the reference's oracle (``quantize_stack``); the
interpret-mode Pallas kernel's scale may be one ulp off IEEE division.  On
general inputs a value may differ by 1 where the two sides' U_new/scale
straddle a .5 boundary, and the scales by ``rtol = 1e-6``.

The card's batched Grams (csrc/gram.cu) and batched apply (csrc/lowrank.cu)
multiply in 3xTF32.  Tests here document that arithmetic and the Gram's
tiling with copies written in this file, not with the package's code, so no
change to a kernel can make them fail: numpy emulations of the split held
to the f32 tolerance at the main path's depths (and one tf32 product shown
to miss it), for the Gram and for the apply's two products with their
promotion every 32 deep (an int8 U with two terms), tf32 rounding to
nearest, and the enumeration of the Gram's upper-triangular tiles.  The
kernels' own accuracy and tiling are held on the card
(tests/test_torch_cuda.py), where the error reads several times the
emulation's and data of mean 3 shows the need of the accumulator's
promotion, which the emulation cannot.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.kernels import registry as jregistry
from repro.kernels.gram.kernel import (batched_gram_mixed_pallas,
                                       batched_gram_pallas, gram_pallas)
from repro.kernels.lowrank import ref as jlowrank_ref
from repro.kernels.lowrank.kernel import (batched_lowrank_apply_pallas,
                                          batched_project_quantize_pallas,
                                          lowrank_apply_pallas)
from repro_torch.kernels import registry
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import kernel as lowrank_kernel

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAM_CASES = [(1, 16, 4, 1), (3, 20, 6, 2), (5, 100, 30, 2), (7, 33, 9, 3),
              (4, 64, 16, 4)]
LOWRANK_CASES = [(1, 32, 4, 8, 1), (3, 24, 6, 10, 2), (5, 64, 16, 33, 3),
                 (7, 123, 17, 50, 4)]


def _both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _tol(d: int, dtype: str) -> dict:
    scale = 1 if dtype == "float32" else 10
    return dict(atol=1e-4 * np.sqrt(d) * scale, rtol=1e-5 * scale)


@pytest.mark.parametrize("N,d,k,bn_stack", GRAM_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_gram_matches_pallas(N, d, k, bn_stack, dtype):
    rng = np.random.default_rng(N * 1000 + d)
    a_j, a_t = _both(rng.normal(size=(N, d, k)).astype(np.float32), dtype)
    want = batched_gram_pallas(a_j, bk=16, bd=32, bn_stack=bn_stack)
    got = registry.batched_gram(a_t)
    assert got.dtype == torch.float32 and got.shape == (N, k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(d, dtype))


@pytest.mark.parametrize("N,d,ell,n,bn_stack", LOWRANK_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batched_lowrank_matches_pallas(N, d, ell, n, bn_stack, dtype):
    rng = np.random.default_rng(N * 1000 + d)
    u_j, u_t = _both(rng.normal(size=(N, d, ell)).astype(np.float32), dtype)
    g_j, g_t = _both(rng.normal(size=(N, d, n)).astype(np.float32), dtype)
    coeffs = rng.random((N, ell)).astype(np.float32)
    base = rng.random(N).astype(np.float32)
    want = batched_lowrank_apply_pallas(u_j, jnp.asarray(coeffs),
                                        jnp.asarray(base), g_j, bn=16,
                                        bn_stack=bn_stack)
    got = registry.batched_lowrank_apply(u_t, torch.from_numpy(coeffs),
                                         torch.from_numpy(base), g_t)
    assert got.dtype == g_t.dtype and got.shape == (N, d, n)
    tol = _tol(d, dtype)
    if dtype == "bfloat16":
        tol["rtol"] = max(tol["rtol"], 2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


SINGLE_DTYPES = dict(DTYPES, float16=(jnp.float16, torch.float16))


@pytest.mark.parametrize("d,k", [(16, 4), (33, 9), (100, 30), (4096, 9),
                                 (70, 1)])
@pytest.mark.parametrize("dtype", list(SINGLE_DTYPES))
def test_gram_matches_pallas(d, k, dtype):
    """The single-block Gram (the monitor's and S-AdaGrad's refresh)."""
    rng = np.random.default_rng(d * 10 + k)
    x = rng.normal(size=(d, k)).astype(np.float32)
    jdt, tdt = SINGLE_DTYPES[dtype]
    want = gram_pallas(jnp.asarray(x, jdt), bk=16, bd=64)
    got = registry.gram(torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (k, k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(d, "float32" if dtype == "float32"
                                      else "bfloat16"))


@pytest.mark.parametrize("d,ell,n", [(32, 4, 8), (24, 6, 1), (123, 17, 5),
                                     (4096, 8, 1)])
@pytest.mark.parametrize("dtype", list(SINGLE_DTYPES))
def test_lowrank_apply_matches_pallas(d, ell, n, dtype):
    """The single-block apply (S-AdaGrad's precondition): f32 U and
    coefficients, G and the result in ``dtype``.  A half-precision result
    is also allowed one rounding step of its dtype (see the module
    docstring)."""
    rng = np.random.default_rng(d + ell + n)
    u = rng.normal(size=(d, ell)).astype(np.float32)
    g = rng.normal(size=(d, n)).astype(np.float32)
    coeffs = rng.random(ell).astype(np.float32)
    base = np.float32(rng.random())
    jdt, tdt = SINGLE_DTYPES[dtype]
    want = lowrank_apply_pallas(jnp.asarray(u), jnp.asarray(coeffs),
                                jnp.asarray(base), jnp.asarray(g, jdt), bn=4)
    got = registry.lowrank_apply(torch.from_numpy(u),
                                 torch.from_numpy(coeffs),
                                 torch.tensor(base),
                                 torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and got.shape == (d, n)
    tol = _tol(d, "float32" if dtype == "float32" else "bfloat16")
    if dtype != "float32":
        tol["rtol"] = max(tol["rtol"], float(torch.finfo(tdt).eps))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_empty_pool(dtype):
    """N = 0 gives empty results of the right shape, as in JAX."""
    _, tdt = DTYPES[dtype]
    c = registry.batched_gram(torch.zeros((0, 8, 5), dtype=tdt))
    assert c.shape == (0, 5, 5) and c.dtype == torch.float32
    assert c.shape == batched_gram_pallas(jnp.zeros((0, 8, 5))).shape
    y = registry.batched_lowrank_apply(
        torch.zeros((0, 8, 3), dtype=tdt), torch.zeros((0, 3)),
        torch.zeros((0,)), torch.zeros((0, 8, 4), dtype=tdt))
    assert y.shape == (0, 8, 4) and y.dtype == tdt


def test_registry_dispatches_on_device():
    """CPU tensors take the plain versions, meta tensors (the dry run's
    shapes) too; a device with no kernel raises (nothing falls back)."""
    a = torch.randn(2, 6, 3, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(registry.batched_gram(a),
                               gram_ref.batched_gram_ref(a), rtol=0, atol=0)
    torch.testing.assert_close(registry.gram(a[0]), gram_ref.gram_ref(a[0]),
                               rtol=0, atol=0)
    got = registry.batched_gram(a.to("meta"))
    assert (got.device.type, got.shape) == ("meta", (2, 3, 3))
    m = a[0].to("meta")
    got = registry.lowrank_apply(m, m[0], 1.0, m)
    assert (got.device.type, got.shape) == ("meta", (6, 3))
    elsewhere = types.SimpleNamespace(device=torch.device("xla"))
    with pytest.raises(ValueError, match="no kernel for device xla"):
        registry.batched_gram(elsewhere)
    with pytest.raises(ValueError, match="no kernel for device xla"):
        registry.gram(elsewhere)


def test_launch_counts_by_dtype(monkeypatch):
    """The wrappers' launches by operand dtype as the registry names them,
    and zero_launch_counts clearing them with the totals."""
    for module, attr in registry.LAUNCH_COUNTERS.values():
        monkeypatch.setattr(module, attr, 1)
    for module, attr in registry.DTYPE_COUNTERS.values():
        monkeypatch.setattr(module, attr, {})
    module, attr = registry.DTYPE_COUNTERS["flash_attention"]
    getattr(module, attr)[torch.float16] = 3
    module, attr = registry.DTYPE_COUNTERS["batched_lowrank_apply"]
    getattr(module, attr).update({torch.float32: 2, torch.int8: 1})
    assert registry.launch_counts_by_dtype() == {
        "flash_attention float16": 3, "batched_lowrank_apply float32": 2,
        "batched_lowrank_apply int8": 1}
    registry.zero_launch_counts()
    assert registry.launch_counts_by_dtype() == {}
    assert set(registry.launch_counts().values()) == {0}


# (N, d, ell, r): ell = 12 straddles the int8/f32 boundary inside one tile
MIXED_CASES = [(1, 16, 4, 1), (3, 20, 12, 5), (2, 12, 12, 30),
               (5, 100, 30, 2), (4, 70, 12, 1), (2, 130, 64, 12)]


def _int8(rng, shape, bound=127):
    return rng.integers(-bound, bound + 1, size=shape).astype(np.int8)


@pytest.mark.parametrize("N,d,ell,r", MIXED_CASES)
def test_batched_gram_mixed_matches_pallas(N, d, ell, r):
    rng = np.random.default_rng(N * 1000 + d + ell)
    vq = _int8(rng, (N, d, ell))
    colw = (rng.random((N, ell)) / 127).astype(np.float32)
    a = rng.normal(size=(N, d, r)).astype(np.float32)
    want = batched_gram_mixed_pallas(jnp.asarray(vq), jnp.asarray(colw),
                                     jnp.asarray(a), bd=32)
    got = registry.batched_gram_mixed(torch.from_numpy(vq),
                                      torch.from_numpy(colw),
                                      torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == (N, ell + r, ell + r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(d, "float32"))


def _project_inputs(rng, N, d, k, r, exact):
    """(vq, w_top, a, w_bot).  ``exact``: small integers and multiples of
    2^-4 / 2^-3, so every product is a multiple of 2^-7 and every sum of
    k + r of them stays below 2^17: exact in f32 in any order."""
    e = k
    if exact:
        vq = _int8(rng, (N, d, k), bound=8)
        w_top = rng.integers(-8, 9, size=(N, k, e)) / 16.0
        a = rng.integers(-16, 17, size=(N, d, r)) / 8.0
        w_bot = rng.integers(-8, 9, size=(N, r, e)) / 16.0
    else:
        vq = _int8(rng, (N, d, k))
        w_top = rng.normal(size=(N, k, e)) / 127
        a = rng.normal(size=(N, d, r))
        w_bot = rng.normal(size=(N, r, e))
    return (vq, w_top.astype(np.float32), a.astype(np.float32),
            w_bot.astype(np.float32))


@pytest.mark.parametrize("N,d,k,r", MIXED_CASES)
@pytest.mark.parametrize("exact", [True, False])
def test_batched_project_quantize_matches_pallas(N, d, k, r, exact):
    rng = np.random.default_rng(N * 1000 + d + k + int(exact))
    args = _project_inputs(rng, N, d, k, r, exact)
    want_v, want_s = batched_project_quantize_pallas(
        *(jnp.asarray(x) for x in args))
    got_v, got_s = registry.batched_project_quantize(
        *(torch.from_numpy(x) for x in args))
    assert got_v.dtype == torch.int8 and got_v.shape == (N, d, k)
    assert got_s.dtype == torch.float32 and got_s.shape == (N, 1, 1)
    want_v, want_s = np.asarray(want_v), np.asarray(want_s)
    if exact:
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        # the scale is IEEE absmax / 127, as quantize.int8_scale and the
        # reference's own oracle compute it; the interpret-mode Pallas
        # kernel, compiled by XLA on the CPU, rounds that quotient one ulp
        # off on some blocks
        ref_v, ref_s = jlowrank_ref.batched_project_quantize_ref(
            *(jnp.asarray(x) for x in args))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
        ulps = np.abs(got_s.numpy().view(np.int32).astype(np.int64)
                      - want_s.view(np.int32))
        assert ulps.max() <= 1
        return
    diff = np.abs(got_v.numpy().astype(np.int32) - want_v.astype(np.int32))
    assert diff.max() <= 1, f"{int((diff > 0).sum())} of {diff.size} differ"
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6)


@pytest.mark.parametrize("N,d,ell,n,bn_stack", LOWRANK_CASES)
def test_batched_lowrank_apply_quantized_matches_pallas(N, d, ell, n,
                                                        bn_stack):
    """The int8 apply: the reference's scale-folded Pallas apply."""
    rng = np.random.default_rng(N * 1000 + d + 7)
    vq = _int8(rng, (N, d, ell))
    scale = (rng.random((N, 1, 1)) / 127).astype(np.float32)
    coeffs = rng.random((N, ell)).astype(np.float32)
    base = rng.random(N).astype(np.float32)
    g = rng.normal(size=(N, d, n)).astype(np.float32)
    apply = jregistry._fold_quantized_apply(
        lambda u, c, b, x, config=None: batched_lowrank_apply_pallas(
            u, c, b, x, bn=16, bn_stack=bn_stack))
    want = apply(*(jnp.asarray(x) for x in (vq, scale, coeffs, base, g)))
    got = registry.batched_lowrank_apply_quantized(
        *(torch.from_numpy(x) for x in (vq, scale, coeffs, base, g)))
    assert got.dtype == torch.float32 and got.shape == (N, d, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(d, "float32"))


def test_int8_entries_on_empty_pool():
    """N = 0 gives empty results of the shapes JAX gives."""
    vq = torch.zeros((0, 8, 3), dtype=torch.int8)
    a = torch.zeros((0, 8, 2))
    c = registry.batched_gram_mixed(vq, torch.zeros((0, 3)), a)
    assert c.shape == (0, 5, 5) == batched_gram_mixed_pallas(
        jnp.zeros((0, 8, 3), jnp.int8), jnp.zeros((0, 3)),
        jnp.zeros((0, 8, 2))).shape
    v, s = registry.batched_project_quantize(vq, torch.zeros((0, 3, 3)), a,
                                             torch.zeros((0, 2, 3)))
    jv, js = batched_project_quantize_pallas(
        jnp.zeros((0, 8, 3), jnp.int8), jnp.zeros((0, 3, 3)),
        jnp.zeros((0, 8, 2)), jnp.zeros((0, 2, 3)))
    assert v.shape == jv.shape and v.dtype == torch.int8
    assert s.shape == js.shape
    y = registry.batched_lowrank_apply_quantized(
        vq, torch.ones((0, 1, 1)), torch.zeros((0, 3)), torch.zeros((0,)),
        torch.zeros((0, 8, 4)))
    assert y.shape == (0, 8, 4)


# (N, d, k, r): the main path's eight write-back shapes (chip_smoke.py
# main_path_shapes: left and right side of each full-width pool group), then
# d no multiple of the 128-row block, r no multiple of the 32-deep panel,
# k = e over the 64-column block
PROJECT_SHAPES = [(68, 1024, 64, 768), (68, 768, 64, 1024), (2, 12, 12, 768),
                  (2, 768, 64, 12), (104, 768, 64, 1024),
                  (104, 1024, 64, 768), (48, 768, 64, 768),
                  (3, 200, 64, 40), (2, 1000, 64, 50), (2, 200, 12, 45),
                  (2, 130, 80, 20)]


@pytest.mark.parametrize("N,d,k,r", PROJECT_SHAPES)
def test_project_plan_covers_and_fits(N, d, k, r):
    """The write-back's pass 1 (``kernel.project_plan``, the launch
    arithmetic csrc/project_quantize.cu mirrors): its tiles cover every row
    of d and column of e = k exactly once and its panels every column of V
    and of A; its blocks, resident at once, cover every (tile, panel) unit
    exactly once; a tile cut among blocks has its parts in distinct slots,
    which the fixup adds in block order; the scratch holds them; its shared
    memory fits a Hopper block."""
    p = lowrank_kernel.project_plan(N, d, k, r, k)
    rows, cols, blocks = p.tiles
    R, C, D = (lowrank_kernel.PROJECT_ROWS, lowrank_kernel.PROJECT_COLS,
               lowrank_kernel.PROJECT_DEPTH)
    assert blocks == N
    assert (rows - 1) * R < d <= rows * R
    assert (cols - 1) * C < k <= cols * C
    nv = p.panels - (r + D - 1) // D
    assert (nv - 1) * D < k <= nv * D
    assert p.smem_bytes <= lowrank_kernel.SMEM_LIMIT
    assert p.threads * 8 * 8 == R * C       # an 8 x 8 tile a thread
    tiles = rows * cols * N
    units = tiles * p.panels
    assert p.blocks == min(units, lowrank_kernel.SMS
                           * lowrank_kernel.PROJECT_BLOCKS_PER_SM)
    assert p.scratch == 2 * p.blocks * R * C + N * d * k + N
    runs = lowrank_kernel.project_runs(units, p.blocks, p.panels)
    covered = sorted((t, q) for block in runs for t, pa, pb, _ in block
                     for q in range(pa, pb))
    assert covered == [(t, q) for t in range(tiles)
                       for q in range(p.panels)]
    slots = {}
    for c, block in enumerate(runs):
        for t, pa, pb, slot in block:
            if slot is not None:
                assert (c, slot) not in slots
                slots[c, slot] = (t, pa)
    for t in range(tiles):
        parts = lowrank_kernel.project_parts(units, p.blocks, p.panels, t)
        mine = sorted((pa, c, s) for (c, s), (tt, pa) in slots.items()
                      if tt == t)
        assert [(c, s) for _, c, s in mine] == parts
def test_project_vector_flags():
    """16-byte accesses only where every row starts 16-byte aligned: V's
    rows are k int8 values (k % 16), A's r floats (r % 4), W's and the
    scratch's e floats (e % 4), and each base aligned."""
    def flags(k, r, e, shift=0):
        vq = torch.zeros(2 * 8 * k + 16, dtype=torch.int8)[shift:][
            :2 * 8 * k].view(2, 8, k)
        return lowrank_kernel.project_vector_flags(
            vq, torch.zeros(2, k, e), torch.zeros(2, 8, r),
            torch.zeros(2, r, e), torch.zeros(2, 8, e))
    assert flags(64, 768, 64) == 0b1111
    assert flags(12, 768, 12) == 0b1110
    assert flags(64, 45, 64) == 0b1101
    assert flags(64, 12, 10) == 0b0011
    assert flags(64, 768, 64, shift=1) == 0b1110


# ---- the batched Grams on the card: 3xTF32 (csrc/gram.cu) -----------------


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """f32 rounded to tf32 (10 stored mantissa bits) to nearest, ties away
    from zero, by bit operations: what ``cvt.rna.tf32.f32`` and
    csrc/hopper.cuh's ``tf32_rna`` give a finite x."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _gram_3xtf32(m: np.ndarray, depth: int = 32) -> np.ndarray:
    """The card's 3xTF32 Gram emulated in f32: x = hi + lo, both rounded
    to tf32; per 32-row chunk hi.lo + lo.hi + hi.hi in f32 (each product
    of two tf32 values is exact in f32), the chunks summed in f32."""
    hi = _tf32_rna(m)
    lo = _tf32_rna(m - hi)
    out = np.zeros((m.shape[1], m.shape[1]), np.float32)
    for r in range(0, m.shape[0], depth):
        h, lw = hi[r:r + depth], lo[r:r + depth]
        out += h.T @ lw + lw.T @ h + h.T @ h
    return out


@pytest.mark.parametrize("x,want", [
    (1 + 2.0 ** -12, 1.0),                  # below half a step: down
    (1 + 2.0 ** -11, 1 + 2.0 ** -10),       # a tie: away from zero
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)),
    (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),    # a tie: away from zero
    (2 - 2.0 ** -23, 2.0),                  # the carry reaches the exponent
    (0.0, 0.0)])
def test_tf32_rounding_is_to_nearest_ties_away(x, want):
    """Documents the rounding that csrc/hopper.cuh's ``tf32_rna`` does, on
    this file's copy of it."""
    got = _tf32_rna(np.float32(x))
    assert float(got) == want
    assert got.view(np.uint32) & 0x1FFF == 0


@pytest.mark.parametrize("d", [768, 1024])
def test_three_tf32_products_hold_the_gram_tolerance(d):
    """Documents the arithmetic the kernel uses, on an emulation: at the
    main path's depths, hi.lo + lo.hi + hi.hi stays within the f32
    tolerance of the float64 Gram (1e-4 sqrt(d) + 1e-5 |C|; here 0.02 of
    it, max abs 2.0e-4 / 2.6e-4), and a single tf32 product does not (9.1x
    / 11.3x over it, max abs 0.043 / 0.045): the reason for three products.
    The emulation sums in f32 where the tensor core's additions round
    more, so the card reads more than this (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(d)
    m = rng.normal(size=(d, 64)).astype(np.float32)
    want = m.astype(np.float64).T @ m.astype(np.float64)
    tol = 1e-4 * np.sqrt(d) + 1e-5 * np.abs(want)
    three = np.abs(_gram_3xtf32(m) - want) / tol
    hi = _tf32_rna(m)
    one = np.abs((hi.T @ hi).astype(np.float64) - want) / tol
    assert three.max() <= 0.1
    assert one.max() > 1.0


GRAM_TILE = 128     # csrc/gram.cu kTile


def _gram_block_tiles(k: int) -> list:
    """(ti, tj) of each block of csrc/gram.cu's grid, in block order: the
    kernel's own enumeration of the upper-triangular tiles, transliterated
    (its first lines)."""
    tiles = -(-k // GRAM_TILE)
    out = []
    for t in range(tiles * (tiles + 1) // 2):
        ti = 0
        while t >= tiles - ti:
            t -= tiles - ti
            ti += 1
        out.append((ti, ti + t))
    return out


@pytest.mark.parametrize("k", [832, 1088, 780, 76, 1, 127, 128, 129, 256,
                               257])
def test_gram_tiles_cover_the_output_once(k):
    """Documents the kernel's tiling, on this file's copy of its
    enumeration: every output element (i, j) of a (k, k) Gram is written
    by exactly one block, the direct store of the tile that holds it when
    i <= j's tile, else the mirrored store of its transpose's tile."""
    writes = np.zeros((k, k), np.int64)
    for ti, tj in _gram_block_tiles(k):
        assert ti <= tj
        rows = slice(ti * GRAM_TILE, min(k, (ti + 1) * GRAM_TILE))
        cols = slice(tj * GRAM_TILE, min(k, (tj + 1) * GRAM_TILE))
        writes[rows, cols] += 1
        if ti != tj:
            writes[cols, rows] += 1
    assert (writes == 1).all()


# ---- the batched apply on the card: 3xTF32 (csrc/lowrank.cu) -------------


def _split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _apply_tf32(u, c, base, g, exact_u: bool, terms: int = 3,
                depth: int = 32) -> np.ndarray:
    """The card's apply emulated in f32: P = c o (U^T G), then
    Y = base G + U P, each product over 32-deep slices of its reduction (d,
    then ell) summed into an f32 total (the promotion).  With three terms,
    hi.lo + lo.hi + hi.hi of the split operands; an int8 U (``exact_u``,
    exact in tf32) takes U.lo + U.hi; one term is hi.hi alone."""
    uh, ul = (u, np.zeros_like(u)) if exact_u else _split(u)
    gh, gl = _split(g)

    def product(ah, al, bh, bl, k):
        out = np.zeros((ah.shape[0], bh.shape[1]), np.float32)
        for i in range(0, k, depth):
            a_h, a_l = ah[:, i:i + depth], al[:, i:i + depth]
            b_h, b_l = bh[i:i + depth], bl[i:i + depth]
            acc = a_h @ b_h
            if terms == 3:
                acc = (a_h @ b_l + a_l @ b_h) + acc
            out += acc
        return out

    p = c[:, None] * product(uh.T, ul.T, gh, gl, u.shape[0])
    ph, pl = _split(p)
    return base * g + product(uh, ul, ph, pl, u.shape[1])


@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("u_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mean", [0.0, 3.0])
def test_three_tf32_products_hold_the_apply_tolerance(d, u_dtype, mean):
    """Documents the apply kernel's arithmetic, on an emulation: at the main
    path's d and ell = 64, on the card tests' data (U normal or int8, whose
    scale^2 the fused path folds into c; G of mean 0 and 3), the promoted
    3xTF32 products (two terms for an int8 U) stay within the f32 tolerance
    1e-4 sqrt(d) + 1e-5 |Y| of float64 (at most 0.10 of it for an f32 U,
    0.014 for an int8 one), and one tf32 product of an f32 U does not."""
    rng = np.random.default_rng(d)
    ell, m = 64, 48
    c = rng.random(ell).astype(np.float32)
    if u_dtype == "int8":
        u = rng.integers(-127, 128, size=(d, ell)).astype(np.float32)
        c *= np.float32((rng.random() / 127) ** 2)
    else:
        u = rng.normal(size=(d, ell)).astype(np.float32)
    g = (rng.normal(size=(d, m)) + mean).astype(np.float32)
    base = np.float32(rng.random())
    u64, g64 = u.astype(np.float64), g.astype(np.float64)
    want = base * g64 + u64 @ (c.astype(np.float64)[:, None] * (u64.T @ g64))
    tol = 1e-4 * np.sqrt(d) + 1e-5 * np.abs(want)
    exact = u_dtype == "int8"
    three = np.abs(_apply_tf32(u, c, base, g, exact) - want) / tol
    assert three.max() <= 0.5
    if not exact:   # (f32 U: 76-207x the tolerance with one product)
        one = np.abs(_apply_tf32(u, c, base, g, exact, terms=1) - want) / tol
        assert one.max() > 1.0
