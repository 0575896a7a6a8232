"""What the card's kernels take since they left the limits of a 2-D grid,
of causal attention with S == Sk and of the instantiated head dims,
checked here on the CPU:

(a) kernel 7's plain path (the CPU route of the kernel set) against the
reference's ``attention_ref`` on the same numpy inputs (made from a seed):
causal with S < Sk and S > Sk (rows that see no key are the uniform mean
of V over the keys, not 0 and not NaN), and head dims 8, 40, 72 and 200,
GQA and MHA, in f32 (``atol = 2e-5``) and bf16 (0.05 on the f32 upcast
inputs), the tolerances of tests/test_torch_flash.py;
(b) the launch arithmetic, plain Python mirrored by csrc/: the batched
Grams' one-dimensional grid, the batched apply's grid of N in y slices of
65,535 over z, and the write-back's plan at N 70,000 (one launch, within
the grid's limits, over them raises), the SSD scan's grids at 70,000 batch rows, the autotuner's keys
and candidates at such an N, and kernel 7's padded width, tiles and shared
memory at head dims 8 to 256;
(c) past the kernels' old capacity limits: the plain versions against the
reference's ``ref.py`` functions at SSD P 128 and N 256, attention hd 320,
the batched and single-block applies at ell 2,100 (small d), and each in
float16 (f32 tolerances in f32; in fp16 the bf16 ones: the scan 0.15,
attention 0.05, the Gram and apply 10x the f32's), and the wrappers' new
plans: kernel 8's slices of P and chunks of N and its scratch, kernel 7's
wide kernel past hd 256, the batched apply's ell chunks (the same single
chunk up to 1,984, then chunks of 256 at the widest column tile), the
single apply's chunks and its 227 KB of shared memory up to ell 7,264.
Only float64 and grids past the card's limits raise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.kernels.flash.ref import attention_ref as jattention_ref
from repro.kernels.gram.ref import batched_gram_ref as jbatched_gram_ref
from repro.kernels.lowrank.ref import (
    batched_lowrank_apply_ref as jbatched_apply_ref,
    lowrank_apply_ref as jlowrank_apply_ref)
from repro.kernels.ssd.ref import ssd_ref as jssd_ref
from repro_torch.kernels import autotune, registry
from repro_torch.kernels.flash import kernel as fkernel
from repro_torch.kernels.gram import kernel as gkernel
from repro_torch.kernels.lowrank import kernel as lkernel
from repro_torch.kernels.ssd import kernel as skernel

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05),
          "float16": (jnp.float16, torch.float16, 0.05)}
BIG = 70_000


def _attention(B, Hq, Hkv, S, Sk, hd, dtype, causal, seed):
    jdt, tdt, atol = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, S, hd)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    got = registry.flash_attention(tq, tk, tv, causal=causal)
    # the reference's oracle on the inputs' f32 upcast
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv))
    want = np.asarray(jattention_ref(jq, jk, jv, causal=causal))
    assert got.dtype == tdt and got.shape == (B, Hq, S, hd)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)
    return got, tv


@pytest.mark.parametrize("S,Sk", [(64, 192), (128, 300), (192, 64),
                                  (5, 3)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_causal_attention_with_s_not_sk(S, Sk, dtype):
    got, v = _attention(2, 4, 2, S, Sk, 16, dtype, True, S * Sk)
    assert torch.isfinite(got.float()).all()
    if S > Sk:      # the first S - Sk rows see no key: the mean of V
        mean = v.float().mean(dim=2, keepdim=True).repeat_interleave(2, 1)
        np.testing.assert_allclose(
            got[:, :, :S - Sk].float().numpy(),
            mean.expand(-1, -1, S - Sk, -1).numpy(),
            atol=DTYPES[dtype][2], rtol=0)


@pytest.mark.parametrize("hd", [8, 40, 72, 200])
@pytest.mark.parametrize("Hkv", [2, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_attention_at_any_head_dim(hd, Hkv, dtype):
    _attention(1, 8, Hkv, 40, 40, hd, dtype, True, hd)
    _attention(1, 8, Hkv, 24, 33, hd, dtype, False, hd + 1)


@pytest.mark.parametrize("hd,width", [(1, 16), (8, 16), (16, 16), (40, 48),
                                      (72, 80), (100, 112), (128, 128),
                                      (129, 256), (144, 256), (200, 256),
                                      (240, 256), (256, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_pads_any_head_dim(hd, width, dtype):
    assert fkernel.padded_head_dim(hd) == width
    assert width in fkernel.HEAD_DIMS
    p = fkernel.plan(dtype, 2, 8, 130, hd)
    assert p.width == width
    assert p == fkernel.plan(dtype, 2, 8, 130, width)._replace(width=width)
    assert p.smem_bytes <= fkernel.SMEM_LIMIT


def test_flash_plan_refuses_head_dims_past_256():
    """Since the wide kernel, only a head dim below 1 and float64 raise (the
    name is the one the test had when hd past 256 raised): hd 257 and 512
    plan the wide kernel, test_flash_plan_takes_any_head_dim."""
    with pytest.raises(ValueError, match="head dim"):
        fkernel.padded_head_dim(0)
    with pytest.raises(ValueError, match="head dim"):
        fkernel.plan(torch.bfloat16, 1, 2, 64, 0)
    with pytest.raises(TypeError):
        fkernel.plan(torch.float64, 1, 2, 64, 64)
    for hd in (257, 512):
        assert fkernel.plan(torch.bfloat16, 1, 2, 64, hd).kernel == "wide"


@pytest.mark.parametrize("hd,chunked", [(8, True), (40, True), (72, True),
                                        (100, False), (144, True),
                                        (200, True), (240, True)])
def test_flash_chunks_rows_of_whole_16_bytes(hd, chunked):
    """The model's (B, S, H, hd) bf16 views take 16-byte chunks exactly
    when a row of hd is a whole number of 16 bytes."""
    x = torch.zeros(2, 16, 4, hd, dtype=torch.bfloat16).transpose(1, 2)
    assert fkernel.check_aligned(x, x.stride()) is chunked


@pytest.mark.parametrize("k,tri", [(8, 1), (128, 1), (129, 3), (1088, 45)])
def test_gram_grid_is_one_dimensional(k, tri):
    assert gkernel.gram_grid(1, k) == tri
    assert gkernel.gram_grid(BIG, k) == BIG * tri
    assert gkernel.gram_grid(65_536 + 1_000, 8) == 66_536


def test_gram_grid_raises_past_the_x_limit():
    n = gkernel.MAX_GRID_X // 45
    assert gkernel.gram_grid(n, 1088) <= gkernel.MAX_GRID_X
    with pytest.raises(ValueError, match="grid"):
        gkernel.gram_grid(n + 1, 1088)


@pytest.mark.parametrize("ell,m,usize,tile,grid", [
    (8, 12, 4, 0, (1, 65_535, 2)), (64, 768, 4, 0, (12, 65_535, 2)),
    (64, 768, 4, 8, (96, 65_535, 2)), (64, 768, 1, 0, (12, 65_535, 2)),
    (1300, 20, 4, 0, (3, 65_535, 2))])
def test_apply_grid_slices_the_blocks(ell, m, usize, tile, grid):
    """N on y in slices of 65,535 and the slices on z: every block once."""
    assert lkernel.apply_grid(BIG, ell, m, usize, tile) == grid
    assert grid[1] * (grid[2] - 1) < BIG <= grid[1] * grid[2]
    assert lkernel.apply_grid(48, ell, m, usize, tile) == (grid[0], 48, 1)
    with pytest.raises(ValueError, match="grid"):
        lkernel.apply_grid(65_535 ** 2 + 1, ell, m, usize, tile)


@pytest.mark.parametrize("N,d,k,r,e", [(BIG, 16, 8, 4, 8),
                                       (65_536 + 1_000, 16, 8, 4, 8),
                                       (BIG, 768, 64, 768, 64)])
def test_project_plan_at_many_blocks(N, d, k, r, e):
    """The write-back's stream-K blocks stay the card's resident count
    whatever N; its fixup grid is one block a tile."""
    p = lkernel.project_plan(N, d, k, r, e)
    assert p.tiles[2] == N
    assert p.blocks == lkernel.SMS * lkernel.PROJECT_BLOCKS_PER_SM
    units = p.tiles[0] * p.tiles[1] * N * p.panels
    assert lkernel.project_plan(N, d, k, r, e, units).blocks == units
    with pytest.raises(ValueError):
        lkernel.project_plan(N, d, k, r, e, units + 1)


@pytest.mark.parametrize("B,S,H,P,N,chunk,want", [
    # 70,000 rows of 40 positions in chunks of 16: 3 chunks, head tiles of
    # 4 at Q 16
    (BIG, 40, 2, 16, 16, 16, (3, 16, 3 * 1 * 1 * BIG, 2 * 2 * BIG,
                              -(-BIG * 2 * 16 * 16 // 4 // 256))),
    # mamba2-370m's training shape (B 8, S 128, 32 heads of 64, N 128,
    # chunk 256): one chunk, no state phases
    (8, 128, 32, 64, 128, 256, (1, 128, 2 * 16 * 8, 0, 0)),
    (BIG, 16, 32, 64, 128, 256, (1, 16, 8 * BIG, 0, 0))])
def test_ssd_plan_takes_more_than_65535_rows(B, S, H, P, N, chunk, want):
    assert tuple(skernel.plan(B, S, H, P, N, chunk)) == want


def test_ssd_plan_raises_past_the_x_limit():
    with pytest.raises(ValueError, match="grid"):
        skernel.plan(2**27, 4096, 32, 64, 128, 256)


@pytest.mark.parametrize("kernel,shape", [
    ("batched_lowrank_apply", (BIG, 16, 8, 12)),
    ("batched_project_quantize", (BIG, 16, 8, 4, 8))])
def test_autotune_keys_and_candidates_at_many_blocks(kernel, shape):
    key = autotune.key_for(kernel, shape, "float32", device="NVIDIA H100")
    assert autotune.parse_key(key) == ("NVIDIA H100", kernel, shape,
                                       "float32")
    cands = autotune.candidates(kernel, shape)
    assert cands and cands[0] == autotune.effective(kernel, shape,
                                                    autotune.TileConfig())
    if kernel == "batched_project_quantize":
        for c in cands:
            assert lkernel.project_plan(*shape, c.blocks).blocks == c.blocks
    else:
        for c in cands:
            x, y, z = lkernel.apply_grid(shape[0], shape[2], shape[3], 4,
                                         c.col_tile)
            assert y * z >= shape[0] and z <= lkernel.MAX_GRID_YZ


@pytest.mark.parametrize("hd,width,slices", [(257, 320, 3), (264, 320, 3),
                                             (320, 320, 3), (512, 512, 4),
                                             (1000, 1024, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_plan_takes_any_head_dim(hd, width, slices, dtype):
    """Past hd 256 every dtype runs on the wide kernel: 64 query rows and
    256 threads a block, ceil(hd / 128) blocks a query tile (O's column
    slices), 82 KB of shared memory whatever hd; up to 256 bf16 and fp16
    share the wgmma plan."""
    p = fkernel.plan(dtype, 2, 8, 130, hd)
    assert (p.kernel, p.block_m, p.threads, p.width) == ("wide", 64, 256,
                                                         width)
    assert p.grid == (3 * slices, 8, 2)
    assert p.smem_bytes == 4 * (3 * 64 * 65 + 64 * 128) <= fkernel.SMEM_LIMIT
    half = fkernel.plan(torch.float16, 2, 8, 130, 128)
    assert half._replace(kernel="wgmma_bf16") == \
        fkernel.plan(torch.bfloat16, 2, 8, 130, 128)
    with pytest.raises(ValueError, match="grid"):
        fkernel.plan(dtype, 70_000, 2, 64, hd)


@pytest.mark.parametrize("P,N,want", [
    (16, 128, [(0, 16, 16)]), (64, 64, [(0, 64, 64)]),
    (16, 129, [(0, 64, 16)]), (8, 1, [(0, 64, 8)]), (48, 96, [(0, 64, 48)]),
    (100, 64, [(0, 64, 64), (64, 64, 36)]),
    (128, 256, [(0, 64, 64), (64, 64, 64)]),
    (192, 16, [(0, 64, 64), (64, 64, 64), (128, 64, 64)])])
def test_ssd_slices_cover_any_p(P, N, want):
    """P in {16, 32, 64} with N <= 128 whole (the kernels as they were);
    any other in 64-wide slices, the last one's columns past P zero; every
    column of P in exactly one slice."""
    got = skernel.slices(P, N)
    assert got == want
    assert skernel.is_whole(P, N) == (len(want) == 1 and want[0][1] == P)
    cols = [p0 + c for p0, _, valid in got for c in range(valid)]
    assert cols == list(range(P))
    assert skernel.state_rows(P, N) == sum(w for _, w, _ in want)


@pytest.mark.parametrize("N,want", [(1, [(0, 1)]), (96, [(0, 96)]),
                                    (128, [(0, 128)]),
                                    (256, [(0, 128), (128, 128)]),
                                    (384, [(0, 128), (128, 128), (256, 128)]),
                                    (300, [(0, 128), (128, 128), (256, 44)])])
def test_ssd_state_chunks_cover_any_n(N, want):
    assert skernel.state_chunks(N) == want


def test_ssd_plan_at_any_p_and_n():
    """The state pass runs over the scratch's state_rows(P) rows; P and N
    change no other grid (phases 1 and 3 launch once a slice and chunk)."""
    base = skernel.plan(2, 40, 3, 64, 64, 16)
    for P, N in ((8, 1), (48, 96), (128, 256), (192, 384)):
        p = skernel.plan(2, 40, 3, P, N, 16)
        assert p[:4] == base[:4]
        assert p.pass_blocks == -(-2 * 3 * skernel.state_rows(P, N) * N // 4
                                  // 256)


@pytest.mark.parametrize("ell,chunks,last", [
    (64, 1, 64), (1984, 1, 1984), (1985, 8, 193), (2100, 9, 52),
    (4000, 16, 160), (4096, 16, 256)])
def test_batched_apply_chunks_any_ell(ell, chunks, last):
    """One chunk up to 1,984 (the kernel as it was); past it chunks of 256
    columns, the rest last, each at the widest column tile (64)."""
    got = lkernel.apply_chunks(ell)
    assert len(got) == chunks and got[-1][1] == last
    assert [e0 for e0, _ in got] == [i * (ell if chunks == 1 else 256)
                                     for i in range(chunks)]
    assert sum(c for _, c in got) == ell
    tiles = lkernel.apply_col_tiles(ell, 4)
    assert tiles and all(
        lkernel.apply_smem_bytes(c, t, 4) <= lkernel.SMEM_LIMIT
        for _, c in got for t in tiles)
    if chunks > 1:
        assert tiles[0] == 64 == lkernel.apply_col_tiles(ell, 1)[0]
    assert lkernel.apply_grid(3, ell, 40, 4)[1:] == (3, 1)


@pytest.mark.parametrize("ell,want", [(8, [(0, 8)]), (1025, [(0, 1025)]),
                                      (7264, [(0, 7264)]),
                                      (8192, [(0, 7264), (7264, 928)])])
def test_single_apply_chunks_any_ell(ell, want):
    """The expand pass holds ell x 8 f32 of P: up to the card's 227 KB in
    one launch (ell 7,264), in chunks past it."""
    assert lkernel.tall_chunks(ell) == want
    assert 4 * 8 * lkernel.MAX_ELL <= lkernel.SMEM_LIMIT \
        < 4 * 8 * (lkernel.MAX_ELL + 1)


def _np(*shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("P,N", [(128, 256), (48, 96), (8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_plain_ssd_at_any_p_and_n(P, N, dtype):
    """Three chunks of 16 at S 40 against the reference's ``ssd_ref`` (the
    model's chunked scan) on the inputs' f32 upcast."""
    B, S, H, chunk = 2, 40, 3, 16
    s = min(1.0, (64 / N) ** 0.5)
    u = _np(B, S, H, P, seed=1, scale=0.5)
    dlog = -np.abs(_np(B, S, H, seed=2, scale=0.1))
    Bm, Cm = _np(B, S, N, seed=3, scale=0.3 * s), \
        _np(B, S, N, seed=4, scale=0.3 * s)
    tdt = getattr(torch, dtype)
    tu, tB, tC = (torch.from_numpy(x).to(tdt) for x in (u, Bm, Cm))
    got = registry.ssd_scan(tu, torch.from_numpy(dlog), tB, tC, chunk)
    assert got.dtype == tdt and got.shape == (B, S, H, P)
    want = np.asarray(jssd_ref(*(jnp.asarray(t.float().numpy())
                                 for t in (tu, torch.from_numpy(dlog), tB,
                                           tC)), chunk=chunk))
    atol = 5e-6 * S if dtype == "float32" else 0.15
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("Hkv", [2, 8])
def test_plain_attention_past_head_dim_256(dtype, Hkv):
    _attention(1, 8, Hkv, 24, 24, 320, dtype, True, 320)
    _attention(1, 8, Hkv, 24, 33, 320, dtype, False, 321)


@pytest.mark.parametrize("hd", [8, 72, 200])
def test_plain_attention_in_fp16(hd):
    _attention(2, 4, 2, 40, 40, hd, "float16", True, hd)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_plain_applies_and_gram_past_their_old_limits(dtype):
    """The batched apply at ell 2,100 and the single apply at ell 2,100
    (d 24, so the products stay small) against the reference's plain
    versions, and the batched Gram in the dtype, at the f32 tolerance
    ``1e-4 sqrt(d)`` (fp16 inputs: 10x)."""
    d, ell, n = 24, 2100, 5
    scale = 1 if dtype == "float32" else 10
    tol = dict(rtol=1e-5 * scale, atol=1e-4 * np.sqrt(d) * scale)
    u = _np(2, d, ell, seed=5, scale=ell ** -0.5)
    c = np.abs(_np(2, ell, seed=6))
    b = np.abs(_np(2, seed=7))
    g = _np(2, d, n, seed=8)
    got = registry.batched_lowrank_apply(*(torch.from_numpy(x)
                                           for x in (u, c, b, g)))
    want = jbatched_apply_ref(*(jnp.asarray(x) for x in (u, c, b, g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    tg = torch.from_numpy(g[0]).to(getattr(torch, dtype))
    got = registry.lowrank_apply(torch.from_numpy(u[0]),
                                 torch.from_numpy(c[0]), float(b[0]), tg)
    assert got.dtype == tg.dtype
    want = jlowrank_apply_ref(jnp.asarray(u[0]), jnp.asarray(c[0]),
                              float(b[0]), jnp.asarray(tg.float().numpy()))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=max(tol["rtol"],
                                        float(torch.finfo(tg.dtype).eps)),
                               atol=tol["atol"])
    a = torch.from_numpy(_np(3, 40, 20, seed=9)).to(getattr(torch, dtype))
    got = registry.batched_gram(a)
    want = jbatched_gram_ref(jnp.asarray(a.float().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
