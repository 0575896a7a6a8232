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
memory at head dims 8 to 256 (over 256 raises).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro.kernels.flash.ref import attention_ref as jattention_ref
from repro_torch.kernels import autotune, registry
from repro_torch.kernels.flash import kernel as fkernel
from repro_torch.kernels.gram import kernel as gkernel
from repro_torch.kernels.lowrank import kernel as lkernel
from repro_torch.kernels.ssd import kernel as skernel

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.05)}
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
    for hd in (0, 257, 512):
        with pytest.raises(ValueError, match="head dim"):
            fkernel.padded_head_dim(hd)
        with pytest.raises(ValueError, match="head dim"):
            fkernel.plan(torch.bfloat16, 1, 2, 64, hd)


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
