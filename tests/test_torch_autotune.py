"""The port's autotuner (repro_torch/kernels/autotune.py) and the public
kernel wrappers (kernels/gram/ops.py, kernels/lowrank/ops.py), mirroring
tests/test_autotune.py:61-241 where it applies.

On the CPU nothing launches, so the measured search is not run here (the
card tests and chip_smoke.py's tune phase run every candidate against its
plain version): ``force`` mode is held with the search replaced by a stub
that picks the last candidate.  What is held: the candidate sets (default
first, no duplicates, each a fixpoint of ``effective`` and launchable: a
column tile whose shared memory fits, a block count within the shape's
units), the defaults equal to the kernels' own choices (the widest tile
that fits, ``project_plan``'s blocks), the write-back's stream-K partition
at every candidate block count (tests/test_torch_kernels.py's invariants),
the modes off / auto / force, a cache round trip, the committed fixture
against the candidate space, the refusal of configs outside it, the CLI
(``_main``), and that a CPU tensor ignores a config (the plain version, to the bit).
"""
import json
import os

import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro_torch.kernels import autotune, registry
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.lowrank import kernel as lowrank_kernel
from repro_torch.kernels.lowrank import ops as lowrank_ops
from repro_torch.kernels.lowrank import ref as lowrank_ref

H100 = "NVIDIA H100 80GB HBM3"

# (kernel, shape, dtype): the main path's shapes of each tunable kernel, a
# wide ell, and small and ragged ones
SPECS = [("batched_lowrank_apply", (68, 1024, 64, 768), "float32"),
         ("batched_lowrank_apply", (104, 768, 64, 1024), "int8"),
         ("batched_lowrank_apply", (2, 12, 12, 768), "float32"),
         ("batched_lowrank_apply", (3, 300, 700, 40), "float32"),
         ("batched_lowrank_apply", (3, 300, 1984, 40), "int8"),
         ("batched_project_quantize", (68, 1024, 64, 768, 64), "int8"),
         ("batched_project_quantize", (2, 12, 12, 768, 12), "int8"),
         ("batched_project_quantize", (3, 200, 64, 40, 64), "int8"),
         ("batched_gram", (68, 1024, 128), "float32"),
         ("batched_gram_mixed", (68, 1024, 64, 768), "int8")]


@pytest.fixture(autouse=True)
def _restore_tune_state():
    """Every test leaves the process-wide tune state as it found it."""
    yield
    autotune.reload(path=autotune.DEFAULT_CACHE_PATH, mode="auto")


# ------------------------------------------------------------ candidate space


@pytest.mark.parametrize("kernel,shape,dtype", SPECS)
def test_candidates_dedupe_and_default_first(kernel, shape, dtype):
    cands = autotune.candidates(kernel, shape, dtype)
    assert cands[0] == autotune.effective(kernel, shape,
                                          autotune.DEFAULT_CONFIG, dtype)
    assert len(cands) == len(set(cands))
    for c in cands:
        assert autotune.effective(kernel, shape, c, dtype) == c
    if kernel == "batched_lowrank_apply":
        usize = autotune.DTYPES[dtype]
        fits = lowrank_kernel.apply_col_tiles(shape[2], usize)
        assert [c.col_tile for c in cands] == list(fits)
        assert all(c.blocks == 0 for c in cands)
        for t in fits:
            assert lowrank_kernel.apply_smem_bytes(shape[2], t, usize) \
                <= lowrank_kernel.SMEM_LIMIT
    elif kernel == "batched_project_quantize":
        units = autotune._project_units(shape)
        assert all(c.col_tile == 0 and 0 < c.blocks <= units for c in cands)
        assert {c.blocks for c in cands} == {
            min(b, units) for b in autotune.PROJECT_BLOCKS} | {
            cands[0].blocks}
    else:       # fixed 128 x 128 tiles: the default alone
        assert cands == [autotune.DEFAULT_CONFIG]


def test_defaults_are_the_kernels_own_choices():
    """The apply's widest column tile that fits (64 up to ell 256 for an
    f32 U, 8 alone at the largest ell), the write-back's resident
    blocks."""
    tile = lambda ell, dt: autotune.effective(
        "batched_lowrank_apply", (1, 8, ell, 8), autotune.DEFAULT_CONFIG,
        dt).col_tile
    assert tile(64, "float32") == tile(256, "float32") == 64
    assert tile(300, "float32") == 32
    assert tile(lowrank_kernel.BATCHED_MAX_ELL, "float32") == 8
    assert tile(lowrank_kernel.BATCHED_MAX_ELL, "int8") == 8
    for shape in [(68, 1024, 64, 768, 64), (2, 12, 12, 768, 12)]:
        assert autotune.effective("batched_project_quantize", shape,
                                  autotune.DEFAULT_CONFIG).blocks == \
            lowrank_kernel.project_plan(*shape).blocks


def test_effective_clamps_to_what_launches():
    eff = lambda k, s, c, dt="float32": autotune.effective(k, s, c, dt)
    T = autotune.TileConfig
    assert eff("batched_lowrank_apply", (1, 8, 300, 8), T(col_tile=64)) == \
        T(col_tile=32)
    assert eff("batched_lowrank_apply", (1, 8, 64, 8), T(col_tile=24)) == \
        T(col_tile=16)
    assert eff("batched_lowrank_apply", (1, 8, 64, 8), T(blocks=5)) == \
        T(col_tile=64)
    assert eff("batched_project_quantize", (2, 12, 12, 768, 12),
               T(col_tile=8, blocks=528)) == T(blocks=50)
    assert eff("batched_gram", (4, 16, 8), T(col_tile=8, blocks=3)) == T()
    with pytest.raises(ValueError, match="unknown kernel"):
        autotune.effective("gram", (4, 16, 8), T())
    with pytest.raises(ValueError, match="3-dim shape"):
        autotune.effective("batched_gram", (4, 16), T())


@pytest.mark.parametrize("shape", [s for k, s, _ in SPECS
                                   if k == "batched_project_quantize"])
def test_project_partition_at_every_candidate(shape):
    """At each candidate block count the write-back's pass 1 covers every
    (tile, panel) unit once, a tile cut among blocks has its parts in
    distinct slots, which the fixup adds in block order, and the scratch
    holds them (tests/test_torch_kernels.py's invariants at the default)."""
    N, d, k, r, e = shape
    R, C = lowrank_kernel.PROJECT_ROWS, lowrank_kernel.PROJECT_COLS
    for cand in autotune.candidates("batched_project_quantize", shape):
        p = lowrank_kernel.project_plan(N, d, k, r, e, cand.blocks)
        assert p.blocks == cand.blocks
        assert p.scratch == 2 * p.blocks * R * C + N * d * e + N
        tiles = p.tiles[0] * p.tiles[1] * p.tiles[2]
        units = tiles * p.panels
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
    with pytest.raises(ValueError, match="blocks"):
        lowrank_kernel.project_plan(N, d, k, r, e, 10 ** 9)


# ------------------------------------------------------------------ tune modes


def _write_cache(path, entries):
    data = {"version": autotune.CACHE_VERSION,
            "entries": {k: dict(v._asdict()) for k, v in entries.items()}}
    with open(path, "w") as f:
        json.dump(data, f)


APPLY = ("batched_lowrank_apply", (68, 1024, 64, 768), "float32")


def test_key_names_the_card_and_round_trips():
    key = autotune.key_for(*APPLY, device=H100)
    assert key == f"{H100}|batched_lowrank_apply|68x1024x64x768|float32"
    assert autotune.parse_key(key) == (H100,) + APPLY
    assert autotune.key_for(*APPLY[:2], torch.int8, device=H100).endswith(
        "|int8")
    # this host has no card: its lookups are keyed "cpu"
    assert autotune.key_for(*APPLY).startswith("cpu|")
    for bad in ("a|b|c", "x|batched_gram|4xq|float32"):
        with pytest.raises(ValueError, match="malformed"):
            autotune.parse_key(bad)


def test_mode_off_pins_defaults(tmp_path):
    cache = str(tmp_path / "cache.json")
    _write_cache(cache, {autotune.key_for(*APPLY):
                         autotune.TileConfig(col_tile=16)})
    autotune.reload(path=cache, mode="off")
    assert autotune.get_config(*APPLY) == autotune.TileConfig(col_tile=64)


def test_mode_auto_hit_and_miss(tmp_path):
    cache = str(tmp_path / "cache.json")
    _write_cache(cache, {autotune.key_for(*APPLY):
                         autotune.TileConfig(col_tile=16)})
    autotune.reload(path=cache, mode="auto")
    assert autotune.get_config(*APPLY) == autotune.TileConfig(col_tile=16)
    before = os.path.getmtime(cache)
    miss = ("batched_lowrank_apply", (9, 24, 6, 5), "float32")
    assert autotune.get_config(*miss) == autotune.TileConfig(col_tile=64)
    assert os.path.getmtime(cache) == before
    # another card's entry is not this host's
    _write_cache(cache, {autotune.key_for(*APPLY, device=H100):
                         autotune.TileConfig(col_tile=16)})
    autotune.reload(path=cache, mode="auto")
    assert autotune.get_config(*APPLY) == autotune.TileConfig(col_tile=64)


def test_mode_force_tunes_and_persists(tmp_path, monkeypatch):
    calls = []

    def search(kernel, shape, dtype):
        calls.append((kernel, shape))
        cands = autotune.candidates(kernel, shape, dtype)
        return cands[-1], {c: 1.0 for c in cands}

    monkeypatch.setattr(autotune, "tune", search)
    cache = str(tmp_path / "sub" / "cache.json")
    autotune.reload(path=cache, mode="force")
    cfg = autotune.get_config(*APPLY)
    assert cfg == autotune.TileConfig(col_tile=8)
    with open(cache) as f:
        data = json.load(f)
    assert autotune.validate_cache(data) == []
    assert list(data["entries"]) == [autotune.key_for(*APPLY)]
    assert autotune.get_config(*APPLY) == cfg
    assert len(calls) == 1           # resolved once, then kept


def test_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(autotune, "tune", lambda k, s, d: (
        autotune.candidates(k, s, d)[1], {}))
    cache = str(tmp_path / "cache.json")
    autotune.reload(path=cache, mode="force")
    specs = [APPLY, ("batched_project_quantize", (68, 1024, 64, 768, 64),
                     "int8")]
    tuned = autotune.tune_into_cache(specs, path=cache)
    entries = dict(autotune._resolve()["entries"])
    autotune.reload(path=cache, mode="auto")
    assert autotune._resolve()["entries"] == entries == tuned
    for spec in specs:
        assert autotune.get_config(*spec) == tuned[autotune.key_for(*spec)]
    autotune.reload(path=str(tmp_path / "other.json"), mode="auto")
    assert autotune._resolve()["entries"] == {}
    assert autotune.get_config(*APPLY) == autotune.TileConfig(col_tile=64)


def test_search_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        autotune.tune(*APPLY)


# -------------------------------------------------------- fixture and schema


def test_committed_fixture_validates():
    assert os.path.exists(autotune.DEFAULT_CACHE_PATH), \
        "committed tune_cache.json fixture is missing"
    with open(autotune.DEFAULT_CACHE_PATH) as f:
        data = json.load(f)
    assert autotune.validate_cache(data) == []
    for key in data["entries"]:
        dev, kernel, _, _ = autotune.parse_key(key)
        assert dev != "cpu" and kernel in ("batched_lowrank_apply",
                                           "batched_project_quantize")


@pytest.mark.parametrize("key,config,match", [
    (f"{H100}|batched_lowrank_apply|68x1024x64x768|float32",
     {"col_tile": 24, "blocks": 0}, "outside the candidate space"),
    (f"{H100}|batched_lowrank_apply|68x1024x64x768|float32",
     {"col_tile": 64, "blocks": 132}, "outside the candidate space"),
    (f"{H100}|batched_lowrank_apply|1x8x1984x8|float32",
     {"col_tile": 64, "blocks": 0}, "outside the candidate space"),
    (f"{H100}|batched_project_quantize|2x12x12x768x12|int8",
     {"col_tile": 0, "blocks": 132}, "outside the candidate space"),
    (f"{H100}|batched_gram|4x16x8|float32",
     {"col_tile": 8, "blocks": 0}, "outside the candidate space"),
    (f"{H100}|gram|4x16x8|float32", {"col_tile": 0, "blocks": 0},
     "unknown kernel"),
    (f"{H100}|batched_gram|4x16|float32", {"col_tile": 0, "blocks": 0},
     "3-dim shape"),
    (f"{H100}|batched_gram|4x16x8|bfloat16", {"col_tile": 0, "blocks": 0},
     "unknown dtype"),
    (f"{H100}|batched_gram|4x16x8|float32", {"bn_stack": 1, "bk": 128,
                                             "bd": 256, "bn": 256},
     "config fields"),
    (f"{H100}|batched_gram|4x16x8|float32", {"col_tile": 0.5, "blocks": 0},
     "ints"),
    ("cpu|batched_gram|4x16x8", {"col_tile": 0, "blocks": 0}, "malformed")])
def test_validate_cache_rejects(key, config, match):
    bad = {"version": autotune.CACHE_VERSION, "entries": {key: config}}
    problems = autotune.validate_cache(bad)
    assert len(problems) == 1 and match in problems[0], problems


def test_validate_cache_rejects_a_bad_root_or_version():
    assert autotune.validate_cache([]) == \
        ["cache root must be an object, got list"]
    assert autotune.validate_cache({"version": 2, "entries": {}}) == \
        ["version 2 != 1"]


def test_loading_a_bad_cache_raises(tmp_path):
    cache = tmp_path / "bad.json"
    cache.write_text(json.dumps({"version": 1, "entries": {
        f"{H100}|batched_gram|4x16x8|float32": {"col_tile": 8,
                                                "blocks": 0}}}))
    with pytest.raises(ValueError, match="invalid tune cache"):
        autotune.reload(path=str(cache))


def test_cli_validate_and_show(tmp_path, capsys):
    """``python -m repro_torch.kernels.autotune`` (its ``_main``, in this
    process): validate passes on the fixture and fails on a cache outside
    the candidate space; show prints each entry."""
    assert autotune._main(["validate"]) == 0
    assert "tune cache OK" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "entries": {
        f"{H100}|batched_gram|4x16x8|float32": {"col_tile": 8,
                                                "blocks": 0}}}))
    assert autotune._main(["validate", "--cache", str(bad)]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert autotune._main(["show"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == len(json.load(open(
        autotune.DEFAULT_CACHE_PATH))["entries"])


# ------------------------------------------- the wrappers on a CPU tensor


def _apply_operands(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    N, d, ell, n = 3, 20, 6, 10
    u = torch.randn(N, d, ell, generator=g)
    if dtype == torch.int8:
        u = u.mul(40).round().clamp(-127, 127).to(torch.int8)
    return (u, torch.randn(N, ell, generator=g),
            torch.rand(N, generator=g), torch.randn(N, d, n, generator=g))


@pytest.mark.parametrize("config", [None, autotune.TileConfig(col_tile=8),
                                    autotune.TileConfig(blocks=132)])
def test_a_cpu_tensor_ignores_the_config(config):
    """The plain version has no tiles: every entry, through the registry
    and through the ops wrappers, gives its plain version's bits whatever
    the config."""
    u, c, b, g = _apply_operands()
    want = lowrank_ref.batched_lowrank_apply_ref(u, c, b, g)
    for fn in (registry.batched_lowrank_apply,
               lowrank_ops.batched_lowrank_apply):
        assert torch.equal(fn(u, c, b, g, config=config), want)
    vq = _apply_operands(torch.int8)[0]
    scale = torch.rand(3, 1, 1) + 0.5
    want = lowrank_ref.batched_lowrank_apply_quantized_ref(vq, scale, c, b, g)
    assert torch.equal(lowrank_ops.batched_lowrank_apply_quantized(
        vq, scale, c, b, g, config=config), want)
    gen = torch.Generator().manual_seed(1)
    w_top = torch.randn(3, 6, 6, generator=gen) * 0.01
    a = torch.randn(3, 20, 4, generator=gen)
    w_bot = torch.randn(3, 4, 6, generator=gen)
    got = lowrank_ops.batched_project_quantize(vq, w_top, a, w_bot,
                                               config=config)
    want = lowrank_ref.batched_project_quantize_ref(vq, w_top, a, w_bot)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(gram_ops.batched_gram(g, config=config),
                       gram_ref.batched_gram_ref(g))
    colw = torch.rand(3, 6, generator=gen)
    assert torch.equal(gram_ops.batched_gram_mixed(vq, colw, g,
                                                   config=config),
                       gram_ref.batched_gram_mixed_ref(vq, colw, g))
    assert torch.equal(gram_ops.gram(g[0]), gram_ref.gram_ref(g[0]))
    np.testing.assert_array_equal(
        lowrank_ops.lowrank_apply(u[0], c[0], 1.5, g[0]).numpy(),
        lowrank_ref.lowrank_apply_ref(u[0], c[0], 1.5, g[0]).numpy())
