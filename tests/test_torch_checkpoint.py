"""The port's checkpoints (repro_torch/train/checkpoint.py) on their own.

The six cases of the reference's tests/test_checkpoint.py on the port (a
round trip with ``extra``, no ``tmp-`` left, GC keeps three, the latest and
a given step, the asynchronous checkpointer, a structure mismatch refused),
and: a role mismatch refused; bf16 leaves round trip in a process that
imports neither JAX nor ml_dtypes, and a bf16 record that ml_dtypes wrote
reads the same; the step counts come back as Python ints; the asynchronous
snapshot is a copy (the live state changed after ``save`` returns, before
the write, leaves the files as they were); the optimizer states of every
storage, mode, budget and optimizer come back bit for bit with their
dtypes and shapes; the pending slot is neither written nor counted, comes
back empty with ``valid=False``, and an inline and an async checkpoint of
the same run have the same manifest and restore into each other's mode;
the two migration shims (storage, fixed rank into a budget).  Everything
is exact: no tolerance.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import api, quantize
from repro_torch.core.factory import OptimizerConfig, make_optimizer
from repro_torch.core.sketchy import RankBudget
from repro_torch.models import model as model_lib
from repro_torch.train import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.normal(size=(8, 4)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.normal(size=(4,)).astype(np.float32))},
            "opt": (torch.from_numpy(
                rng.normal(size=(8, 4)).astype(np.float32)), 3 + seed)}


def _leaves(state) -> list:
    return [leaf.value for leaf in ckpt.leaves(state)]


def _assert_same(got, want) -> None:
    """Same names, values bit for bit, dtypes, shapes and Python types."""
    g, w = ckpt.leaves(got), ckpt.leaves(want)
    assert [x.name for x in g] == [x.name for x in w]
    for a, b in zip(g, w):
        assert type(a.value) is type(b.value), a.name
        if isinstance(b.value, torch.Tensor):
            assert a.value.dtype == b.value.dtype, a.name
            assert a.value.shape == b.value.shape, a.name
            assert torch.equal(a.value, b.value), a.name
        else:
            assert a.value == b.value, a.name


def test_roundtrip(tmp_path):
    d = str(tmp_path)
    state = _state()
    ckpt.save(d, 7, state, extra={"data_step": 7})
    restored, step, extra = ckpt.restore(d, _state(seed=1))
    assert step == 7 and extra["data_step"] == 7
    _assert_same(restored, state)


def test_atomic_no_tmp_left(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _state())
    assert not [x for x in os.listdir(d) if x.startswith("tmp-")]
    assert os.listdir(d) == ["step-1"]


def test_gc_keeps_last_three(tmp_path):
    d = str(tmp_path)
    for s in range(6):
        ckpt.save(d, s, _state())
    assert ckpt.all_steps(d) == [3, 4, 5]


def test_latest_and_specific_step(tmp_path):
    d = str(tmp_path)
    s0, s1 = _state(0), _state(1)
    ckpt.save(d, 1, s0)
    ckpt.save(d, 2, s1)
    r, step, _ = ckpt.restore(d, _state(2))
    assert step == 2 and ckpt.latest_step(d) == 2
    _assert_same(r, s1)
    r1, step1, _ = ckpt.restore(d, _state(2), step=1)
    assert step1 == 1
    _assert_same(r1, s0)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _state())


def test_async_checkpointer(tmp_path):
    d = str(tmp_path)
    ac = ckpt.AsyncCheckpointer(d)
    state = _state()
    for s in (10, 20):
        ac.save(s, state)
    ac.wait()
    assert ckpt.latest_step(d) == 20
    _assert_same(ckpt.restore(d, _state(1))[0], state)


def test_async_checkpointer_raises_write_error_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    ac = ckpt.AsyncCheckpointer(str(blocker))   # a file, not a directory
    ac.save(1, _state())
    with pytest.raises(OSError):
        ac.wait()
    ac.wait()                                   # raised once


def test_structure_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, _state())
    with pytest.raises(ValueError):
        ckpt.restore(d, {"params": {"w": torch.zeros(8, 4)}})
    renamed = _state()
    renamed["params"]["v"] = renamed["params"].pop("w")
    with pytest.raises(ValueError, match="leaf mismatch"):
        ckpt.restore(d, renamed)
    reshaped = _state()
    reshaped["params"]["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, reshaped)


# ---------------------------------------------------------------------------
# Optimizer states of the reduced model

OPT = dict(learning_rate=3e-3, total_steps=20, rank=4, block_size=32,
           update_every=2, weight_decay=1e-4)
BUDGET = RankBudget(total=432, min_k=2, max_k=4, policy="rho_greedy")
CONFIGS = {
    "sketchy-fp32": dict(name="sketchy"),
    "sketchy-bf16": dict(name="sketchy", second_moment_dtype="bf16"),
    "sketchy-int8": dict(name="sketchy", second_moment_dtype="int8"),
    "sketchy-int8-async": dict(name="sketchy", second_moment_dtype="int8",
                               refresh_mode="async"),
    "sketchy-rho-greedy": dict(name="sketchy", rank_budget=BUDGET),
    "shampoo-int8": dict(name="shampoo", second_moment_dtype="int8"),
    "adam": dict(name="adam"),
}


def _run(steps: int, **opt):
    """(params dict, optimizer state, transformation) after ``steps``
    updates of the reduced model from seeded gradients."""
    cfg = registry.get_reduced("paper-lm-100m")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    tx = make_optimizer(OptimizerConfig(**dict(OPT, **opt)))
    flat = tree.flatten(params)
    state = tx.init(flat)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        grads = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)
                                  * 0.05) for p in flat]
        updates, state = tx.update(grads, state, flat)
        flat = [p + u for p, u in zip(flat, updates)]
    return tree.unflatten(params, flat), state, tx


def _template(tx, params):
    return params, tx.init(tree.flatten(params))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_optimizer_state_round_trip_bit_for_bit(tmp_path, config):
    params, state, tx = _run(3, **CONFIGS[config])
    d = str(tmp_path)
    ckpt.save(d, 3, (params, state))
    restored, step, _ = ckpt.restore(d, _template(tx, params))
    assert step == 3
    want = (params, state)
    if state.inner["precond"].pending is not None:
        # the pending slot comes back empty, every other leaf as it was
        pending = restored[1].inner["precond"].pending
        assert all(not slot.valid for slot in pending.values())
        assert all(not t.any() for slot in pending.values()
                   for t in quantize.second_moment_tensors(slot.stats))
        want = (params, state._replace(inner=dict(
            state.inner, precond=state.inner["precond"]._replace(
                pending=pending))))
    _assert_same(restored, want)
    # the roles as the reference records them
    with open(os.path.join(d, "step-3", "manifest.json")) as f:
        roles = {r["name"]: (r["meta"] or {}).get("role")
                 for r in json.load(f)["leaves"]}
    assert roles["1::.count"] == roles["1::.inner::precond::.count"] \
        == "count"
    assert roles["1::.hyperparams::learning_rate"] == "hyperparam"
    assert roles["0::embed"] is None
    assert set(roles.values()) <= {None, "count", "hyperparam", "momentum",
                                   "second_moment", "grafting",
                                   "preconditioner"}


def test_counts_come_back_as_python_ints(tmp_path):
    params, state, tx = _run(3, name="sketchy")
    ckpt.save(str(tmp_path), 3, (params, state))
    _, restored = ckpt.restore(str(tmp_path), _template(tx, params))[0]
    for got in (restored.count, restored.inner["precond"].count):
        assert type(got) is int and got == 3
    arr = np.load(os.path.join(str(tmp_path), "step-3", "leaf-00012.npy"))
    assert arr.dtype == np.int32 and arr.shape == ()


def test_budget_active_ranks_round_trip(tmp_path):
    params, state, tx = _run(3, name="sketchy", rank_budget=BUDGET)
    ks = {key: s.k for key, s in state.inner["precond"].pools.items()}
    # the reallocation at count 2 moved ranks off the uniform 3
    assert any((k != 3).any() for k in ks.values())
    ckpt.save(str(tmp_path), 3, (params, state))
    _, restored = ckpt.restore(str(tmp_path), _template(tx, params))[0]
    for key, k in ks.items():
        got = restored.inner["precond"].pools[key].k
        assert got.dtype == torch.int32 and torch.equal(got, k)


def test_role_mismatch_rejected(tmp_path):
    params, state, tx = _run(1, name="sketchy")
    d = str(tmp_path)
    path = ckpt.save(d, 1, (params, state))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    rec = next(r for r in manifest["leaves"] if ".momentum::" in r["name"])
    rec["meta"]["role"] = "second_moment"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="state-role mismatch"):
        ckpt.restore(d, _template(tx, params))


def test_bf16_round_trip_without_ml_dtypes(tmp_path):
    """In a process that imports neither JAX nor ml_dtypes: bf16 leaves
    (every bit pattern of a few exponents, and a bf16 engine state) go to
    disk as raw 2-byte records and come back bit for bit."""
    code = f"""
import sys, numpy as np, torch
sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
from repro_torch.train import checkpoint as ckpt
bits = torch.arange(-32768, 32768, 7, dtype=torch.int32).to(torch.int16)
state = {{"x": bits.view(torch.bfloat16), "n": 5}}
ckpt.save({str(tmp_path)!r}, 2, state)
got, _, _ = ckpt.restore({str(tmp_path)!r},
                         {{"x": torch.zeros(bits.shape, dtype=torch.bfloat16),
                           "n": 0}})
assert got["n"] == 5 and got["x"].dtype == torch.bfloat16
assert torch.equal(got["x"].view(torch.int16), bits)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
assert not bad, bad
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    with open(os.path.join(str(tmp_path), "step-2", "manifest.json")) as f:
        rec = json.load(f)["leaves"][1]
    assert rec["name"] == "x" and rec["dtype"] == "bfloat16"
    arr = np.load(os.path.join(str(tmp_path), "step-2", rec["file"]))
    assert arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def test_bf16_record_written_by_ml_dtypes_reads_the_same(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = np.linspace(-3, 3, 41, dtype=np.float32)
    torch_bits = torch.from_numpy(x).to(torch.bfloat16)
    ckpt.save(str(tmp_path), 0, {"x": torch_bits})
    # the reference's np.save of an ml_dtypes array, over the port's file
    path = os.path.join(str(tmp_path), "step-0", "leaf-00000.npy")
    np.save(path, x.astype(ml_dtypes.bfloat16))
    got, _, _ = ckpt.restore(str(tmp_path),
                             {"x": torch.zeros(41, dtype=torch.bfloat16)})
    assert torch.equal(got["x"].view(torch.int16),
                       torch_bits.view(torch.int16))


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """The live state is changed after ``save`` returns and before the
    worker writes (held back by an event): the files hold the old values."""
    params, state, tx = _run(2, name="sketchy")
    want = (params, state)
    old = [t.clone() if isinstance(t, torch.Tensor) else t
           for t in _leaves(want)]
    go, write = threading.Event(), ckpt._write

    def held_write(*a, **kw):
        assert go.wait(60)
        return write(*a, **kw)

    monkeypatch.setattr(ckpt, "_write", held_write)
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(2, want)
    for t in _leaves(want):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.add_(1.0)
    go.set()
    ac.wait()
    got = _leaves(ckpt.restore(str(tmp_path), _template(tx, params))[0])
    for a, b in zip(got, old):
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b


def test_pending_slot_dropped_and_rebuilt_empty(tmp_path):
    """An inline and an async run over the same gradients: the same
    manifest, no pending leaf, the same second-moment bytes; each restores
    into the other mode, the async one with an empty, invalid slot."""
    dirs, runs = {}, {}
    for mode in ("inline", "async"):
        params, state, tx = _run(3, name="sketchy", refresh_mode=mode)
        dirs[mode] = str(tmp_path / mode)
        ckpt.save(dirs[mode], 3, (params, state))
        runs[mode] = (params, state, tx)
    manifests = {}
    for mode, d in dirs.items():
        with open(os.path.join(d, "step-3", "manifest.json")) as f:
            manifests[mode] = [(r["name"], r["dtype"], r["shape"], r["meta"])
                               for r in json.load(f)["leaves"]]
    assert manifests["inline"] == manifests["async"]
    assert not [m for m in manifests["async"] if "pending" in m[0]]
    live = runs["async"][1]
    assert all(slot.valid for slot in live.inner["precond"].pending.values())
    assert api.second_moment_bytes(live) == \
        api.second_moment_bytes(runs["inline"][1])
    for src, dst in (("inline", "async"), ("async", "inline")):
        params, _, tx = runs[dst]
        got = ckpt.restore(dirs[src], _template(tx, params))[0][1]
        pending = got.inner["precond"].pending
        if dst == "inline":
            assert pending is None
            continue
        for key, slot in pending.items():
            assert slot.valid is False
            stack = got.inner["precond"].pools[key]
            for p, s in zip(ckpt.leaves(slot.stats), ckpt.leaves(stack)):
                assert not p.value.any() and p.value.shape == s.value.shape
                assert p.value is not s.value


@pytest.mark.parametrize("src,dst", [("fp32", "int8"), ("bf16", "int8"),
                                     ("int8", "fp32"), ("int8", "bf16")])
def test_quantized_migration(tmp_path, src, dst):
    """A float stack into an int8 template is quantized to nearest; an int8
    pair into a float template is ``values * scale`` in its dtype."""
    params, state, _ = _run(3, name="sketchy", second_moment_dtype=src)
    ckpt.save(str(tmp_path), 3, (params, state))
    _, _, tx = _run(0, name="sketchy", second_moment_dtype=dst)
    _, got = ckpt.restore(str(tmp_path), _template(tx, params))[0]
    precond, got_precond = state.inner["precond"], got.inner["precond"]
    for key, stack in precond.pools.items():
        for side in ("left", "right"):
            want_u = getattr(stack, side).eigvecs
            got_u = getattr(got_precond.pools[key], side).eigvecs
            if dst == "int8":
                q = quantize.quantize_stack(want_u.float())
                assert torch.equal(got_u.values, q.values)
                assert torch.equal(got_u.scale, q.scale)
            else:
                assert torch.equal(got_u, quantize.dequantize_stack(
                    *want_u).to(got_u.dtype))
    # the diagonal accumulator of the norm scale: whole-leaf scale
    stats, got_stats = precond.leaves[1].stats, got_precond.leaves[1].stats
    if dst == "int8":
        assert got_stats.scale.shape == (1,)
        want = quantize.quantize_like(stats.float(), (1,))
        assert torch.equal(got_stats.values, want.values)
    else:
        assert torch.equal(got_stats, quantize.dequantize_stack(
            *stats).to(got_stats.dtype))


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_fixed_rank_into_budget_keeps_uniform_ranks(tmp_path, storage):
    """A fixed-rank fp32 checkpoint into a budgeted template keeps the
    template's uniform active ranks; into an int8 one (the storage shim
    with missing ranks) the stacks are quantized as well."""
    params, state, _ = _run(3, name="sketchy", rank=4)
    ckpt.save(str(tmp_path), 3, (params, state))
    _, _, tx = _run(0, name="sketchy", rank_budget=BUDGET,
                    second_moment_dtype=storage)
    template = _template(tx, params)
    _, got = ckpt.restore(str(tmp_path), template)[0]
    for key, stack in got.inner["precond"].pools.items():
        want = state.inner["precond"].pools[key].left.eigvecs
        if storage == "int8":
            want = quantize.quantize_stack(want)
        assert torch.equal(stack.k, template[1].inner["precond"].pools[key].k)
        assert all(torch.equal(a, b) for a, b in zip(
            quantize.second_moment_tensors(stack.left.eigvecs),
            quantize.second_moment_tensors(want)))
