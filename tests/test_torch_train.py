"""The port's training slice as a whole against the JAX package.

(a) ``SyntheticLM`` batches are bitwise equal.  (b) A 6-step reduced run of
``repro_torch.launch.train`` (three refreshes) gives the loss curve and
final parameters of the reference's launch/train path from the same
weights; loss ``rtol=1e-4``, parameters ``rtol=1e-3, atol=1e-5``.
(c) The same run with the model in bf16 (the full-width dtype) at the
launcher's peak lr 3e-3 tracks the reference's bf16 run: loss ``rtol=1e-2``
and, per parameter, a difference under a fifth of how far training moved
it (bf16 rounds each update differently in the two packages).  With int8
second-moment storage on the fused path it tracks the reference's fused
run: loss ``rtol=1e-4`` and, per parameter, a difference under 0.02 of the
change (stochastic rounding of the diagonal accumulators draws differently).
(d) Importing every ``repro_torch`` module, and ``chip_smoke.py``, loads no
JAX and nothing of ``repro``, and no import statement in their sources
names either.  (e) The launcher raises without a card unless
asked for the CPU.
"""
import dataclasses
import os
import pkgutil
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import torch_one_thread  # noqa: F401

import repro_torch
from repro.configs import registry as jregistry
from repro.core.factory import OptimizerConfig
from repro.core.factory import make_optimizer as jmake_optimizer
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.data import pipeline as tpipeline
from repro_torch.core.factory import OptimizerConfig as TOptimizerConfig
from repro_torch.core.factory import make_optimizer as tmake_optimizer
from repro_torch.launch import train as tlaunch
from repro_torch.train.trainer import make_train_step as tmake_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--reduced", "--steps", "6", "--seq", "16", "--batch", "4",
        "--rank", "4", "--block-size", "32", "--update-every", "2",
        "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("seq,batch,seed,step", [(16, 4, 0, 0),
                                                 (128, 8, 3, 11)])
def test_synthetic_batches_bitwise_equal(seq, batch, seed, step):
    kw = dict(vocab_size=32768, seq_len=seq, global_batch=batch, seed=seed)
    want = jpipeline.SyntheticLM(jpipeline.DataConfig(**kw)).batch(step)
    got = tpipeline.SyntheticLM(tpipeline.DataConfig(**kw)).batch(step)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _opt(args) -> dict:
    """The launchers' optimizer options for ``args``."""
    return dict(name=args.optimizer, learning_rate=args.lr,
                total_steps=args.steps, rank=args.rank,
                block_size=args.block_size, update_every=args.update_every,
                weight_decay=1e-4,
                second_moment_dtype=args.second_moment_dtype,
                quantized_epilogue=args.quantized_epilogue)


def _jax_run(args, dtype="float32", **options):
    """The reference launcher's main path (repro/launch/train.py) for the
    same flags (``options`` replace optimizer options), with the reduced
    model in ``dtype``, returning its initial parameters, losses and final
    parameters."""
    cfg = dataclasses.replace(jregistry.get_reduced(args.arch), dtype=dtype)
    tx = jmake_optimizer(OptimizerConfig(**dict(_opt(args), **options)))
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    params = jmodel.init_params(cfg, jax.random.PRNGKey(args.seed))
    init = jax.tree.map(np.asarray, params)
    opt_state = tx.init(params)
    step_fn = jmake_train_step(cfg, tx)
    losses = []
    for step in range(args.steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    return init, losses, jax.tree.map(np.asarray, params)


def test_reduced_training_matches_jax():
    args = tlaunch.parse_args(ARGV)
    init, jlosses, jfinal = _jax_run(args)
    cfg = tregistry.get_reduced(args.arch)
    run, log = tlaunch.train(args,
                             params=convert.params_from_numpy(cfg, init))
    np.testing.assert_allclose([r["loss"] for r in log], jlosses, rtol=1e-4)
    for got, want in zip(tree.flatten(run.params), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3,
                                   atol=1e-5)


def test_reduced_bf16_training_tracks_jax():
    """bf16 casts of the port (gradients to f32 in the engine, directions
    back to bf16, bf16 momentum, f32 promotion by the lr and clip scalars)
    against the reference's, at the launcher's default peak lr.  Measured:
    loss 1.1e-3 relative, parameter difference 0.06 of the change."""
    args = tlaunch.parse_args(ARGV)
    init, jlosses, jfinal = _jax_run(args, "bfloat16")
    cfg = dataclasses.replace(tregistry.get_reduced(args.arch),
                              dtype="bfloat16")
    params = convert.params_from_numpy(cfg, init)
    tx = tmake_optimizer(TOptimizerConfig(**_opt(args)))
    step_fn, state = tmake_train_step(cfg, tx), tx.init(tree.flatten(params))
    data = tpipeline.SyntheticLM(tpipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed))
    losses = []
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch(step).items()}
        params, state, metrics = step_fn(params, state, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-2)
    for got, want, start in zip(tree.flatten(params), jax.tree.leaves(jfinal),
                                jax.tree.leaves(init)):
        assert got.dtype == torch.bfloat16
        got = got.detach().float().numpy()
        want, start = want.astype(np.float32), start.astype(np.float32)
        assert np.linalg.norm(got - want) <= \
            0.2 * np.linalg.norm(want - start)


def test_port_imports_no_jax_and_nothing_of_repro():
    modules = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "repro_torch.launch.train" in modules
    assert "repro_torch.launch.serve" in modules
    assert "repro_torch.kernels.build" in modules


def test_port_sources_import_no_jax_and_nothing_of_repro():
    """A grep of the sources, which also sees imports inside functions that
    the import test above never runs."""
    pkg = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(dirpath, f) for dirpath, _, names in os.walk(pkg)
             for f in names if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    bad_import = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    offenders = {f: bad_import.findall(open(f).read()) for f in files}
    assert len(files) > 30
    assert not {f: hits for f, hits in offenders.items() if hits}


def test_launcher_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1"])


def test_reduced_int8_training_tracks_jax():
    """int8 second-moment storage on the fused path (the port's "auto")
    against the reference's fused path ("on"; its "auto" on the CPU is
    "off").  The norm-scale leaves' diagonal accumulators are rounded
    stochastically, with different draws in the two packages.  Measured:
    losses 2.5e-6 relative, parameter difference 0.0027 of the change;
    without the scale^2 fold of the int8 apply the test fails."""
    args = tlaunch.parse_args(ARGV + ["--second-moment-dtype", "int8"])
    init, jlosses, jfinal = _jax_run(args, quantized_epilogue="on")
    cfg = tregistry.get_reduced(args.arch)
    run, log = tlaunch.train(args,
                             params=convert.params_from_numpy(cfg, init))
    np.testing.assert_allclose([r["loss"] for r in log], jlosses, rtol=1e-4)
    for got, want, start in zip(tree.flatten(run.params),
                                jax.tree.leaves(jfinal),
                                jax.tree.leaves(init)):
        got = got.detach().numpy()
        assert np.linalg.norm(got - want) <= \
            0.02 * np.linalg.norm(want - start)
