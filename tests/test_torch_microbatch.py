"""The trainer's microbatching (repro_torch/train/trainer.py
``make_train_step(microbatches=M)``) against the reference's
(repro/train/trainer.py:63-96).

(a) On the reduced paper-lm-100m in f32, from the same weights and batch,
two steps of the port's ``microbatches=4`` step match two of the
reference's ``make_train_step(cfg, tx, microbatches=4, donate=False)``,
with Adam and with Sketchy (a refresh at each step): the losses at
``rtol`` 1e-4 and every parameter at ``rtol`` 1e-3, ``atol`` 1e-5, the
tolerances of tests/test_torch_train.py's reduced run, and the global
gradient norms at ``rtol`` 1e-4.  Adam's update m / (sqrt(v) + eps) of an
element whose gradient is near zero turns the gradients' other summation
order (autograd against ``jax.grad``) into up to one lr step (measured:
3 elements of 106,000 beyond 1e-5, the largest 1.44e-4 at lr 1e-2), so
its parameters are held within one lr step everywhere and within 1e-5 on
all but 1e-3 of the elements of each leaf.  (b) The port's
microbatched step against its own full-batch step, the reference test's
check (tests/test_trainer.py:14-34): loss ``rtol`` 1e-5, parameters
``rtol`` 1e-2, ``atol`` 1e-4.  (c) M = 2 and a batch of ``positions``
(3, B, S) split along axis 1, the rest along axis 0; a batch that M does
not divide raises, as the reference asserts.  (d) Microbatching composes
with the data-parallel group: on 2 gloo ranks
(tests/torch_mesh_ranks.py's ``microbatch`` scenario) each rank takes
``microbatches=2`` of its half of the batch and the result equals, on both
ranks, the one-process step with ``microbatches=4`` at the same
tolerances (the same four microbatches, the halves' means averaged).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_mesh_ranks as ranks_lib
import torch_ranks
from torch_parity import torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.core.factory import OptimizerConfig as JOptimizerConfig
from repro.core.factory import make_optimizer as jmake_optimizer
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch import convert, tree
from repro_torch.configs import registry as tregistry
from repro_torch.core.factory import OptimizerConfig
from repro_torch.core.factory import make_optimizer
from repro_torch.train import trainer

ARCH = "paper-lm-100m"
OPT = {"adam": dict(name="adam", learning_rate=1e-2, schedule="constant",
                    grad_clip=None),
       "sketchy": dict(name="sketchy", learning_rate=3e-3, total_steps=20,
                       rank=4, block_size=32, update_every=1)}


def _batches(steps: int = 2, batch: int = 8, seq: int = 16) -> list:
    data = jpipeline.SyntheticLM(jpipeline.DataConfig(
        vocab_size=256, seq_len=seq, global_batch=batch, seed=0))
    return [data.batch(s) for s in range(steps)]


def _torch_run(opt: str, init, microbatches, batches) -> tuple:
    cfg = tregistry.get_reduced(ARCH)
    params = convert.params_from_numpy(cfg, init)
    tx = make_optimizer(OptimizerConfig(**OPT[opt]))
    state = tx.init(tree.flatten(params))
    step = trainer.make_train_step(cfg, tx, microbatches=microbatches)
    losses = []
    for b in batches:
        params, state, metrics = step(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return losses, [p.detach().numpy() for p in tree.flatten(params)]


def _jax_run(opt: str, microbatches, batches) -> tuple:
    cfg = jregistry.get_reduced(ARCH)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    tx = jmake_optimizer(JOptimizerConfig(**OPT[opt]))
    state = tx.init(params)
    step = jax.jit(jmake_train_step(cfg, tx, microbatches=microbatches,
                                    donate=False))
    losses = []
    for b in batches:
        params, state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return init, losses, [np.asarray(p) for p in jax.tree.leaves(params)]


@pytest.mark.parametrize("opt", ["adam", "sketchy"])
def test_microbatched_step_matches_reference(opt):
    batches = _batches()
    init, jlosses, jparams = _jax_run(opt, 4, batches)
    losses, params = _torch_run(opt, init, 4, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for got, want in zip(params, jparams):
        if opt == "sketchy":
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
            continue
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=OPT[opt]["learning_rate"])
        beyond = ~np.isclose(got, want, rtol=1e-3, atol=1e-5)
        assert beyond.sum() <= 1e-3 * got.size, beyond.sum()


@pytest.mark.parametrize("opt", ["adam", "sketchy"])
def test_microbatched_step_matches_full_batch(opt):
    batches = _batches(steps=1)
    init = jax.tree.map(np.asarray, jmodel.init_params(
        jregistry.get_reduced(ARCH), jax.random.PRNGKey(0)))
    full_losses, full = _torch_run(opt, init, None, batches)
    micro_losses, micro = _torch_run(opt, init, 4, batches)
    np.testing.assert_allclose(micro_losses[0][0], full_losses[0][0],
                               rtol=1e-5)
    for got, want in zip(micro, full):
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-4)


def test_split_microbatches_cuts_positions_along_axis_1():
    batch = {"tokens": torch.arange(24).reshape(6, 4),
             "positions": torch.arange(72).reshape(3, 6, 4)}
    pieces = trainer.split_microbatches(batch, 2)
    assert [p["tokens"].shape for p in pieces] == [(3, 4)] * 2
    assert [p["positions"].shape for p in pieces] == [(3, 3, 4)] * 2
    assert torch.equal(torch.cat([p["positions"] for p in pieces], 1),
                       batch["positions"])
    with pytest.raises(ValueError, match="not divisible"):
        trainer.split_microbatches(batch, 4)


P = 2
LIMIT_S = 120


@pytest.fixture(scope="module")
def data_parallel(tmp_path_factory):
    out = tmp_path_factory.mktemp("microbatch")
    procs = torch_ranks.start_ranks(ranks_lib.__file__, ["microbatch"], P,
                                    out)
    torch_ranks.wait_all(procs, out, LIMIT_S)
    return torch_ranks.load_ranks(out, P)


def test_microbatching_composes_with_data_parallel(data_parallel):
    init, batch = ranks_lib.microbatch_inputs()
    losses, params = _torch_run("adam", init, 4, [batch])
    for rank in data_parallel:
        np.testing.assert_allclose(rank["loss"], losses[0][0], rtol=1e-5)
        for got, want in zip(rank["params"], params):
            np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-4)
