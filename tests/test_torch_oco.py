"""The port's Appendix-A convex learners (core/sadagrad.py) and its Tbl. 3
entry point (launch/convex.py) against the JAX package.

(a) Each learner of ``LEARNERS`` steps through the same 12 gradients in
both packages from the same iterate (FD learners at ell 5, so the sketch
fills and deflates within the run; Ada-FD and FD-SON at both deltas of the
Tbl. 3 grid).  The FD sketches' covariances ``U diag(s) U^T``, ladders and
``rho`` agree at ``rtol=1e-4`` plus ``1e-5`` of the largest magnitude
(tests/test_torch_fd.py's tolerance), and so do the iterates of
S-AdaGrad, RFD-SON, AdaGrad and OGD (measured 1.0e-6 of it).  Ada-FD and
FD-SON drop the escaped mass and apply a fixed delta: while the sketch
fills (steps 1-5) its columns past the stream's rank are eigh noise, and
``delta^-1/2`` (Ada-FD) or ``delta^-1`` (FD-SON) scales the difference
of the two packages' noise into the iterate, so their iterates are held
at ``1e-4`` of the largest magnitude (measured 4.5e-5 Ada-FD at delta
1e-4, 6.0e-5 FD-SON at 1e-2) and FD-SON at delta 1e-4 at ``1e-2`` (6.9e-3);
from step 6 on every learner agrees within 4e-6 of it.
(b) ``python -m repro_torch.launch.convex --device cpu`` (seed 0, d 32,
T 400, ell 10, the benchmark's lr and delta grid) reproduces the 12
``tbl3_convex_*`` avg_loss rows of benchmarks/baseline.json and their rank
order.  Eleven rows agree within 1e-4 (the file keeps 4 decimals; measured
4.9e-5 at most).  FD-SON on the low-rank stream is chaotic: its one finite
grid point (lr 0.05, delta 1e-2) amplifies directions outside its rank-10
sketch of the 16-dimensional stream 100-fold, and relative perturbations
of 1e-7 of the stream move its average loss between 4.78 and 8.92 over 12
draws (the port gives 7.4163; the JAX learner's own CPU run of the same
grid 5.5077, not the file's 5.9519; the port on an H100 5.1595).  That row
is held to its rank (last) and to within a factor of 2 of the file's
value.  The whole run takes ~10 s on the CPU.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (assert_close_scaled, ladder,  # noqa: F401
                          torch_one_thread)

from repro.core import sadagrad as jsadagrad
from repro_torch.core import sadagrad as tsadagrad
from repro_torch.launch import convex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cov(state):
    U = np.asarray(state.eigvecs, np.float64)
    return (U * np.asarray(state.eigvals, np.float64)) @ U.T


def _sketch(state):
    """The FD sketch of a learner state, or None."""
    if isinstance(state, (jsadagrad.SAdaGradState, tsadagrad.SAdaGradState)):
        return state.sketch
    return getattr(state, "sketch", None)


@pytest.mark.parametrize("name,delta", [
    ("s-adagrad", None), ("ada-fd", 1e-4), ("ada-fd", 1e-2),
    ("fd-son", 1e-4), ("fd-son", 1e-2), ("rfd-son", None),
    ("adagrad", None), ("ogd", None)])
def test_learner_steps_match_jax(name, delta):
    d, ell, lr = 32, 5, 0.2
    jinit, jstep, needs = jsadagrad.LEARNERS[name]
    tinit, tstep, tneeds = tsadagrad.LEARNERS[name]
    assert tneeds == needs
    js = jinit(d, ell) if needs["ell"] else jinit(d)
    ts = tinit(d, ell, device="cpu") if needs["ell"] \
        else tinit(d, device="cpu")
    rng = np.random.default_rng(7)
    x0 = rng.normal(size=d).astype(np.float32) * 0.1
    jx, tx = jnp.asarray(x0), torch.from_numpy(x0)
    extra = () if delta is None else (delta,)
    for t in range(12):
        # a stream with decaying feature scales, as Tbl. 3's "decay" kind
        g = (rng.normal(size=d) * np.exp(-np.arange(d) / 8.0)).astype(
            np.float32)
        jx, js = jstep(js, jx, jnp.asarray(g), lr, *extra)
        tx, ts = tstep(ts, tx, torch.from_numpy(g), lr, *extra)
        assert_close_scaled(tx.numpy(), jx, atol_frac=(
            1e-2 if (name, delta) == ("fd-son", 1e-4) else
            1e-4 if needs["delta"] else 1e-5))
        jsk, tsk = _sketch(js), _sketch(ts)
        if jsk is not None:
            assert_close_scaled(tsk.eigvals.numpy(), jsk.eigvals)
            assert_close_scaled(tsk.rho.numpy(), jsk.rho, scale=ladder(jsk))
            assert_close_scaled(_cov(tsk), _cov(jsk))
        elif name == "adagrad":
            assert_close_scaled(ts.acc.numpy(), js.acc)


def test_table3_matches_baseline():
    with open(os.path.join(ROOT, "benchmarks", "baseline.json")) as f:
        rows = {r["name"]: r["derived"] for r in json.load(f)
                if r["name"].startswith("tbl3_convex_")}
    assert len(rows) == 12
    got = convex.main(["--device", "cpu"])
    assert got["launches"] == {"gram": 0, "lowrank_apply": 0}
    for name, derived in rows.items():
        fields = dict(kv.split("=") for kv in derived.split())
        want, rank = float(fields["avg_loss"]), int(fields["rank"])
        value, got_rank = got[name]
        assert got_rank == rank, (name, got_rank, rank)
        if name == "tbl3_convex_lowrank_fd-son":
            assert want / 2 < value < want * 2, (name, value, want)
        else:
            assert abs(value - want) <= 1e-4, (name, value, want)
