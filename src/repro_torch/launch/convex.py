"""Online convex optimization, the paper's Tbl. 3: S-AdaGrad against its
Appendix-A competitors on synthetic logistic streams (the port's entry
point for ``benchmarks/run.py::bench_tbl3_convex``'s streams and grid).

    python -m repro_torch.launch.convex                 # on the card
    python -m repro_torch.launch.convex --device cpu

For each stream kind (``decay``: features with exponentially decaying
scales; ``lowrank``: features in a d/2-dimensional subspace) every learner
of ``core/sadagrad.py::LEARNERS`` runs the stream once per step size (and
per ``delta`` for Ada-FD and FD-SON), and its best average loss over the
grid is reported with its rank among the learners, as
``tbl3_convex_<kind>_<learner> avg_loss=... rank=...``.  The logistic
loss's gradient comes from autograd.  Runs on ``--device cuda`` unless told
otherwise, and raises if the machine has no card; there the FD learners'
refresh Gram and apply launch the single-block kernels (their counts are
printed, 0 on the CPU).
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.core import sadagrad as oco
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.lowrank import kernel as lowrank_kernel

D, ELL = 32, 10                  # the stream's dimension, the sketch rank
KINDS = ("decay", "lowrank")
LRS = (0.05, 0.2, 0.5)
DELTAS = (1e-4, 1e-2)
# the order of benchmarks/run.py's rows
ORDER = ("s-adagrad", "adagrad", "ogd", "ada-fd", "fd-son", "rfd-son")


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="repro_torch.launch.convex")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--T", type=int, default=400, help="stream length")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p.parse_args(argv)


def stream(seed: int, d: int, T: int, kind: str) -> np.ndarray:
    """(T, d) label-signed features ``y_t a_t`` (float64), as
    benchmarks/run.py makes them."""
    rng = np.random.default_rng(seed)
    if kind == "lowrank":
        W = np.linalg.qr(rng.normal(size=(d, d // 2)))[0]
        feats = rng.normal(size=(T, d // 2)) @ W.T
    else:
        feats = rng.normal(size=(T, d)) * np.exp(-np.arange(d) / 8.0)
    w = rng.normal(size=d)
    y = np.sign(feats @ w + 0.1 * rng.normal(size=T))
    return feats * y[:, None]


def loss_and_grad(x: torch.Tensor, a: torch.Tensor) -> tuple:
    """The logistic loss ``log(1 + exp(-a.x))`` and its gradient in x."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = torch.log1p(torch.exp(-(a @ x)))
        (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


def run_learner(name: str, A: torch.Tensor, ell: int, lr: float,
                delta: Optional[float]) -> tuple:
    """``(average loss, steps taken)`` of one pass of learner ``name`` over
    the rows of A.  A run that diverges (a non-finite iterate or gradient)
    stops there with a NaN average: the reference runs on in NaN to a NaN
    average, and the FD learners' ``eigh`` would refuse the non-finite
    sketch."""
    init, step, needs = oco.LEARNERS[name]
    T, d = A.shape
    state = init(d, ell, device=A.device) if needs["ell"] \
        else init(d, device=A.device)
    x = torch.zeros((d,), dtype=torch.float32, device=A.device)
    total = 0.0
    with torch.no_grad():
        for t in range(T):
            loss, g = loss_and_grad(x, A[t])
            if not (torch.isfinite(x).all() and torch.isfinite(g).all()):
                return float("nan"), t
            total += float(loss)
            extra = (delta,) if delta is not None else ()
            x, state = step(state, x, g, lr, *extra)
    return total / T, T


def run(args: argparse.Namespace) -> dict:
    """``{"tbl3_convex_<kind>_<learner>": (avg_loss, rank)}`` plus
    ``"launches"`` (the single-block Gram and apply kernels over the run)
    and ``"steps"`` (each learner's steps over the run, diverged runs cut
    short)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the learners run on the card "
                           "unless asked for --device cpu")
    start = (gram_kernel.single_launches, lowrank_kernel.single_launches)
    out, steps = {}, dict.fromkeys(ORDER, 0)
    for kind in KINDS:
        A = torch.as_tensor(stream(args.seed, D, args.T, kind),
                            dtype=torch.float32, device=device)
        best = {}
        for name in ORDER:
            deltas = DELTAS if oco.LEARNERS[name][2]["delta"] else (None,)
            best[name] = float("inf")
            for lr in LRS:
                for delta in deltas:
                    avg, taken = run_learner(name, A, ELL, lr, delta)
                    steps[name] += taken
                    # a diverged run's NaN never replaces the best, as in
                    # the benchmark's ``min(best, avg)``
                    best[name] = min(best[name], avg)
        order = sorted(best, key=best.get)
        for name in ORDER:
            out[f"tbl3_convex_{kind}_{name}"] = (best[name],
                                                 order.index(name) + 1)
    out["launches"] = {
        "gram": gram_kernel.single_launches - start[0],
        "lowrank_apply": lowrank_kernel.single_launches - start[1]}
    out["steps"] = steps
    return out


def main(argv: Optional[list] = None) -> dict:
    args = parse_args(argv)
    results = run(args)
    for name, value in results.items():
        if name not in ("launches", "steps"):
            print(f"{name} avg_loss={value[0]!r} rank={value[1]}")
    print(f"launches: {results['launches']}; steps: {results['steps']}")
    return results


if __name__ == "__main__":
    main()
