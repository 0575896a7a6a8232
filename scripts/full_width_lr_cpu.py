"""Loss curves of the JAX reference and of the PyTorch port at full width
(paper-lm-100m, or ``--arch``: mamba2-370m, every layer) with Sketchy at
the launchers' default peak lr, on the CPU, from the same weights and
batches.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/full_width_lr_cpu.py \
        --out OUT_DIR [--steps 12] [--lr 3e-3] [--arch mamba2-370m]

Two processes, one after the other, so neither package's memory stays
resident while the other runs:

1. ``--part jax``: ``repro.launch.train``'s main path (launcher defaults:
   rank 64, block 1024, update_every 10, batch 8 x seq 128, weight decay
   1e-4) for ``--steps`` steps; writes the seeded initial parameters to
   ``OUT_DIR/init.npz`` and the losses to ``OUT_DIR/jax.json``.
2. ``--part port``: ``repro_torch.launch.train`` with the same flags and
   ``--device cpu``, from those parameters (``convert.params_from_numpy``);
   writes ``OUT_DIR/port.json``.  This part imports no JAX.

The parent prints both loss curves as one JSON line.  About 3 minutes for
the JAX part and 1-2 for the port on 8 CPU cores at paper-lm-100m.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flags(args) -> list:
    return ["--steps", str(args.steps), "--lr", str(args.lr),
            "--log-every", "1", "--arch", args.arch]


def part_jax(args) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import registry
    from repro.core.factory import OptimizerConfig, make_optimizer
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import model as model_lib
    from repro.train.trainer import make_train_step

    cfg = registry.get_config(args.arch)
    tx = make_optimizer(OptimizerConfig(
        name="sketchy", learning_rate=args.lr, total_steps=args.steps,
        rank=64, block_size=1024, update_every=10, weight_decay=1e-4))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    params = model_lib.init_params(cfg, jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    np.savez(os.path.join(args.out, "init.npz"), **{
        jax.tree_util.keystr(path): np.asarray(x).astype(np.float32)
        for path, x in flat})
    opt_state = tx.init(params)
    step_fn = make_train_step(cfg, tx)
    losses = []
    for step in range(args.steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        print(f"jax step {step} loss {losses[-1]:.4f}", flush=True)
    with open(os.path.join(args.out, "jax.json"), "w") as f:
        json.dump(losses, f)


def part_port(args) -> None:
    import numpy as np

    from repro_torch import convert, tree
    from repro_torch.configs import registry
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as model_lib

    cfg = registry.get_config(args.arch)
    saved = np.load(os.path.join(args.out, "init.npz"))
    # the JAX tree's flattening order is the port's canonical order
    like = model_lib.param_shapes(cfg)
    params = tree.unflatten(like, [saved[k] for k in saved.files])
    params = convert.params_from_numpy(cfg, params)
    _, log = train_lib.train(
        train_lib.parse_args(flags(args) + ["--device", "cpu"]), params)
    with open(os.path.join(args.out, "port.json"), "w") as f:
        json.dump([r["loss"] for r in log], f)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--part", choices=["jax", "port"], default=None)
    p.add_argument("--arch", default="paper-lm-100m")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.part == "jax":
        part_jax(args)
        return 0
    if args.part == "port":
        part_port(args)
        return 0
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    for part in ("jax", "port"):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--part", part, "--out", args.out,
                        "--steps", str(args.steps), "--lr", str(args.lr),
                        "--arch", args.arch],
                       env=env, check=True)
    curves = {}
    for part in ("jax", "port"):
        with open(os.path.join(args.out, f"{part}.json")) as f:
            curves[part] = json.load(f)
    print(json.dumps({"arch": args.arch, "lr": args.lr, "steps": args.steps,
                      **curves}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
