"""End-to-end training launcher (port of repro/launch/train.py: the
training path on one device, with Sketchy or the paper's baselines,
Shampoo and Adam).

    python -m repro_torch.launch.train                      # on the card
    python -m repro_torch.launch.train --optimizer shampoo
    python -m repro_torch.launch.train --reduced --device cpu --optimizer adam
    python -m repro_torch.launch.train --refresh-schedule staggered \
        --refresh-mode async \
        --rank-budget total=7104,min_k=8,max_k=64,policy=rho_greedy
    python -m repro_torch.launch.train --checkpoint-dir ck --resume

Runs on ``--device cuda`` unless told otherwise, and raises if the machine
has no card.  The reference's flags for features not ported yet (sharded
statistics, gradient compression) are absent.

Checkpoints follow the reference's loop (repro/launch/train.py :135-177):
an ``AsyncCheckpointer`` saves ``(params, opt_state)`` as ``step-s`` after
step s ran, every ``--checkpoint-every`` steps (not at step 0), and as
``step-<steps>`` at the end.  ``--resume`` restores the latest and the loop
starts at its label s, so batch s is applied a second time, at optimizer
count s + 1: a resumed run takes one step more than an uninterrupted one.
That is the reference's behavior (ROADMAP.md queue 3), kept so that both
packages resume alike.  A ``StragglerMonitor`` times each step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Callable, Optional

import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.core.factory import (OPTIMIZERS, OptimizerConfig,
                                      make_optimizer)
from repro_torch.core.sketchy import RankBudget
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.flags import parse_kv_spec
from repro_torch.models import model as model_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.trainer import make_train_step


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="repro_torch.launch.train")
    p.add_argument("--arch", default="paper-lm-100m")
    p.add_argument("--reduced", action="store_true",
                   help="use the reduced smoke config")
    p.add_argument("--optimizer", default="sketchy", choices=OPTIMIZERS)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--rank", type=int, default=64)
    p.add_argument("--rank-budget", default=None, metavar="SPEC",
                   help="sketch-rank budget (sketchy only; core/sketchy."
                        "RankBudget): key=value pairs of total, min_k, "
                        "max_k, every, policy, e.g. 'total=2048,min_k=8,"
                        "max_k=128,policy=rho_greedy'; the memory stays at "
                        "max_k capacity while the active ranks move to the "
                        "blocks of highest escaped mass; --rank is ignored")
    p.add_argument("--update-every", type=int, default=10)
    p.add_argument("--block-size", type=int, default=1024)
    p.add_argument("--second-moment-dtype", default="fp32",
                   choices=["fp32", "bf16", "int8"],
                   help="storage dtype for pooled second-moment stacks "
                        "between steps (core/quantize.py): fp32 = bitwise "
                        "parity, bf16 = 2x smaller, int8 = per-block "
                        "quantized matrix factors (~4x); compute stays f32")
    p.add_argument("--quantized-epilogue", default="auto",
                   choices=["auto", "off", "on"],
                   help="fused int8 compute (core/api.py): with "
                        "--second-moment-dtype int8, auto and on run the "
                        "refresh and the apply on the int8 factors through "
                        "the fused kernels (no f32 factor stack at the pool "
                        "boundary); off = always dequantize at the boundary")
    p.add_argument("--refresh-schedule", default="synchronized",
                   choices=["synchronized", "staggered"],
                   help="synchronized = every block every update-every "
                        "steps (an eigh spike); staggered = about "
                        "N/update_every blocks a step, the same work in all")
    p.add_argument("--refresh-mode", default="inline",
                   choices=["inline", "async"],
                   help="inline = the refresh preconditions its own step; "
                        "async = it lands in a pending slot, committed at "
                        "the next step (the direction one refresh stale)")
    p.add_argument("--profile-annotations", action="store_true",
                   help="torch.profiler ranges around the engine's "
                        "update_stats / refresh / precondition / commit "
                        "phases")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint under "
                        "--checkpoint-dir, if there is one, and go on from "
                        "its step")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--metrics-out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when asked for")
    args = p.parse_args(argv)
    if args.rank_budget:
        args.rank_budget = parse_kv_spec(
            args.rank_budget, RankBudget, aliases={"every": "realloc_every"},
            error=lambda m: p.error(f"--rank-budget: {m}"))
    return args


@dataclasses.dataclass
class Run:
    """A training run set up from the flags: model config, data, the step
    function and the current parameters and optimizer state."""
    cfg: Any
    device: torch.device
    data: Any
    step_fn: Callable
    params: dict
    opt_state: Any

    def batch(self, step: int) -> dict:
        """Batch ``step`` on the device: token leaves as long, the vlm's
        ``embeds`` as f32 (the model casts them to its dtype, as the
        reference does)."""
        return {k: torch.from_numpy(v).to(
            device=self.device,
            dtype=torch.float32 if v.dtype.kind == "f" else torch.long)
            for k, v in self.data.batch(step).items()}

    def step(self, step: int) -> dict:
        """Train on batch ``step``; returns the step's metrics tensors."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.batch(step))
        return metrics


def start(args: argparse.Namespace, params: Optional[dict] = None) -> Run:
    """Set a run up from the flags.  ``params`` replaces the seeded
    initialization (parity tests start both packages from the same
    weights)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the card "
                           "unless asked for --device cpu")

    cfg = registry.get_reduced(args.arch) if args.reduced \
        else registry.get_config(args.arch)
    tx = make_optimizer(OptimizerConfig(
        name=args.optimizer, learning_rate=args.lr, total_steps=args.steps,
        rank=args.rank, rank_budget=args.rank_budget,
        block_size=args.block_size, update_every=args.update_every,
        weight_decay=1e-4, refresh_schedule=args.refresh_schedule,
        refresh_mode=args.refresh_mode,
        profile_annotations=args.profile_annotations,
        second_moment_dtype=args.second_moment_dtype,
        quantized_epilogue=args.quantized_epilogue))
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, num_codebooks=cfg.num_codebooks,
        embed_dim=0 if cfg.embed_inputs else cfg.d_model))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model_lib.init_params(cfg, gen, device=device)
    return Run(cfg=cfg, device=device, data=data,
               step_fn=make_train_step(cfg, tx), params=params,
               opt_state=tx.init(tree.flatten(params)))


def train(args: argparse.Namespace, params: Optional[dict] = None
          ) -> tuple[Run, list]:
    """Run training steps up to ``args.steps`` (from a checkpoint's step
    with ``--resume``); returns the run (final parameters and optimizer
    state) and one metrics record per step run: step, loss, grad_norm,
    time_s (host clock around the step, after the device finished it)."""
    run = start(args, params)
    start_step, ckpt = 0, None
    if args.checkpoint_dir:
        ckpt = ckpt_lib.AsyncCheckpointer(args.checkpoint_dir)
        if args.resume \
                and ckpt_lib.latest_step(args.checkpoint_dir) is not None:
            (run.params, run.opt_state), start_step, _ = ckpt_lib.restore(
                args.checkpoint_dir, (run.params, run.opt_state))
            print(f"resumed from step {start_step}")
    n_params = sum(p.numel() for p in tree.flatten(run.params))
    print(f"arch={run.cfg.name} params={n_params / 1e6:.1f}M "
          f"optimizer={args.optimizer} device={run.device} "
          f"second_moment={args.second_moment_dtype} "
          f"({api.second_moment_bytes(run.opt_state)} bytes)")
    monitor = StragglerMonitor()
    log = []
    for step in range(start_step, args.steps):
        monitor.start()
        metrics = run.step(step)
        loss = float(metrics["loss"])
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        dt = monitor.stop()
        record = {"step": step, "loss": loss,
                  "grad_norm": float(metrics["grad_norm"]), "time_s": dt}
        log.append(record)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {record['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if ckpt and step and step % args.checkpoint_every == 0:
            ckpt.save(step, (run.params, run.opt_state))
    if ckpt:
        ckpt.save(args.steps, (run.params, run.opt_state))
        ckpt.wait()
    if monitor.flagged:
        print(f"straggler steps flagged: {monitor.flagged} "
              f"(median {monitor.median * 1e3:.0f}ms)")
    if args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=2)
    return run, log


def main(argv: Optional[list] = None) -> list:
    """Command-line entry point; returns the per-step metrics records."""
    return train(parse_args(argv))[1]


if __name__ == "__main__":
    main()
