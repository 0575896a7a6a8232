"""End-to-end training launcher (port of repro/launch/train.py: the
training path on one device or data-parallel over ranks, with Sketchy or
the paper's baselines, Shampoo and Adam).

    python -m repro_torch.launch.train                      # on the card
    python -m repro_torch.launch.train --optimizer shampoo
    python -m repro_torch.launch.train --reduced --device cpu --optimizer adam
    python -m repro_torch.launch.train --refresh-schedule staggered \
        --refresh-mode async \
        --rank-budget total=7104,min_k=8,max_k=64,policy=rho_greedy
    python -m repro_torch.launch.train --checkpoint-dir ck --resume
    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --stats-reduction sharded

Runs on ``--device cuda`` unless told otherwise, and raises if the machine
has no card.  ``--compress-grads`` is parsed as the reference parses it
and, as there, nothing reads it: the int8 gradient mean is
train/compression.py's ``compressed_mean_grads``, which the step does not
call.

``--stats-reduction sharded`` (distributed/): started by
``torch.distributed.run`` with ``WORLD_SIZE`` > 1, every rank joins one
gloo process group and takes its slice of each global batch; Sketchy's
statistics are kept per rank and merged over the ranks at each refresh,
the rest of the step sees the mean gradients (train/trainer.py).  Rank r
runs on ``cuda:{LOCAL_RANK % device_count}`` (so all ranks share one card
on a machine with one), or on the CPU with ``--device cpu``.  Rank 0 alone
builds the CUDA kernels while the others wait, prints the step lines,
writes ``--metrics-out`` and saves checkpoints; every rank restores one
with ``--resume``.  In one process, or with a batch the ranks cannot
split, it prints the reference's fallback line and runs replicated.
``--rank-report DIR`` has every rank write ``DIR/rank-<r>.json``: its
kernel launch counts (set to 0 as the run starts), its step times, the
bytes it sent and the time of each butterfly round and each mean per step
(``distributed/reduce.merge_log``), its peak device memory and sha256
digests of its final parameters and optimizer state, by which the ranks'
replicas can be compared.

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
import hashlib
import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import api
from repro_torch.core.factory import (OPTIMIZERS, OptimizerConfig,
                                      make_optimizer)
from repro_torch.core.sketchy import RankBudget
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed import reduce as dreduce
from repro_torch.kernels import build
from repro_torch.kernels import registry as kernel_registry
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
    p.add_argument("--stats-reduction", default="replicated",
                   choices=["replicated", "sharded"],
                   help="second-moment statistics across data-parallel "
                        "ranks (distributed/): replicated = every rank keeps "
                        "the same statistics of the mean gradients; sharded "
                        "= each rank sketches its own gradients and the "
                        "sketches merge in a log-depth butterfly at each "
                        "refresh (sketchy only; needs > 1 rank, started by "
                        "torch.distributed.run)")
    p.add_argument("--rank-report", default=None, metavar="DIR",
                   help="every rank writes DIR/rank-<r>.json: launch "
                        "counts, merge rounds, step times, peak memory and "
                        "digests of its final state")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint under "
                        "--checkpoint-dir, if there is one, and go on from "
                        "its step")
    p.add_argument("--compress-grads", action="store_true",
                   help="parsed and unread, as in the reference; see "
                        "train/compression.py")
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


def batch_leaf(key: str, value: np.ndarray,
               device: torch.device) -> torch.Tensor:
    """One batch leaf on ``device`` (``Run.batch``)."""
    if key == "mask":
        narrow = {np.dtype(np.float64): np.float32,
                  np.dtype(np.int64): np.int32,
                  np.dtype(np.uint64): np.uint32}
        value = value.astype(narrow.get(value.dtype, value.dtype), copy=False)
        return torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return torch.from_numpy(value).to(
        device=device,
        dtype=torch.float32 if value.dtype.kind == "f" else torch.long)


@dataclasses.dataclass
class Run:
    """A training run set up from the flags: model config, data, the step
    function and the current parameters and optimizer state; ``rank`` is
    this process's rank in the data-parallel group of a sharded run (else
    0)."""
    cfg: Any
    device: torch.device
    data: Any
    step_fn: Callable
    params: dict
    opt_state: Any
    rank: int = 0

    def batch(self, step: int) -> dict:
        """Batch ``step`` on the device: token leaves as long, the vlm's
        ``embeds`` as f32 (the model casts them to its dtype, as the
        reference does), a loss ``mask`` in the dtype ``jnp.asarray``
        gives it (64-bit numbers narrowed to 32, bool kept)."""
        return {k: batch_leaf(k, v, self.device)
                for k, v in self.data.batch(step).items()}

    def step(self, step: int) -> dict:
        """Train on batch ``step``; returns the step's metrics tensors."""
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, self.batch(step))
        return metrics


def data_parallel_group(args: argparse.Namespace):
    """The process group of a sharded run, or None (module docstring).  A
    group already initialized in this process is used as it is; else one
    is initialized over gloo from ``torch.distributed.run``'s environment
    when ``WORLD_SIZE`` > 1."""
    if args.stats_reduction != "sharded":
        return None
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and args.batch % world == 0:
        if not dist.is_initialized():
            dist.init_process_group("gloo")
        if dist.get_rank() == 0:
            print(f"sharded stats over data axis ({world} ranks)")
        return dist.group.WORLD
    print(f"sharded stats requested but devices={world} batch={args.batch}; "
          f"falling back to replicated")
    return None


def start(args: argparse.Namespace, params: Optional[dict] = None) -> Run:
    """Set a run up from the flags.  ``params`` replaces the seeded
    initialization (parity tests start both packages from the same
    weights)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the trainer runs on the card "
                           "unless asked for --device cpu")
    group = data_parallel_group(args)
    rank = 0 if group is None else dist.get_rank(group)
    if group is not None and device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # one rank builds the kernels (into build/repro_torch/), the
        # others wait for the libraries
        if rank == 0:
            build.build_all()
        dist.barrier(group)

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
        quantized_epilogue=args.quantized_epilogue,
        stats_reduction=args.stats_reduction))
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, num_codebooks=cfg.num_codebooks,
        embed_dim=0 if cfg.embed_inputs else cfg.d_model))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model_lib.init_params(cfg, gen, device=device)
    return Run(cfg=cfg, device=device, data=data,
               step_fn=make_train_step(cfg, tx, data_parallel_group=group),
               params=params, opt_state=tx.init(tree.flatten(params)),
               rank=rank)


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def rank_report(run: Run, log: list, exchanges: list) -> dict:
    """What ``--rank-report`` writes for this rank (module docstring)."""
    state = [leaf for leaf in ckpt_lib.leaves(run.opt_state)
             if not leaf.transient and isinstance(leaf.value, torch.Tensor)]
    return dict(
        rank=run.rank, device=str(run.device),
        launches=kernel_registry.launch_counts(),
        steps=[dict(rec, exchanges=x) for rec, x in zip(log, exchanges)],
        peak_bytes=(torch.cuda.max_memory_allocated(run.device)
                    if run.device.type == "cuda" else None),
        params_sha256=_digest(tree.flatten(run.params)),
        second_moment_sha256=_digest(
            [leaf.value for leaf in state if leaf.role == "second_moment"]),
        opt_state_sha256=_digest([leaf.value for leaf in state]))


def train(args: argparse.Namespace, params: Optional[dict] = None
          ) -> tuple[Run, list]:
    """Run training steps up to ``args.steps`` (from a checkpoint's step
    with ``--resume``); returns the run (final parameters and optimizer
    state) and one metrics record per step run: step, loss, grad_norm,
    time_s (host clock around the step, after the device finished it)."""
    run = start(args, params)
    is_main = run.rank == 0
    say = print if is_main else (lambda *a, **k: None)
    start_step, ckpt = 0, None
    if args.checkpoint_dir:
        if is_main:
            ckpt = ckpt_lib.AsyncCheckpointer(args.checkpoint_dir)
        if args.resume \
                and ckpt_lib.latest_step(args.checkpoint_dir) is not None:
            (run.params, run.opt_state), start_step, _ = ckpt_lib.restore(
                args.checkpoint_dir, (run.params, run.opt_state))
            say(f"resumed from step {start_step}")
    n_params = sum(p.numel() for p in tree.flatten(run.params))
    say(f"arch={run.cfg.name} params={n_params / 1e6:.1f}M "
        f"optimizer={args.optimizer} device={run.device} "
        f"second_moment={args.second_moment_dtype} "
        f"({api.second_moment_bytes(run.opt_state)} bytes)")
    exchanges = None
    if args.rank_report:
        kernel_registry.zero_launch_counts()
        if run.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(run.device)
        exchanges = []
    monitor = StragglerMonitor()
    log = []
    for step in range(start_step, args.steps):
        if exchanges is not None:
            dreduce.merge_log = []
        monitor.start()
        metrics = run.step(step)
        loss = float(metrics["loss"])
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        dt = monitor.stop()
        record = {"step": step, "loss": loss,
                  "grad_norm": float(metrics["grad_norm"]), "time_s": dt}
        log.append(record)
        if exchanges is not None:
            exchanges.append(dreduce.merge_log)
            dreduce.merge_log = None
        if step % args.log_every == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {loss:.4f} "
                f"gnorm {record['grad_norm']:.3f} {dt * 1e3:.0f}ms")
        if ckpt and step and step % args.checkpoint_every == 0:
            ckpt.save(step, (run.params, run.opt_state))
    if ckpt:
        ckpt.save(args.steps, (run.params, run.opt_state))
        ckpt.wait()
    if monitor.flagged:
        say(f"straggler steps flagged: {monitor.flagged} "
            f"(median {monitor.median * 1e3:.0f}ms)")
    if exchanges is not None:
        os.makedirs(args.rank_report, exist_ok=True)
        with open(os.path.join(args.rank_report,
                               f"rank-{run.rank}.json"), "w") as f:
            json.dump(rank_report(run, log, exchanges), f, indent=1)
    if args.metrics_out and is_main:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=2)
    return run, log


def main(argv: Optional[list] = None) -> list:
    """Command-line entry point; returns the per-step metrics records.  A
    process group the launcher initialized is destroyed at the end."""
    owned = not dist.is_initialized()
    try:
        return train(parse_args(argv))[1]
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
