"""Loss curves of the JAX reference and of the PyTorch port for one layer of
qwen2-vl-72b, with Sketchy at the launchers' defaults (rank 64, block
1024, update_every 10, batch 8 x seq 128, weight decay 1e-4), on the CPU,
from the same weights and batches.

    PYTHONPATH=src JAX_PLATFORMS=cpu python vlm_width_lr_cpu.py
    PYTHONPATH=src JAX_PLATFORMS=cpu python vlm_width_lr_cpu.py --witness

Without flags: d_model cut to 2048 with the full vocabulary, 4 steps at
peak learning rates 3e-4 and 3e-5 (about 4 minutes a rate on 8 cores, 10
GB of host memory).  The width is cut as ``d_model`` with head dim 128,
``d_model / 128`` query heads, ``d_model / 1024`` KV heads (at least 1)
and the config's d_ff to d_model ratio; the vocabulary, the dtype and every
feature are the config's.

``--witness``: every width at the config's (d_model 8192, 64 query and 8
KV heads of 128, d_ff 29568) but the vocabulary cut from 152,064 to
WITNESS_VOCAB, 2 steps at lr 3e-4.  That is a different model from the one
the card trains (chip_smoke.py phase 9a keeps the full vocabulary, whose
CPU run would not fit a 66 GB host): its head is 4.6x smaller.  It prints
a count of the memory each side needs first (from the shapes: 27.2 GB, of
which 15.0 GB are the refresh's stacks over 1,122 blocks), then runs the
reference and the port each in a subprocess of its own (so that one side's
memory is freed before the other starts), from the same weights (both draw
them with the reference's ``init_params`` under the same key).  On a host
of 62 GB shared with other work the reference's side held 48 GB resident
before it printed its first loss and was stopped there: run it on a host
with about 64 GB to spare.

Both ask whether the loss curve seen on the card at full width
(chip_smoke.py phase 9a, lr 3e-4) is the reference's too.  Each prints one
JSON line per learning rate.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.core.factory import OptimizerConfig, make_optimizer
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models import model as jmodel
from repro.train.trainer import make_train_step
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.launch import train as tlaunch

ARCH, D_MODEL, STEPS, LRS = "qwen2-vl-72b", 2048, 4, (3e-4, 3e-5)
WITNESS_VOCAB, WITNESS_STEPS, WITNESS_LR = 32768, 2, 3e-4
BLOCK, RANK = 1024, 64


def cut(cfg, d_model: int, vocab: int | None = None):
    return dataclasses.replace(
        cfg, num_layers=1, d_model=d_model, head_dim=128,
        num_heads=d_model // 128, num_kv_heads=max(d_model // 1024, 1),
        d_ff=cfg.d_ff * d_model // cfg.d_model,
        vocab_size=vocab or cfg.vocab_size)


def reference(jcfg, lr: float, steps: int) -> list:
    tx = make_optimizer(OptimizerConfig(
        name="sketchy", learning_rate=lr, total_steps=steps, rank=RANK,
        block_size=BLOCK, update_every=10, weight_decay=1e-4))
    data = SyntheticLM(DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=128, global_batch=8, seed=0,
        num_codebooks=jcfg.num_codebooks,
        embed_dim=0 if jcfg.embed_inputs else jcfg.d_model))
    params = jax.jit(lambda key: jmodel.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    state = jax.jit(tx.init)(params)
    step = jax.jit(make_train_step(jcfg, tx, donate=True))
    ref = []
    for i in range(steps):
        params, state, metrics = step(params, state, {
            k: jnp.asarray(v) for k, v in data.batch(i).items()})
        ref.append(float(metrics["loss"]))
    return ref


def port(jcfg, d_model: int, vocab, lr: float, steps: int,
         init=None) -> list:
    if init is None:
        init = jax.tree.map(np.asarray, jax.jit(
            lambda key: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(0)))
    get = tregistry.get_config
    with mock.patch.object(tregistry, "get_config",
                           lambda name: cut(get(name), d_model, vocab)):
        tcfg = tregistry.get_config(ARCH)
        params = convert.params_from_numpy(tcfg, init)
        del init
        _, log = tlaunch.train(tlaunch.parse_args([
            "--arch", ARCH, "--steps", str(steps), "--lr", str(lr),
            "--log-every", str(steps), "--device", "cpu"]), params=params)
    return [r["loss"] for r in log]


def curves(lr: float) -> dict:
    jcfg = cut(jregistry.get_config(ARCH), D_MODEL)
    init = jax.tree.map(np.asarray, jax.jit(
        lambda key: jmodel.init_params(jcfg, key))(jax.random.PRNGKey(0)))
    ref = reference(jcfg, lr, STEPS)
    return {"arch": ARCH, "d_model": D_MODEL, "layers": 1, "lr": lr,
            "log_vocab": float(np.log(jcfg.vocab_size)),
            "reference": ref,
            "port": port(jcfg, D_MODEL, None, lr, STEPS, init)}


def memory_count(jcfg) -> dict:
    """Bytes each side holds at its peak, counted from the shapes alone
    (``jax.eval_shape``; nothing is allocated): the bf16 parameters and
    gradients, the optimizer state, the batch's f32 logits, and the
    refresh's three (N, block, block + rank) f32 stacks of one side (M,
    its Gram's eigenvectors, the projected factor; core/fd.py)."""
    shapes = jax.eval_shape(lambda key: jmodel.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    tx = make_optimizer(OptimizerConfig(
        name="sketchy", learning_rate=3e-4, total_steps=2, rank=RANK,
        block_size=BLOCK, update_every=10, weight_decay=1e-4))
    state = jax.eval_shape(tx.init, shapes)
    nbytes = lambda t: sum(math.prod(x.shape) * x.dtype.itemsize
                           for x in jax.tree.leaves(t))
    blocks = 0
    for x in jax.tree.leaves(shapes):
        if x.ndim >= 2:
            lead = math.prod(x.shape[:-2])
            blocks += lead * math.ceil(x.shape[-2] / BLOCK) * math.ceil(
                x.shape[-1] / BLOCK)
    params = nbytes(shapes)
    count = {
        "params": params, "grads": params, "opt_state": nbytes(state),
        "logits_f32": 8 * 128 * jcfg.vocab_size * 4,
        "blocks": blocks,
        "refresh_stacks": 3 * blocks * BLOCK * (BLOCK + RANK) * 4}
    count["total"] = (count["params"] + count["grads"] + count["opt_state"]
                      + count["logits_f32"] + count["refresh_stacks"])
    return count


def witness_side(side: str) -> None:
    jcfg = cut(jregistry.get_config(ARCH), jregistry.get_config(
        ARCH).d_model, WITNESS_VOCAB)
    t0 = time.time()
    if side == "reference":
        losses = reference(jcfg, WITNESS_LR, WITNESS_STEPS)
    else:
        losses = port(jcfg, jcfg.d_model, WITNESS_VOCAB, WITNESS_LR,
                      WITNESS_STEPS)
    print(json.dumps({"side": side, "losses": losses,
                      "seconds": time.time() - t0}), flush=True)


def witness() -> None:
    jcfg = cut(jregistry.get_config(ARCH), jregistry.get_config(
        ARCH).d_model, WITNESS_VOCAB)
    count = memory_count(jcfg)
    print(json.dumps({"memory_count": count}), flush=True)
    out = {"arch": ARCH, "d_model": jcfg.d_model, "layers": 1,
           "vocab": WITNESS_VOCAB, "lr": WITNESS_LR,
           "log_vocab": float(np.log(WITNESS_VOCAB))}
    for side in ("reference", "port"):
        run = subprocess.run(
            [sys.executable, __file__, "--witness-side", side],
            capture_output=True, text=True, check=True)
        line = json.loads(run.stdout.strip().splitlines()[-1])
        out[side] = line["losses"]
        out[side + "_seconds"] = line["seconds"]
        print(json.dumps(line), flush=True)
    print(json.dumps(out), flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--witness", action="store_true")
    p.add_argument("--witness-side", choices=("reference", "port"))
    args = p.parse_args()
    torch.set_num_threads(8)
    if args.witness_side:
        witness_side(args.witness_side)
    elif args.witness:
        witness()
    else:
        for lr in LRS:
            print(json.dumps(curves(lr)), flush=True)


if __name__ == "__main__":
    main()
