"""Loss curves of the JAX reference and of the PyTorch port for one layer of
qwen2-vl-72b cut to d_model 2048 but with its full vocabulary, with
Sketchy at the launchers' defaults (rank 64, block 1024, update_every 10,
batch 8 x seq 128, weight decay 1e-4), on the CPU, from the same weights
and batches, over 4 steps at peak learning rates 3e-4 and 3e-5.

    PYTHONPATH=src JAX_PLATFORMS=cpu python vlm_width_lr_cpu.py

The width is cut as ``d_model`` with head dim 128, ``d_model / 128`` query
heads, ``d_model / 1024`` KV heads (at least 1) and the config's d_ff to
d_model ratio; the vocabulary, the dtype and every feature are the
config's.  It asks whether the loss curve seen on the card at full width
(chip_smoke.py phase 9a, lr 3e-4) is the reference's too.  Prints one JSON
line per learning rate.  About 4 minutes a rate on 8 cores, and 10 GB of
host memory.
"""
from __future__ import annotations

import dataclasses
import json
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


def cut(cfg, d_model: int):
    return dataclasses.replace(
        cfg, num_layers=1, d_model=d_model, head_dim=128,
        num_heads=d_model // 128, num_kv_heads=max(d_model // 1024, 1),
        d_ff=cfg.d_ff * d_model // cfg.d_model)


def curves(lr: float) -> dict:
    jcfg = cut(jregistry.get_config(ARCH), D_MODEL)
    tx = make_optimizer(OptimizerConfig(
        name="sketchy", learning_rate=lr, total_steps=STEPS, rank=64,
        block_size=1024, update_every=10, weight_decay=1e-4))
    data = SyntheticLM(DataConfig(
        vocab_size=jcfg.vocab_size, seq_len=128, global_batch=8, seed=0,
        num_codebooks=jcfg.num_codebooks,
        embed_dim=0 if jcfg.embed_inputs else jcfg.d_model))
    params = jax.jit(lambda key: jmodel.init_params(jcfg, key))(
        jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    state = jax.jit(tx.init)(params)
    step = jax.jit(make_train_step(jcfg, tx, donate=False))
    ref = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, {
            k: jnp.asarray(v) for k, v in data.batch(i).items()})
        ref.append(float(metrics["loss"]))
    del params, state
    get = tregistry.get_config
    with mock.patch.object(tregistry, "get_config",
                           lambda name: cut(get(name), D_MODEL)):
        tcfg = tregistry.get_config(ARCH)
        _, log = tlaunch.train(tlaunch.parse_args([
            "--arch", ARCH, "--steps", str(STEPS), "--lr", str(lr),
            "--log-every", str(STEPS), "--device", "cpu"]),
            params=convert.params_from_numpy(tcfg, init))
    return {"arch": ARCH, "d_model": D_MODEL, "layers": 1, "lr": lr,
            "log_vocab": float(np.log(jcfg.vocab_size)),
            "reference": ref, "port": [r["loss"] for r in log]}


def main() -> None:
    torch.set_num_threads(8)
    for lr in LRS:
        print(json.dumps(curves(lr)), flush=True)


if __name__ == "__main__":
    main()
