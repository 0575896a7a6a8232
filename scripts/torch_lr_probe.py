"""Loss curves of the PyTorch port at full-width paper-lm-100m with Sketchy
at the launcher's default peak lr (3e-3), on one CUDA card.

    python3 scripts/torch_lr_probe.py

Three 12-step runs from the same seeded weights and batches, at the
launcher's other defaults (rank 64, block 1024, update_every 10, batch 8 x
seq 128): the model in bf16 and in f32 with a 12-step schedule (one warmup
step), and the model in bf16 with the launcher's default 200-step schedule
(ten warmup steps).  Prints the card, then one JSON line per run with its
losses.  It separates a fault in the port's bf16 casts (the f32 run would
fall where the bf16 run rises) from a peak lr too high for a one-step
warmup (both rise).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.factory import OptimizerConfig, make_optimizer  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

STEPS = 12


def losses(dtype: str, total_steps: int, dev: torch.device) -> list:
    cfg = dataclasses.replace(registry.get_config("paper-lm-100m"),
                              dtype=dtype)
    tx = make_optimizer(OptimizerConfig(
        learning_rate=3e-3, total_steps=total_steps, rank=64,
        block_size=1024, update_every=10, weight_decay=1e-4))
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    state = tx.init(tree.flatten(params))
    step_fn = make_train_step(cfg, tx)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=128,
                                  global_batch=8, seed=0))
    out = []
    for step in range(STEPS):
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in data.batch(step).items()}
        params, state, metrics = step_fn(params, state, batch)
        out.append(float(metrics["loss"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for dtype, total in (("bfloat16", STEPS), ("float32", STEPS),
                         ("bfloat16", 200)):
        print(json.dumps({"dtype": dtype, "total_steps": total, "lr": 3e-3,
                          "losses": losses(dtype, total, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
