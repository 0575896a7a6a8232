"""One rank of the gloo process group that tests/test_torch_distributed_ranks.py
starts, four fresh interpreters in all:

    python tests/torch_dist_ranks.py RANK WORLD RENDEZVOUS_FILE OUT_DIR

It imports no JAX and nothing of ``repro``: PyTorch, numpy and the port.
The rank runs on one CPU thread, joins the group through a file
rendezvous, runs every scenario below and saves what it computed to
``OUT_DIR/rank-<RANK>.pt``; the test functions hold those results against
the reference.  The inputs come from numpy seeds, the same on every rank
(the test imports this module for them):

  * ``butterfly``: each rank's sketch of its own gradients (N 2, d 16, ell
    6), merged over the 4 ranks, under the fp32 and the int8 wire;
  * ``gather``: the same over the subgroup of ranks 0-2, whose size is no
    power of two (the all-gather and one wide merge);
  * ``engine``: the sharded Sketchy engine over the 4 ranks for 3 steps,
    handed the local gradients by the trainer's side channel, and again
    without it (``engine_no_ctx``: the engine forms the mean); and its
    other paths together (``engine_modes``: staggered, async, int8
    storage, a rho_greedy rank budget);
  * ``one``: rank 0 alone, on a group of one: the sharded engine and the
    sharded trainer against the replicated ones;
  * ``trainer``: the reduced paper-lm-100m trained 6 steps with sharded
    statistics over the 4 ranks.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import fd as tfd  # noqa: E402
from repro_torch.core import sketchy as tsk  # noqa: E402
from repro_torch.core.factory import OptimizerConfig, make_optimizer  # noqa
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.distributed import reduce as dreduce  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.train.trainer import make_train_step  # noqa: E402

WORLD = 4
SKETCH = dict(N=2, d=16, ell=6)         # the butterfly's and gather's stacks
GATHER_RANKS = [0, 1, 2]
ENGINE = dict(d=16, rank=6, beta2=0.9, steps=3, vec=10)
TRAINER = dict(seq=32, batch=8, steps=6)
TRAINER_OPT = dict(name="sketchy", learning_rate=1e-3, total_steps=8, rank=8,
                   block_size=64, update_every=2, schedule="constant")


def butterfly_inputs() -> np.ndarray:
    """(WORLD, N, d, 1): rank i's gradient column of each block."""
    rng = np.random.default_rng(0)
    return rng.normal(size=(WORLD, SKETCH["N"], SKETCH["d"], 1)).astype(
        np.float32)


def gather_inputs() -> np.ndarray:
    """(3, N, d, 2): rank i's two gradient columns of each block."""
    rng = np.random.default_rng(1)
    return rng.normal(size=(len(GATHER_RANKS), SKETCH["N"], SKETCH["d"],
                            2)).astype(np.float32)


def engine_inputs() -> dict:
    """The engine scenario's parameters ``w`` (d, d) and ``v`` (vec,) and
    each rank's gradients of both, (WORLD, ...)."""
    rng = np.random.default_rng(2)
    d, n = ENGINE["d"], ENGINE["vec"]
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(w=f32(d, d), v=f32(n), gw=f32(WORLD, d, d), gv=f32(WORLD, n))


def engine_config(**kw) -> tsk.SketchyConfig:
    rank = ENGINE["rank"]
    return tsk.SketchyConfig(
        rank_budget=tsk.RankBudget(min_k=rank, max_k=rank),
        block_size=ENGINE["d"], beta2=ENGINE["beta2"], update_every=1, **kw)


def trainer_setup(group=None):
    """(config, step function, parameters, data) of the trainer scenario,
    the parameters from seed 0; ``group`` as ``make_train_step`` takes it."""
    cfg = registry.get_reduced("paper-lm-100m")
    tx = make_optimizer(OptimizerConfig(
        **TRAINER_OPT,
        stats_reduction="replicated" if group is None else "sharded"))
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAINER["seq"],
                                  global_batch=TRAINER["batch"]))
    step = make_train_step(cfg, tx, data_parallel_group=group)
    return cfg, tx, step, params, data


def train(group=None, steps: int = TRAINER["steps"]) -> dict:
    """The trainer scenario: losses and final parameters."""
    _, tx, step, params, data = trainer_setup(group)
    state = tx.init(tree.flatten(params))
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).long()
                 for k, v in data.batch(i).items()}
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return dict(losses=losses,
                params=[p.detach().clone() for p in tree.flatten(params)])


def _plain(state) -> tuple:
    return tuple(t.detach().clone() for t in state)


def run_engine(stats_reduction: str, group=None, wire: str = "fp32",
               rank: int = 0, own: bool = False, ctx: bool = True) -> dict:
    """The engine scenario: the Sketchy engine for 3 steps.  With a
    ``group``, over the mean of its ranks' gradients, this rank's own as
    its local gradients (or, without ``ctx``, this rank's own as the
    updates, whose mean the engine forms); without a group, over the mean
    of all ranks' gradients, or rank ``rank``'s own with ``own``.  Returns
    the directions, the pool's sketches and the diagonal accumulator of
    ``v``."""
    x = engine_inputs()
    tx = tsk.sketchy(engine_config(stats_reduction=stats_reduction,
                                   stats_wire_dtype=wire))
    params = [torch.from_numpy(x["v"]), torch.from_numpy(x["w"])]
    mean = [torch.from_numpy(x["gv"].mean(0)), torch.from_numpy(x["gw"]
                                                                .mean(0))]
    local = [torch.from_numpy(x["gv"][rank]), torch.from_numpy(x["gw"][rank])]
    state = tx.init(params)
    for _ in range(ENGINE["steps"]):
        if group is None:
            dirs, state = tx.update(local if own else mean, state, params)
            continue
        with dreduce.bind_axis("data", group):
            if not ctx:
                dirs, state = tx.update(local, state, params)
                continue
            grads = dreduce.pmean(local, "data")
            with dreduce.local_gradients(local):
                dirs, state = tx.update(grads, state, params)
    stats = api.pool_stats(state)
    return dict(dirs=[d.clone() for d in dirs], left=_plain(stats.left),
                right=_plain(stats.right),
                diag=state.leaves[0].stats.clone())


def run_engine_modes(group, rank: int) -> dict:
    """The engine scenario's gradients through the sharded engine's other
    paths at once: the staggered schedule, the async refresh, int8 storage
    and a rho_greedy rank budget (4 blocks of 8 x 8, ranks 2-4, a
    reallocation every refresh window), 6 steps refreshing every 2; the
    pools and the directions."""
    x = engine_inputs()
    tx = tsk.sketchy(tsk.SketchyConfig(
        rank_budget=tsk.RankBudget(total=12, min_k=2, max_k=4,
                                   policy="rho_greedy"),
        block_size=8, beta2=ENGINE["beta2"], update_every=2,
        refresh_schedule="staggered", refresh_mode="async",
        second_moment_dtype="int8", stats_reduction="sharded"))
    params = [torch.from_numpy(x["v"]), torch.from_numpy(x["w"])]
    local = [torch.from_numpy(x["gv"][rank]), torch.from_numpy(x["gw"][rank])]
    state = tx.init(params)
    for step in range(6):
        grads = [g * (step + 1) for g in local]
        with dreduce.bind_axis("data", group):
            dirs, state = tx.update(grads, state, params)
    pools = api.committed_pools(state)
    return dict(dirs=[d.clone() for d in dirs],
                pools=[t.clone() for t in api._leaves(list(pools.values()))])


def main(rank: int, world: int, rendezvous: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        out = {}
        everyone = dist.group.WORLD
        # every rank takes part in creating every group
        sub = dist.new_group(GATHER_RANKS)
        one = dist.new_group([0])
        N, d, ell = SKETCH["N"], SKETCH["d"], SKETCH["ell"]

        G = butterfly_inputs()
        local = tfd.fd_update_batched(tfd.fd_init(d, ell, num_blocks=N),
                                      torch.from_numpy(G[rank]))
        with dreduce.bind_axis("data", everyone):
            assert dreduce.bound_axis_size("data") == world
            for wire in ("fp32", "int8"):
                out[f"butterfly_{wire}"] = _plain(dreduce.butterfly_merge_fd(
                    local, axis="data", axis_size=world, wire_dtype=wire))

        if rank in GATHER_RANKS:
            Gg = gather_inputs()
            local = tfd.fd_update_batched(tfd.fd_init(d, ell, num_blocks=N),
                                          torch.from_numpy(Gg[rank]))
            with dreduce.bind_axis("data", sub):
                for wire in ("fp32", "int8"):
                    out[f"gather_{wire}"] = _plain(dreduce.butterfly_merge_fd(
                        local, axis="data", axis_size=len(GATHER_RANKS),
                        wire_dtype=wire))

        out["engine"] = run_engine("sharded", everyone, rank=rank)
        out["engine_no_ctx"] = run_engine("sharded", everyone, rank=rank,
                                          ctx=False)
        out["engine_modes"] = run_engine_modes(everyone, rank)

        if rank == 0:
            out["one_engine"] = run_engine("sharded", one)
            out["one_engine_replicated"] = run_engine("replicated", own=True)
            out["one_trainer"] = train(one, steps=2)
            out["one_trainer_replicated"] = train(None, steps=2)
        dist.barrier()

        out["trainer"] = train(everyone)
        torch.save(out, os.path.join(out_dir, f"rank-{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
