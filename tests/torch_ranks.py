"""Launchers of the processes the port's multi-rank tests compare: a gloo
process group of fresh interpreters (PyTorch and the port only, one CPU
thread each, a file rendezvous; the pytest process never joins a group),
and one JAX interpreter with several forced host devices for the
reference's multi-device runs."""
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CLEAR = ("XLA_FLAGS", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
          "LOCAL_RANK")


def start_ranks(script: str, args: list, world: int, out) -> list:
    """Start ``python SCRIPT *args RANK WORLD RENDEZVOUS OUT`` for every rank,
    each writing its output to ``out/log-<rank>.txt``; returns the
    processes."""
    env = {k: v for k, v in os.environ.items() if k not in _CLEAR}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME=env.get("GLOO_SOCKET_IFNAME", "lo"))
    procs = []
    for r in range(world):
        with open(out / f"log-{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, script, *map(str, args), str(r), str(world),
                 str(out / "rendezvous"), str(out)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    return procs


def start_jax(code: str, args: list, devices: int,
              out) -> subprocess.Popen:
    """Start ``python -c CODE *args`` with ``devices`` forced host devices
    on the CPU and ``src`` on the path, its output to
    ``out/log-jax.txt``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    with open(out / "log-jax.txt", "w") as log:
        return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                                stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=REPO)


def wait_all(procs: list, out, limit_s: float) -> None:
    """Wait at most ``limit_s`` for every process (then kill them all and
    fail); fail with the tails of their logs unless all exited 0."""
    deadline = time.monotonic() + limit_s
    timed_out = False
    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = sorted(out.glob("log-*.txt"))
    tails = "\n".join(f"--- {p.name}:\n" + p.read_text()[-3000:]
                      for p in logs)
    if timed_out:
        pytest.fail(f"the processes did not finish within {limit_s} s\n"
                    f"{tails}")
    if any(proc.returncode != 0 for proc in procs):
        pytest.fail(f"exit codes {[p.returncode for p in procs]}\n{tails}")


def load_ranks(out, world: int) -> list:
    """What each rank saved (``out/rank-<r>.pt``), by rank."""
    return [torch.load(out / f"rank-{r}.pt", weights_only=False)
            for r in range(world)]
