"""Deterministic load generator for serving (copy of
repro/serve/loadgen.py; numpy only, so both packages draw the same arrivals
bit for bit).

A tick-based arrival process where each tick draws a Poisson number of
requests at the shape's current rate.  Two shapes:

  * ``constant`` — fixed ``rate`` requests/tick for ``ticks`` ticks.
  * ``step``     — ``rate`` until ``step_at``, then ``rate * step_mult``
                   (the load spike the p99 latency row is about).

Arrivals are deterministic given ``seed``: every tick uses its own
seeded generator, so ``arrivals(t)`` is pure — benchmarks and tests replay
identical traffic regardless of call order.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.serve.engine import Request

SHAPES = ("constant", "step")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    shape: str = "constant"   # constant | step
    rate: float = 1.0         # mean requests per tick
    ticks: int = 32           # total ticks in the run
    step_at: int = 16         # (step) tick where the rate jumps
    step_mult: float = 4.0    # (step) rate multiplier after the jump
    prompt_len: int = 8       # prompt tokens per request
    new_tokens: int = 8       # max_new_tokens per request
    temperature: float = 0.0  # per-request sampling temperature
    seed: int = 0

    def __post_init__(self):
        if self.shape not in SHAPES:
            raise ValueError(f"shape must be one of {SHAPES}, got "
                             f"{self.shape!r}")
        if self.rate < 0:
            raise ValueError(f"rate must be >= 0, got {self.rate}")


class LoadGenerator:
    """Replayable request stream: ``arrivals(tick) -> List[Request]``."""

    def __init__(self, cfg: TrafficConfig, vocab_size: int):
        self.cfg = cfg
        self.vocab_size = vocab_size

    def rate_at(self, tick: int) -> float:
        cfg = self.cfg
        if cfg.shape == "step" and tick >= cfg.step_at:
            return cfg.rate * cfg.step_mult
        return cfg.rate

    def arrivals(self, tick: int) -> List[Request]:
        cfg = self.cfg
        rng = np.random.default_rng([cfg.seed, tick])   # pure per tick
        n = int(rng.poisson(self.rate_at(tick)))
        return [Request(
            prompt=rng.integers(0, self.vocab_size, size=(cfg.prompt_len,),
                                dtype=np.int32),
            max_new_tokens=cfg.new_tokens,
            temperature=cfg.temperature) for _ in range(n)]

    def total_expected(self) -> float:
        return sum(self.rate_at(t) for t in range(self.cfg.ticks))
