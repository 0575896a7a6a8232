"""Deterministic synthetic token stream (copy of the token path of
repro/data/pipeline.py ``SyntheticLM``; numpy only, so both packages draw
the same batches bit for bit).

Each batch is indexed by (step, host), so restarts reproduce exactly.  The
stream mixes Zipf-distributed unigrams with repeated motifs, giving the
model structure to learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16


class SyntheticLM:
    """Stateless batch generator: batch(step, host, num_hosts)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank shared by all hosts
        self.motifs = rng.integers(
            0, cfg.vocab_size, size=(64, cfg.motif_len), dtype=np.int64)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = p / p.sum()

    def _tokens(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        cfg = self.cfg
        S = cfg.seq_len + 1
        toks = rng.choice(cfg.vocab_size, size=(batch, S), p=self.unigram)
        # plant motifs: second half of a motif is predictable from the first
        if S > cfg.motif_len:
            n_plants = max(S // (4 * cfg.motif_len), 1)
            for b in range(batch):
                for _ in range(n_plants):
                    m = self.motifs[rng.integers(0, len(self.motifs))]
                    start = rng.integers(0, S - cfg.motif_len)
                    toks[b, start:start + cfg.motif_len] = m
        return toks.astype(np.int32)

    def batch(self, step: int, host: int = 0, num_hosts: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split "
                             f"over {num_hosts} hosts")
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host]))
        toks = self._tokens(rng, cfg.global_batch // num_hosts)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
