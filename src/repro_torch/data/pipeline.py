"""Deterministic synthetic token stream (copy of repro/data/pipeline.py
``SyntheticLM``; numpy only, so both packages draw the same batches bit for
bit).

Each batch is indexed by (step, host), so restarts reproduce exactly.  The
stream mixes Zipf-distributed unigrams with repeated motifs, giving the
model structure to learn.  With ``num_codebooks`` K (musicgen) a batch
holds K such streams stacked on the last axis; with ``embed_dim`` (the vlm
frontend's stub) it holds the embeddings of one stream, looked up in a
table of normals drawn from ``seed``.  The reference draws that table on
every batch; it depends on ``seed`` and its shape alone, so here it is
drawn at the first embeddings batch and kept (``embedding_table``: the last
two tables drawn in the process, a reduced arch's beside a full one's,
shared by every ``SyntheticLM`` of that seed and shape, read-only).
qwen2-vl's is 152,064 x 8,192, 1.25 G normals (4.98 GB of f32); it is drawn
in row chunks, the same stream of normals.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    num_codebooks: int = 0      # musicgen-style multi-stream tokens
    embed_dim: int = 0          # >0: emit embeddings (vlm frontend stub)


# rows of the embeddings table drawn at once (an f64 chunk of 8192 x 8192
# is 0.5 GB)
TABLE_CHUNK_ROWS = 8192


@functools.lru_cache(maxsize=2)
def embedding_table(seed: int, vocab_size: int, embed_dim: int
                    ) -> np.ndarray:
    """The (vocab_size, embed_dim) f32 embeddings table, as the reference
    draws it: ``default_rng(seed).normal(size=(V, D))`` cast to f32, then
    times 0.02 in f32."""
    rng = np.random.default_rng(seed)
    table = np.empty((vocab_size, embed_dim), np.float32)
    for lo in range(0, vocab_size, TABLE_CHUNK_ROWS):
        rows = min(TABLE_CHUNK_ROWS, vocab_size - lo)
        table[lo:lo + rows] = rng.normal(
            size=(rows, embed_dim)).astype(np.float32) * 0.02
    table.flags.writeable = False
    return table


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
        local = cfg.global_batch // num_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host]))
        if cfg.num_codebooks:
            toks = np.stack([self._tokens(rng, local)
                             for _ in range(cfg.num_codebooks)], axis=-1)
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        toks = self._tokens(rng, local)
        if cfg.embed_dim:
            table = embedding_table(cfg.seed, cfg.vocab_size, cfg.embed_dim)
            return {"embeds": table[toks[:, :-1]],
                    "labels": toks[:, 1:]}
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
