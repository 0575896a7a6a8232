"""Continuous-batching decode engine with slot reuse, session-style (port of
repro/serve/engine.py).

The serving surface is ``submit`` / ``step`` / ``drain``:

    engine = Engine(cfg, params, ServeConfig(batch=4, max_seq=64))
    h = engine.submit(Request(prompt, max_new_tokens=12))
    while not h.done:
        engine.step()
    print(h.tokens)

Each of the ``ServeConfig.batch`` lanes runs at its own sequence position
(``models/cache.decode_step`` takes a (B,) position vector): a short request
frees its lane the step it finishes, and the next queued request prefills
into the wiped slot (``cache.reset_lanes``) while its co-tenants keep
decoding.  Per-request ``max_new_tokens`` and ``temperature`` hold per lane.
Prefill runs through the decode path one token per step per lane, as in the
reference.

The engine runs on the device of the parameters.  Greedy decoding (the
argmax of the logits) gives the reference's tokens from the same weights up
to ties.  Temperature sampling draws from a ``torch.Generator`` seeded from
``ServeConfig.seed`` on the engine's device (by the Gumbel-max trick, as
``jax.random.categorical`` samples); it cannot give the reference's
``jax.random`` bits, so sampled tokens differ between the packages.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    """Engine-level serving knobs (the per-request knobs live on Request)."""
    batch: int = 4        # number of batch lanes (requests decoding at once)
    max_seq: int = 64     # per-lane cache capacity (prompt + generated)
    seed: int = 0         # sampling generator seed


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (P,) int32 prompt tokens
    max_new_tokens: int = 16
    temperature: float = 0.0    # 0 => greedy


@dataclasses.dataclass
class Result:
    tokens: List[int]


class RequestHandle:
    """Ticket returned by ``Engine.submit``; filled in as the engine steps.

    ``tokens`` grows one entry per emitted token; ``token_times`` records a
    host-clock stamp per emission, taken after the token reached the host
    (inter-token latencies are read off these).  ``done`` flips when
    ``max_new_tokens`` have been emitted and the lane is freed.
    """

    def __init__(self, rid: int, request: Request, submit_step: int):
        self.id = rid
        self.request = request
        self.tokens: List[int] = []
        self.token_times: List[float] = []
        self.done = False
        self.submit_step = submit_step      # engine step count at submit
        self.start_step: Optional[int] = None   # lane assignment
        self.finish_step: Optional[int] = None

    @property
    def result(self) -> Result:
        return Result(tokens=list(self.tokens))

    def __repr__(self):
        state = "done" if self.done else \
            ("active" if self.start_step is not None else "queued")
        return (f"RequestHandle(id={self.id}, {state}, "
                f"tokens={len(self.tokens)}/{self.request.max_new_tokens})")


class Engine:
    """Continuous-batching engine: per-lane positions, slot reuse, queueing."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 serve: ServeConfig = ServeConfig()):
        if not cfg.embed_inputs or cfg.num_codebooks:
            raise ValueError(
                f"serving supports token-input archs only; {cfg.name!r} has "
                f"embed_inputs={cfg.embed_inputs} "
                f"num_codebooks={cfg.num_codebooks}")
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.device = params["embed"].device
        B = serve.batch

        self.cache = cache_lib.init_cache(cfg, B, serve.max_seq, self.device)
        self.lane_pos = np.zeros((B,), np.int64)    # tokens cached per lane
        self._fresh = np.zeros((B,), bool)          # wipe lane before step
        self.lanes: List[Optional[RequestHandle]] = [None] * B
        self.queue: Deque[RequestHandle] = collections.deque()
        self.step_count = 0
        self._next_id = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            serve.seed)

    @torch.no_grad()
    def _step(self, tokens: np.ndarray, temps: np.ndarray) -> np.ndarray:
        """One decode step of every lane: lane wipe, decode, per-lane
        greedy or sampled next token (B,)."""
        dev = self.device
        cache_lib.reset_lanes(self.cache,
                              torch.from_numpy(self._fresh).to(dev))
        logits, self.cache = cache_lib.decode_step(
            self.cfg, self.params, self.cache,
            {"token": torch.from_numpy(tokens).to(dev)},
            torch.from_numpy(self.lane_pos).to(dev))
        logits = logits[:, -1]                          # (B, V)
        nxt = torch.argmax(logits, dim=-1)
        if temps.max() > 0:
            t = torch.from_numpy(temps).to(dev)
            scaled = logits.float() / torch.clamp(t, min=1e-6)[:, None]
            u = torch.rand(scaled.shape, generator=self._gen, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
            sampled = torch.argmax(scaled + gumbel, dim=-1)
            nxt = torch.where(t > 0, sampled, nxt)
        return nxt.cpu().numpy()

    # -- session API --------------------------------------------------------

    def submit(self, request: Request) -> RequestHandle:
        """Queue a request; it claims a batch lane as soon as one is free."""
        P = len(request.prompt)
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{request.max_new_tokens}")
        if P < 1:
            raise ValueError("empty prompt")
        if P + request.max_new_tokens > self.serve.max_seq:
            raise ValueError(
                f"prompt ({P}) + max_new_tokens ({request.max_new_tokens}) "
                f"exceeds max_seq={self.serve.max_seq}")
        handle = RequestHandle(self._next_id, request, self.step_count)
        self._next_id += 1
        self.queue.append(handle)
        self._fill_lanes()
        return handle

    def _fill_lanes(self) -> None:
        for i in range(self.serve.batch):
            if self.lanes[i] is None and self.queue:
                h = self.queue.popleft()
                self.lanes[i] = h
                self.lane_pos[i] = 0
                self._fresh[i] = True
                h.start_step = self.step_count

    @property
    def active(self) -> int:
        return sum(h is not None for h in self.lanes)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def step(self) -> List[RequestHandle]:
        """Advance every active lane by one token; returns the handles that
        completed this step (their lanes are freed for the queue)."""
        self._fill_lanes()
        if self.active == 0:
            return []
        B = self.serve.batch
        tokens = np.zeros((B, 1), np.int64)
        temps = np.zeros((B,), np.float32)
        for i, h in enumerate(self.lanes):
            if h is None:
                continue
            pos = int(self.lane_pos[i])
            prompt = h.request.prompt
            # the lane's sequence is prompt + generated; feed the token at
            # the lane's current position
            tokens[i, 0] = prompt[pos] if pos < len(prompt) \
                else h.tokens[pos - len(prompt)]
            temps[i] = h.request.temperature

        nxt = self._step(tokens, temps)
        self._fresh[:] = False
        self.step_count += 1

        now = time.perf_counter()
        completed: List[RequestHandle] = []
        for i, h in enumerate(self.lanes):
            if h is None:
                continue
            self.lane_pos[i] += 1
            if self.lane_pos[i] >= len(h.request.prompt):
                # the model's output at this position is a generated token
                h.tokens.append(int(nxt[i]))
                h.token_times.append(now)
                if len(h.tokens) >= h.request.max_new_tokens:
                    h.done = True
                    h.finish_step = self.step_count
                    self.lanes[i] = None        # slot reuse: free the lane
                    completed.append(h)
        return completed

    def drain(self) -> List[RequestHandle]:
        """Step until every queued and active request completes; returns the
        completed handles in submission order."""
        done: List[RequestHandle] = []
        while self.queue or self.active:
            done.extend(self.step())
        return sorted(done, key=lambda h: h.id)

    # -- legacy one-shot API (deprecated) -----------------------------------

    def generate(self, requests: List[Request], seed: int = 0) -> List[Result]:
        """Deprecated wrapper over submit/drain: each request stops at its
        own ``max_new_tokens`` and samples at its own temperature."""
        if len(requests) > self.serve.batch:
            raise ValueError(f"{len(requests)} requests > "
                             f"{self.serve.batch} lanes; use submit()/drain()")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        handles = [self.submit(r) for r in requests]
        self.drain()
        return [h.result for h in handles]
