"""Serving launcher: continuous batching, FD telemetry and online adaptation
(port of repro/launch/serve.py).

    # one-shot demo: submit a batch, drain, print tokens (on the card)
    python -m repro_torch.launch.serve --batch 4 --new-tokens 12

    # load-generator traffic + FD gradient monitor + S-AdaGrad adaptation
    python -m repro_torch.launch.serve \\
        --traffic shape=step,rate=1.0,ticks=24,step_at=12 \\
        --monitor window=4,ell=8 --adapt lr=0.1,beta2=0.95

    # the reduced model on the CPU
    python -m repro_torch.launch.serve --device cpu --traffic ticks=8 ...

The structured flags are ``key=value,...`` specs parsed against the config
dataclasses themselves (launch/flags.py): ``--traffic`` -> TrafficConfig,
``--adapt`` -> AdaptConfig, ``--monitor`` -> MonitorConfig.  With traffic,
each tick submits the generated arrivals, steps the engine, draws a
feedback batch, feeds its head gradient to the monitor, and runs one
adaptation step whenever the window policy says "adapt" (every tick when
there is no monitor).  The reduced config is the default (``--no-reduced``
for the full arch).  ``--arch`` takes paper-lm-100m (dense), mamba2-370m
(ssm) and zamba2-7b (hybrid); a tied-embedding model adapts its ``embed``.
Runs on ``--device cuda`` unless told otherwise, and raises if the machine
has no card.  Besides what the reference prints, it prints how many times
the run launched the single-block Gram and low-rank apply kernels (the
monitor's and S-AdaGrad's FD steps) and the flash attention and SSD scan
kernels (the feedback gradients' forwards); all 0 on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.lowrank import kernel as lowrank_kernel
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch.flags import parse_kv_spec
from repro_torch.models import model as model_lib
from repro_torch.serve import (ADAPT, AdaptConfig, Engine, GradientMonitor,
                               LoadGenerator, MonitorConfig, OnlineAdapter,
                               Request, ServeConfig, TrafficConfig)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    p.add_argument("--arch", default="paper-lm-100m")
    p.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                   default=True, help="use the registry's reduced config "
                   "(--no-reduced for the full arch)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-seq", type=int, default=64)
    p.add_argument("--new-tokens", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--traffic", default=None, metavar="K=V,...",
                   help="TrafficConfig spec, e.g. shape=step,rate=1,ticks=24")
    p.add_argument("--adapt", default=None, metavar="K=V,...",
                   help="AdaptConfig spec, e.g. lr=0.1,beta2=0.95,ell=8")
    p.add_argument("--monitor", default=None, metavar="K=V,...",
                   help="MonitorConfig spec, e.g. window=4,ell=8")
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU runs only when asked for")
    return p


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    return _parser().parse_args(argv)


def _launches() -> dict:
    return {"gram": gram_kernel.single_launches,
            "lowrank_apply": lowrank_kernel.single_launches,
            "flash_attention": flash_kernel.launches,
            "ssd_scan": ssd_kernel.launches}


class _Spans:
    """Per-call durations, read once after the run so the serving loop
    never waits on them: CUDA events on the card (the span the call's
    work takes on the stream), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def time(self, fn: Callable):
        if self.cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            t0.record()
            out = fn()
            t1.record()
        else:
            t0 = time.perf_counter()
            out = fn()
            t1 = time.perf_counter()
        self.marks.append((t0, t1))
        return out

    def seconds(self) -> list:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in self.marks]
        return [b - a for a, b in self.marks]


def serve(args: argparse.Namespace, params: Optional[dict] = None) -> dict:
    """Run the launcher for ``args``; ``params`` replaces the seeded
    initialization (parity tests start both packages from the same
    weights).  Returns what the run printed, as data: ``handles`` (in
    submission order), ``latencies_s``, ``readings``, ``adapt_steps``,
    ``observe_s`` and ``adapt_step_s`` (seconds per call, ``_Spans``), the
    final ``params``, the adapted ``leaf`` (its key in ``params``; None
    without an adapter), ``gradients`` (the feedback gradients computed:
    one per tick for telemetry and one per adaptation step), the
    ``engine`` and ``launches`` (of the
    single-block, attention and SSD kernels, over this run)."""
    fail = _parser().error
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the server runs on the card "
                           "unless asked for --device cpu")
    cfg = registry.get_reduced(args.arch) if args.reduced \
        else registry.get_config(args.arch)
    if not cfg.embed_inputs or cfg.num_codebooks:
        fail(f"serving supports token-input archs only; {args.arch!r} has "
             f"embed_inputs={cfg.embed_inputs} "
             f"num_codebooks={cfg.num_codebooks}")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = model_lib.init_params(cfg, gen, device=device)
    engine = Engine(cfg, params, ServeConfig(batch=args.batch,
                                             max_seq=args.max_seq,
                                             seed=args.seed))
    before = _launches()
    report = dict(engine=engine, params=params, handles=[], latencies_s=[],
                  readings=[], adapt_steps=0, observe_s=[], adapt_step_s=[],
                  leaf=None, gradients=0)
    observe_spans, adapt_spans = _Spans(device), _Spans(device)

    if args.traffic is None:
        # one-shot demo through the session API
        rng = np.random.default_rng(args.seed)
        handles = [engine.submit(Request(
            prompt=rng.integers(0, cfg.vocab_size, size=(8,),
                                dtype=np.int32),
            max_new_tokens=args.new_tokens)) for _ in range(args.batch)]
        engine.drain()
        for h in handles:
            print(f"request {h.id}: prompt={list(map(int, h.request.prompt))}"
                  f" -> {h.tokens}")
        report.update(handles=handles, launches=dict.fromkeys(before, 0))
        return report

    traffic = parse_kv_spec(args.traffic, TrafficConfig,
                            error=lambda m: fail(f"--traffic: {m}"))
    gen = LoadGenerator(traffic, cfg.vocab_size)

    adapter = monitor = None
    if args.adapt is not None:
        adapter = OnlineAdapter(cfg, params, parse_kv_spec(
            args.adapt, AdaptConfig, error=lambda m: fail(f"--adapt: {m}")))
    if args.monitor is not None:
        if adapter is None:
            adapter = OnlineAdapter(cfg, params)   # gradients for telemetry
        monitor = GradientMonitor(adapter.d, parse_kv_spec(
            args.monitor, MonitorConfig,
            error=lambda m: fail(f"--monitor: {m}")))

    feedback = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
        seed=args.seed + 1))

    handles, adapt_steps = [], 0
    for tick in range(traffic.ticks):
        for req in gen.arrivals(tick):
            handles.append(engine.submit(req))
        engine.step()
        if adapter is not None:
            batch = feedback.batch(tick)
            loss, g = adapter.grad(params, batch)
            if monitor is None:
                run_adapt = True              # no policy: adapt every tick
            else:
                reading = observe_spans.time(lambda: monitor.observe(g))
                run_adapt = reading is not None and reading.decision == ADAPT
            if run_adapt:
                params, loss = adapt_spans.time(
                    lambda: adapter.step(params, batch))
                engine.params = params        # serve the adapted weights
                adapt_steps += 1
    engine.drain()
    done = sorted(handles, key=lambda h: h.id)

    lat = [t1 - t0 for h in done for t0, t1 in
           zip(h.token_times, h.token_times[1:])]
    print(f"served {len(done)} requests, "
          f"{sum(len(h.tokens) for h in done)} tokens over "
          f"{engine.step_count} engine steps")
    if lat:
        print(f"inter-token latency p50={np.percentile(lat, 50)*1e3:.2f}ms "
              f"p99={np.percentile(lat, 99)*1e3:.2f}ms")
    if monitor is not None:
        for r in monitor.readings:
            print(r)
    if adapter is not None:
        print(f"adaptation steps: {adapt_steps} "
              f"(hyperparams: {adapter.hyperparams})")
    launches = {k: v - before[k] for k, v in _launches().items()}
    print("kernel launches: " + ", ".join(f"{k} {v}"
                                          for k, v in launches.items()))
    report.update(params=params, handles=done, latencies_s=lat,
                  leaf=adapter.leaf if adapter is not None else None,
                  gradients=(traffic.ticks + adapt_steps
                             if adapter is not None else 0),
                  readings=list(monitor.readings) if monitor else [],
                  adapt_steps=adapt_steps, launches=launches,
                  observe_s=observe_spans.seconds(),
                  adapt_step_s=adapt_spans.seconds())
    return report


def main(argv: Optional[list] = None) -> dict:
    """Command-line entry point; returns the run's report."""
    return serve(parse_args(argv))


if __name__ == "__main__":
    main()
