"""The port's serving path against repro/serve, repro/models/cache.py and
repro/launch/serve.py, on the reduced paper-lm-100m in f32 from the
reference's weights (``convert.params_from_numpy``).

(a) ``decode_step`` logits with per-lane positions, and ``reset_lanes``.
(b) Greedy tokens of the continuous-batching engine, with ragged prompts,
    per-request budgets and slot reuse (more requests than lanes), equal to
    the reference engine's, token for token; a greedy lane is unaffected by
    a sampling co-tenant; the engine's input checks.
(c) Load-generator arrivals, bit for bit.
(d) Monitor readings and decisions on the same gradient stream (steady,
    then a shift), and its spike pause.
(e) ``OnlineAdapter``: loss and head over 3 steps, and ``set_hyperparams``
    taking effect on the next step.  Each step takes a new feedback batch:
    a repeated batch gives a gradient nearly in the span of the sketch, an
    eigenvalue ~1e-5 of the others that f32 cancellation sets, and its
    s^-1/2 amplifies that rounding into the step, in the reference as in
    the port (ROADMAP.md queue 3).
(f) The reduced launcher end to end on the CPU against the reference's on
    the same weights: the one-shot demo's tokens, and a traffic run with the
    monitor and adaptation (served counts, readings, decisions, adaptation
    steps); for mamba2-370m and zamba2-7b also the traffic run's greedy
    tokens and the adapted tied ``embed``.

Tolerances: logits ``rtol=1e-4, atol=1e-5`` (f32, sums in another order);
readings' leading eigenvalue ``rtol=1e-4``, pressure ``1e-4`` absolute,
drift angle 1e-3 rad (``arccos`` near 0 or pi/2 amplifies rounding; see
tests/test_torch_fd.py); the adapted head as tests/test_torch_fd.py
(``rtol=1e-4`` plus 1e-5 of its largest magnitude), the loss ``rtol=1e-5``.
Greedy tokens are compared exactly: in f32 the reduced model's top-2
logit margins on these prompts are far above the logit tolerance.
"""
import contextlib
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close_scaled, torch_one_thread  # noqa: F401

from repro.configs import registry as jregistry
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import serve as jlaunch
from repro.models import cache as jcache
from repro.models import model as jmodel
from repro import serve as jserve
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tlaunch
from repro_torch.models import cache as tcache
from repro_torch import serve as tserve

ARCH = "paper-lm-100m"
MAX_SEQ = 24


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params): the same weights."""
    jcfg = jregistry.get_reduced(ARCH)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tregistry.get_reduced(ARCH)
    tparams = convert.params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jparams))
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,), dtype=np.int32) for n in lens]


def test_decode_step_per_lane_positions_and_reset(models):
    jcfg, jparams, tcfg, tparams = models
    B = 3
    jc = jcache.init_cache(jcfg, B, MAX_SEQ)
    tc = tcache.init_cache(tcfg, B, MAX_SEQ)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    rng = np.random.default_rng(1)
    offsets = np.array([0, 3, 1])
    step = jax.jit(lambda p, c, t, pos: jcache.decode_step(
        jcfg, p, c, {"token": t}, pos))
    for t in range(8):
        if t == 5:       # wipe lane 1 and restart it at position 0
            mask = np.array([False, True, False])
            jc = jcache.reset_lanes(jc, jnp.asarray(mask))
            tc = tcache.reset_lanes(tc, torch.from_numpy(mask))
            for k in tc:
                np.testing.assert_array_equal(tc[k][:, 1].numpy(), 0.0)
                np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                           rtol=1e-4, atol=1e-5)
            offsets[1] = -t
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = (t + offsets).astype(np.int32)
        jl, jc = step(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tcache.decode_step(tcfg, tparams, tc,
                                    {"token": torch.from_numpy(tok).long()},
                                    torch.from_numpy(pos).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-5)


def test_decode_step_shared_position_matches_per_lane(models):
    """A scalar position is the per-lane vector with one value."""
    _, _, tcfg, tparams = models
    tok = torch.tensor([[3], [7]])
    a = tcache.decode_step(tcfg, tparams, tcache.init_cache(tcfg, 2, 8),
                           {"token": tok}, 2)[0]
    b = tcache.decode_step(tcfg, tparams, tcache.init_cache(tcfg, 2, 8),
                           {"token": tok}, torch.tensor([2, 2]))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _serve_both(models, reqs, batch):
    jcfg, jparams, tcfg, tparams = models
    out = []
    for cfg, params, mod in ((jcfg, jparams, jserve), (tcfg, tparams, tserve)):
        eng = mod.Engine(cfg, params, mod.ServeConfig(batch=batch,
                                                      max_seq=MAX_SEQ))
        handles = [eng.submit(mod.Request(p, max_new_tokens=n))
                   for p, n in reqs]
        if batch < len(reqs):
            assert eng.active == batch and eng.pending == len(reqs) - batch
        eng.drain()
        assert all(h.done and len(h.tokens) == n
                   for h, (_, n) in zip(handles, reqs))
        out.append([h.tokens for h in handles])
    return out


@pytest.mark.parametrize("lens,news,batch", [
    ([5, 3, 6], [4, 6, 3], 3),                  # ragged, one lane each
    ([4, 6, 3, 5, 4], [3, 6, 4, 2, 5], 2)])     # slot reuse
def test_engine_greedy_tokens_match_jax(models, lens, news, batch):
    reqs = list(zip(_prompts(256, lens), news))
    want, got = _serve_both(models, reqs, batch)
    assert got == want


def test_engine_sampling_lane_leaves_greedy_lane_alone(models):
    _, _, tcfg, tparams = models
    pg, ph = _prompts(256, [5, 5], seed=1)
    eng = tserve.Engine(tcfg, tparams, tserve.ServeConfig(batch=2,
                                                          max_seq=MAX_SEQ,
                                                          seed=7))
    hg = eng.submit(tserve.Request(pg, max_new_tokens=3))
    hh = eng.submit(tserve.Request(ph, max_new_tokens=8, temperature=1.5))
    eng.drain()
    assert len(hg.tokens) == 3 and len(hh.tokens) == 8
    solo = tserve.Engine(tcfg, tparams, tserve.ServeConfig(batch=1,
                                                           max_seq=MAX_SEQ))
    assert solo.generate([tserve.Request(pg, max_new_tokens=3)])[0].tokens \
        == hg.tokens
    # the same seed draws the same samples
    again = tserve.Engine(tcfg, tparams, tserve.ServeConfig(
        batch=2, max_seq=MAX_SEQ, seed=7))
    again.submit(tserve.Request(pg, max_new_tokens=3))
    h2 = again.submit(tserve.Request(ph, max_new_tokens=8, temperature=1.5))
    again.drain()
    assert h2.tokens == hh.tokens


def test_engine_validation(models):
    _, _, tcfg, tparams = models
    eng = tserve.Engine(tcfg, tparams, tserve.ServeConfig(batch=2, max_seq=16))
    (p,) = _prompts(256, [10])
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(tserve.Request(p, max_new_tokens=12))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(tserve.Request(p, max_new_tokens=0))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(tserve.Request(np.zeros((0,), np.int32)))
    with pytest.raises(ValueError, match="lanes"):
        eng.generate([tserve.Request(p, max_new_tokens=2)] * 3)


@pytest.mark.parametrize("kw", [dict(shape="step", rate=1.0, ticks=12,
                                     step_at=6, step_mult=3.0, prompt_len=4,
                                     new_tokens=3),
                                dict(rate=2.5, ticks=9, seed=4)])
def test_loadgen_arrivals_bitwise_equal(kw):
    jg = jserve.LoadGenerator(jserve.TrafficConfig(**kw), 256)
    tg = tserve.LoadGenerator(tserve.TrafficConfig(**kw), 256)
    assert tg.total_expected() == jg.total_expected()
    for tick in range(kw["ticks"]):
        want, got = jg.arrivals(tick), tg.arrivals(tick)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.prompt.dtype == b.prompt.dtype
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert (a.max_new_tokens, a.temperature) == \
                (b.max_new_tokens, b.temperature)
    with pytest.raises(ValueError, match="shape"):
        tserve.TrafficConfig(shape="sawtooth")


def _lowrank_grads(rng, basis, n, scale=1.0):
    return [scale * (basis @ rng.standard_normal(basis.shape[1])
                     ).astype(np.float32) for _ in range(n)]


def _assert_readings_match(got, want):
    assert [r.decision for r in got] == [r.decision for r in want]
    for a, b in zip(got, want):
        assert a.window == b.window
        np.testing.assert_allclose(a.leading_eig, b.leading_eig, rtol=1e-4)
        np.testing.assert_allclose(a.pressure, b.pressure, atol=1e-4)
        np.testing.assert_allclose(a.drift_angle, b.drift_angle, atol=1e-3)


def test_monitor_readings_match_jax():
    """Steady low-rank traffic, then a full-rank shift (drift and pressure
    trip "adapt"), then a 100x energy spike ("pause")."""
    d, ell, window = 64, 8, 8
    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.standard_normal((d, 3)))[0]
    rot = np.linalg.qr(rng.standard_normal((d, d)))[0]
    stream = (_lowrank_grads(rng, basis, 3 * window)
              + _lowrank_grads(rng, rot, 2 * window)
              + _lowrank_grads(rng, basis, window, scale=100.0))
    kw = dict(ell=ell, window=window, top_k=3, pressure_threshold=0.2)
    jm = jserve.GradientMonitor(d, jserve.MonitorConfig(**kw))
    tm = tserve.GradientMonitor(d, tserve.MonitorConfig(**kw))
    for g in stream:
        jr, tr = jm.observe(g), tm.observe(torch.from_numpy(g))
        assert (jr is None) == (tr is None)
    _assert_readings_match(tm.readings, jm.readings)
    decisions = [r.decision for r in tm.readings]
    assert "adapt" in decisions and decisions[-1] == "pause"
    with pytest.raises(ValueError, match="dim"):
        tm.observe(np.zeros(d + 1, np.float32))
    with pytest.raises(ValueError, match="top_k"):
        tserve.MonitorConfig(ell=4, top_k=8)


def test_adapter_steps_and_hyperparams_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    data = JSyntheticLM(JDataConfig(vocab_size=256, seq_len=16,
                                    global_batch=4, seed=1))
    cfg_a = dict(lr=0.1, beta2=0.95, ell=8)
    ja = jserve.OnlineAdapter(jcfg, jparams, jserve.AdaptConfig(**cfg_a))
    ta = tserve.OnlineAdapter(tcfg, tparams, tserve.AdaptConfig(**cfg_a))
    assert ta.d == ja.d
    jl0, jg = ja.grad(jparams, data.batch(0))
    tl0, tg = ta.grad(tparams, data.batch(0))
    np.testing.assert_allclose(float(tl0), float(jl0), rtol=1e-5)
    assert_close_scaled(tg.numpy(), jg)
    jp, tp = jparams, tparams
    for step in range(4):
        if step == 3:        # lr 0 freezes the head on the next step
            ja.set_hyperparams(learning_rate=0.0)
            ta.set_hyperparams(learning_rate=0.0)
            frozen = tp["lm_head"].clone()
        batch = data.batch(step)
        jp, jl = ja.step(jp, batch)
        tp, tl = ta.step(tp, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert_close_scaled(tp["lm_head"].numpy(), jp["lm_head"])
    torch.testing.assert_close(tp["lm_head"], frozen, rtol=0, atol=0)
    assert tp["embed"] is tparams["embed"]
    assert not torch.equal(tp["lm_head"], tparams["lm_head"])
    assert ta.hyperparams == pytest.approx(ja.hyperparams)
    with pytest.raises(KeyError, match="unknown"):
        ta.set_hyperparams(nope=1.0)


def _jax_launcher(argv) -> str:
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(out):
            jlaunch.main()
    finally:
        sys.argv = old
    return out.getvalue()


_READING = re.compile(r"window (\d+): leading_eig=(\S+) pressure=(\S+) "
                      r"drift=(\S+)rad -> (\w+)")


def test_reduced_launcher_matches_jax(models):
    """The same weights through both launchers (the reference seeds its
    weights from ``--seed``; the port's come from them)."""
    _, _, tcfg, tparams = models
    demo = ["--batch", "3", "--new-tokens", "5"]
    want = _jax_launcher(demo)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.serve(tlaunch.parse_args(demo + ["--device", "cpu"]),
                      params=tparams)
    assert out.getvalue() == want

    argv = ["--traffic", "shape=step,rate=1.0,ticks=12,step_at=6,"
            "prompt_len=4,new_tokens=3", "--monitor", "window=3,ell=8,top_k=3",
            "--adapt", "lr=0.1,beta2=0.95"]
    want = _jax_launcher(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = tlaunch.serve(tlaunch.parse_args(argv + ["--device", "cpu"]),
                               params=tparams)
    got = out.getvalue()
    first = lambda text: text.splitlines()[0]
    assert first(got) == first(want)                # served ... tokens
    adapt_line = [ln for ln in want.splitlines() if ln.startswith("adapt")]
    assert [ln for ln in got.splitlines() if ln.startswith("adapt")] == \
        adapt_line
    parse = lambda text: [(int(w), float(e), float(p), float(a), dec)
                          for w, e, p, a, dec in _READING.findall(text)]
    jr, tr = parse(want), parse(got)
    assert len(tr) == 4 and [r[4] for r in tr] == [r[4] for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a[1:4], b[1:4], rtol=2e-3, atol=2e-2)
    assert report["adapt_steps"] == int(adapt_line[0].split()[2])
    assert report["leaf"] == "lm_head"
    assert report["launches"] == {"gram": 0, "lowrank_apply": 0,
                                  "flash_attention": 0, "ssd_scan": 0}
    assert ("kernel launches: gram 0, lowrank_apply 0, flash_attention 0, "
            "ssd_scan 0") in got


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_reduced_launcher_matches_jax_for_ssm_and_hybrid(arch, monkeypatch):
    """The ssm and hybrid families through both launchers from the same
    weights: the one-shot demo's output, and a traffic run's served
    counts, greedy tokens, monitor decisions, adaptation steps and adapted
    tied ``embed`` (the reference's engine is recorded to read them)."""
    jparams = jmodel.init_params(jregistry.get_reduced(arch),
                                 jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(tregistry.get_reduced(arch),
                                        jax.tree.map(np.asarray, jparams))
    demo = ["--arch", arch, "--batch", "2", "--new-tokens", "4"]
    want = _jax_launcher(demo)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tlaunch.serve(tlaunch.parse_args(demo + ["--device", "cpu"]),
                      params=tparams)
    assert out.getvalue() == want

    engines, handles = [], []

    class Recording(jserve.Engine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

        def submit(self, request):
            handles.append(super().submit(request))
            return handles[-1]

    monkeypatch.setattr(jserve, "Engine", Recording)
    argv = ["--arch", arch, "--traffic", "shape=step,rate=1.0,ticks=8,"
            "step_at=4,prompt_len=4,new_tokens=3", "--monitor",
            "window=2,ell=8,top_k=3", "--adapt", "lr=0.1,beta2=0.95"]
    want = _jax_launcher(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report = tlaunch.serve(tlaunch.parse_args(argv + ["--device", "cpu"]),
                               params=tparams)
    got = out.getvalue()
    first = lambda text: text.splitlines()[0]
    assert first(got) == first(want)                # served ... tokens
    assert [h.tokens for h in report["handles"]] == \
        [h.tokens for h in sorted(handles, key=lambda h: h.id)]
    decisions = lambda text: [r[4] for r in _READING.findall(text)]
    assert len(decisions(got)) == 4 and decisions(got) == decisions(want)
    adapt_line = [ln for ln in want.splitlines() if ln.startswith("adapt")]
    assert [ln for ln in got.splitlines() if ln.startswith("adapt")] == \
        adapt_line
    assert report["adapt_steps"] >= 1 and report["leaf"] == "embed"
    assert_close_scaled(report["params"]["embed"].numpy(),
                        engines[0].params["embed"])


def test_launcher_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--batch", "1", "--new-tokens", "1"])
