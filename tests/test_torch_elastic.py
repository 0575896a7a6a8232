"""The port's ``StragglerMonitor`` (repro_torch/train/elastic.py) against
the reference's (repro/train/elastic.py :128) on the same step-time
sequences.  Both monitors read a fake clock that advances by each step's
time between ``start`` and ``stop``, so the test does not depend on how
busy the host is (the reference's own test times real sleeps of a few
milliseconds).  They must flag the same steps, return the same times and
report the same median: the arithmetic is the same, so exactly.
"""
import types

import numpy as np
import pytest

from repro.train import elastic as jelastic
from repro_torch.train import elastic as telastic


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self) -> float:
        return self.now


def _sequences() -> dict:
    rng = np.random.default_rng(0)
    base = 0.010 + 1e-4 * (np.arange(40) % 3)
    spiky = base.copy()
    spiky[[12, 25, 26, 39]] = [0.5, 0.05, 0.0101, 0.2]
    return {
        "uniform": list(base),
        "spiky": list(spiky),
        "noisy": list(0.02 + 0.002 * rng.standard_normal(80)),
        "drift": list(np.linspace(0.01, 0.03, 60)),
        "heavy_tail": list(0.01 * (1 + rng.pareto(3.0, 120))),
        "short": [0.01] * 9 + [1.0],
    }


@pytest.mark.parametrize("window,k", [(50, 6.0), (20, 3.0), (10, 1.0)])
@pytest.mark.parametrize("name", list(_sequences()))
def test_straggler_monitor_matches_reference(monkeypatch, name, window, k):
    clock = _Clock()
    monkeypatch.setattr(telastic, "_clock", clock)
    monkeypatch.setattr(jelastic, "time",
                        types.SimpleNamespace(perf_counter=clock))
    got = telastic.StragglerMonitor(window=window, k=k)
    want = jelastic.StragglerMonitor(window=window, k=k)
    flagged = []
    for dt in _sequences()[name]:
        got.start()
        want.start()
        clock.now += dt
        assert got.stop() == want.stop()
        assert got.flagged == want.flagged
        flagged.append(got.flagged)
    assert got.times == want.times
    assert got.flagged == want.flagged
    assert got.median == want.median
    if name == "spiky" and k == 6.0:
        # the 0.5 s, 50 ms and 0.2 s steps, not the normal step after 50 ms
        assert np.flatnonzero(np.diff([0] + flagged)).tolist() == \
            [12, 25, 39]
    if name == "uniform":
        assert got.flagged == 0


def test_straggler_monitor_needs_start():
    with pytest.raises(AssertionError):
        telastic.StragglerMonitor().stop()
    assert telastic.StragglerMonitor().median == 0.0
