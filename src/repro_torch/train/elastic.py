"""Step-time anomaly detection (port of ``StragglerMonitor`` of
repro/train/elastic.py :128).  The rest of that module (elastic re-meshing,
the sketch merge of data-parallel shards) waits for distributed FD
(ROADMAP.md queue 1 item 12)."""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

_clock = time.perf_counter


class StragglerMonitor:
    """Robust per-step latency anomaly detector: a step is flagged when it
    takes longer than the median plus ``k`` scaled median absolute
    deviations of the last ``window`` steps (once 10 are known)."""

    def __init__(self, window: int = 50, k: float = 6.0):
        self.window = window
        self.k = k
        self.times: List[float] = []
        self.flagged = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = _clock()

    def stop(self) -> float:
        """Returns the step time; adds one to ``flagged`` when anomalous."""
        assert self._t0 is not None, "start() not called"
        dt = _clock() - self._t0
        self._t0 = None
        hist = self.times[-self.window:]
        if len(hist) >= 10:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if dt > med + self.k * 1.4826 * mad:
                self.flagged += 1
        self.times.append(dt)
        return dt

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0
