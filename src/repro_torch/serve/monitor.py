"""FD-sketch gradient monitor: drift and health telemetry of serve-time
feedback (port of repro/serve/monitor.py).

Per window of ``window`` feedback gradients the monitor keeps a fresh
rank-``ell`` Frequent Directions sketch (``core/fd.fd_update``) and, at the
window's close, reads three signals off it:

  * ``leading_eig``: top eigenvalue of the compensated window sketch
    (``fd_leading_eigval``), the gradient energy; a sudden spike means
    suspected bad traffic, not honest drift.
  * ``pressure``: escaped-mass ratio ``rho/(trace+rho)`` (``fd_pressure``),
    how much of the window's gradient mass escapes the rank-``ell``
    subspace.
  * ``drift_angle``: largest principal angle between this window's and the
    previous window's leading subspaces (``fd_subspace_angle``), the
    signature of a distribution shift.

A threshold policy turns the signals into a decision per window: "steady",
"adapt" (run serve/adapt.py) or "pause" (hold adaptation until a spike
passes).

The sketch lives on the device of the gradients it observes.  There,
``observe`` is one single-block ``fd_update``: on the card its Gram is the
split-d kernel of csrc/gram_tall.cu (at the full-width head, a (25,165,824,
9) factor per gradient).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.core.fd import (fd_init, fd_leading_eigval, fd_pressure,
                                 fd_subspace_angle, fd_update)

# window-boundary decisions, in escalation order
STEADY, ADAPT, PAUSE = "steady", "adapt", "pause"


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    ell: int = 8                  # sketch rank per window
    window: int = 8               # feedback gradients per window
    top_k: int = 4                # subspace columns compared for drift
    drift_threshold: float = 0.8      # radians; pi/2 = fully rotated
    pressure_threshold: float = 0.35  # rho/(trace+rho)
    spike_factor: float = 25.0    # leading-eig jump vs EMA => pause
    eig_ema: float = 0.7          # EMA decay for the leading-eig trajectory
    warmup_windows: int = 1       # windows before decisions are issued

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if not (1 <= self.top_k <= self.ell):
            raise ValueError(f"need 1 <= top_k <= ell, got "
                             f"top_k={self.top_k} ell={self.ell}")


@dataclasses.dataclass
class MonitorReading:
    """One window-boundary observation (the monitor's public record)."""
    window: int           # 0-based window index
    leading_eig: float
    pressure: float
    drift_angle: float    # radians vs the previous window's subspace
    decision: str         # steady | adapt | pause

    def __str__(self):
        return (f"window {self.window}: leading_eig={self.leading_eig:.3e} "
                f"pressure={self.pressure:.3f} "
                f"drift={self.drift_angle:.2f}rad -> {self.decision}")


class GradientMonitor:
    """Feed flattened feedback gradients; get a MonitorReading per window.

    Signals and the threshold policy run on the host at window boundaries
    only."""

    def __init__(self, d: int, cfg: MonitorConfig = MonitorConfig()):
        self.d = d
        self.cfg = cfg
        self._sketch = None           # made on the first gradient's device
        self._prev_vecs = None        # previous window's eigvecs
        self._count = 0               # gradients in the open window
        self._windows = 0
        self._eig_ema: Optional[float] = None
        self.readings: List[MonitorReading] = []

    @property
    def last_reading(self) -> Optional[MonitorReading]:
        return self.readings[-1] if self.readings else None

    @property
    def leading_eig_trajectory(self) -> List[float]:
        return [r.leading_eig for r in self.readings]

    def observe(self, g) -> Optional[MonitorReading]:
        """Fold one flattened feedback gradient (a tensor, or an array,
        which goes to the CPU) into the window sketch.  Returns a
        MonitorReading when this gradient closes a window."""
        g = torch.as_tensor(g, dtype=torch.float32).reshape(-1)
        if g.shape[0] != self.d:
            raise ValueError(f"gradient dim {g.shape[0]} != monitor d "
                             f"{self.d}")
        if self._sketch is None:
            self._sketch = fd_init(self.d, self.cfg.ell, device=g.device)
        self._sketch = fd_update(self._sketch, g[:, None], beta2=1.0)
        self._count += 1
        if self._count >= self.cfg.window:
            return self._close_window()
        return None

    def _close_window(self) -> MonitorReading:
        cfg = self.cfg
        leading = float(fd_leading_eigval(self._sketch))
        pressure = float(fd_pressure(self._sketch))
        drift = 0.0
        if self._prev_vecs is not None:
            drift = float(fd_subspace_angle(
                self._prev_vecs, self._sketch.eigvecs, k=cfg.top_k))

        if self._windows < cfg.warmup_windows or self._prev_vecs is None:
            decision = STEADY
        elif self._eig_ema is not None and \
                leading > cfg.spike_factor * max(self._eig_ema, 1e-30):
            decision = PAUSE
        elif drift > cfg.drift_threshold or \
                pressure > cfg.pressure_threshold:
            decision = ADAPT
        else:
            decision = STEADY

        reading = MonitorReading(window=self._windows, leading_eig=leading,
                                 pressure=pressure, drift_angle=drift,
                                 decision=decision)
        self.readings.append(reading)

        # the trajectory EMA feeds the spike detector; a paused window is
        # kept out of it, so a burst of bad traffic cannot normalize itself
        if decision != PAUSE:
            self._eig_ema = leading if self._eig_ema is None else \
                cfg.eig_ema * self._eig_ema + (1.0 - cfg.eig_ema) * leading
            self._prev_vecs = self._sketch.eigvecs
        self._sketch = fd_init(self.d, cfg.ell,
                               device=self._sketch.eigvecs.device)
        self._count = 0
        self._windows += 1
        return reading
