"""Serving: continuous-batching engine, FD telemetry and online adaptation
(port of repro/serve).

  engine.py   session-style Engine (submit/step/drain, slot reuse)
  monitor.py  FD-sketch gradient monitor (drift/pressure/spike policy)
  adapt.py    S-AdaGrad online adaptation of the head from feedback
  loadgen.py  deterministic constant/step traffic generator
"""
from repro_torch.serve.adapt import AdaptConfig, OnlineAdapter
from repro_torch.serve.engine import (Engine, Request, RequestHandle, Result,
                                      ServeConfig)
from repro_torch.serve.loadgen import LoadGenerator, TrafficConfig
from repro_torch.serve.monitor import (ADAPT, PAUSE, STEADY, GradientMonitor,
                                       MonitorConfig, MonitorReading)

__all__ = [
    "AdaptConfig", "OnlineAdapter",
    "Engine", "Request", "RequestHandle", "Result", "ServeConfig",
    "LoadGenerator", "TrafficConfig",
    "GradientMonitor", "MonitorConfig", "MonitorReading",
    "STEADY", "ADAPT", "PAUSE",
]
