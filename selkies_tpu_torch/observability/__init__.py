"""Observability: Prometheus metrics + the frame flight recorder (the
port's copy of ``selkies_tpu/observability``).

Two surfaces (docs/observability.md):

* :class:`Metrics` — the Prometheus registry (parity with
  ``legacy/metrics.py`` gauges plus the tpuenc/robustness/edge series)
  and the observability HTTP endpoint: ``/metrics``, ``/healthz``,
  ``/debug/trace`` (Perfetto-loadable flight-recorder export), and the
  opt-in ``/debug/jax-trace`` profiler hook (a ``torch.profiler``
  capture on the port).
* :class:`FlightRecorder` / :class:`FrameTrace` — per-frame stage
  tracing from capture to CLIENT_FRAME_ACK (:data:`STAGES`), the
  measurement substrate behind ``glass_to_glass_ms`` /
  ``encode_only_ms``, the ``system_health`` stage breakdown, and
  tools/trace_report.py.

``FrameTracer``/``StageSpan`` are the pre-recorder stamp-based API,
kept as a compatibility shim.
"""

from .metrics import Metrics
from .tracing import (STAGES, FlightRecorder, FrameTrace, FrameTracer,
                      StageSpan)

__all__ = ["Metrics", "FlightRecorder", "FrameTrace", "STAGES",
           "FrameTracer", "StageSpan"]
