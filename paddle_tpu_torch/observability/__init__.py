"""Serving-grade observability: metrics registry, request tracing,
crash flight recorder. The port's own copy of
``paddle_tpu/observability`` (it imports no JAX there either).

Three independent planes, all host-side, all default-off or O(1):

- :mod:`.metrics` — process-global Counter/Gauge/Histogram registry
  with labels; a no-op when disabled (``PT_METRICS=1`` /
  ``metrics.enable()``); JSON (``dump()``) and Prometheus-text
  (``render_prometheus()``) exposition.
- :mod:`.tracing` — per-request lifecycle traces
  (``PT_TRACE_REQUESTS=1``): queue wait, prefill (chunk) spans, decode
  residency, harvest, retries, exactly one terminal state per request;
  exported as chrome-trace JSON on the same clock as the profiler's
  ``RecordEvent`` ring.
- :mod:`.flight` — a bounded ring of recent structured events
  (``PT_FLIGHT_RECORDER_SIZE``) that dumps on circuit-open, dumps and
  rides along with ``Server.snapshot()``, and restores with it.

``ObservabilityConfig`` is the per-Server knob bundle; None fields
defer to the env.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import metrics                      # noqa: F401
from .flight import FlightRecorder         # noqa: F401
from .tracing import (RequestTrace, RequestTracer,  # noqa: F401
                      export_chrome_trace)

__all__ = ["metrics", "FlightRecorder", "RequestTracer", "RequestTrace",
           "export_chrome_trace", "ObservabilityConfig"]


@dataclass
class ObservabilityConfig:
    """Per-Server observability knobs. ``None`` = read the env knob
    (``PT_TRACE_REQUESTS``, ``PT_FLIGHT_RECORDER_SIZE``); the global
    metrics switch lives on :mod:`.metrics` (``PT_METRICS`` /
    ``metrics.enable()``) because the registry is process-wide."""
    trace_requests: Optional[bool] = None
    flight_size: Optional[int] = None
    flight_dump_dir: Optional[str] = None
