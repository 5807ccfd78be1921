"""Per-request lifecycle traces for the serving stack: the port's own
copy of ``paddle_tpu/observability/tracing.py``.

Every request the Server admits gets one :class:`RequestTrace`: a span
for its queue wait, one span per prefill dispatch (whole-prompt on the
dense engine, one per chunk on the paged engine), a decode-residency
span covering its time live in the slot pool, harvest instants, and
EXACTLY ONE terminal marker — ``terminal:completed`` or
``terminal:<RequestFailure reason>``.

Clock discipline: spans are stamped with ``time.perf_counter_ns()/1e3``
microseconds — the clock and unit of the profiler's ``RecordEvent``
host ring and of the native host tracer (both CLOCK_MONOTONIC) — so
:func:`export_chrome_trace` merges request spans, host spans and the
Server's tick markers into ONE chrome-trace JSON whose rows are aligned
in Perfetto.

Row layout in the exported trace: ``tid 0`` is the server row (tick
spans, retry/breaker instants); each request renders on its own thread
row named ``request <id>``.

Disabled (the default; arm with ``PT_TRACE_REQUESTS=1`` or
``ObservabilityConfig(trace_requests=True)``) every method returns on a
single bool check, and the Server leaves ``engine.tracer`` as None so
the engine hot paths pay one ``is None`` test.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.flags import env_bool

__all__ = ["RequestTracer", "RequestTrace", "export_chrome_trace",
           "now_us"]

_SERVER_TID = 0


def now_us() -> float:
    """Microseconds on the RecordEvent clock (perf_counter)."""
    return time.perf_counter_ns() / 1000.0


@dataclass
class RequestTrace:
    """One request's span list. ``spans`` hold completed ("X") spans
    and instants (dur None); ``open`` maps span name -> (begin ts,
    args) for spans still running; ``terminals`` records every terminal
    marker seen (the invariant is len == 1 once the request leaves the
    server)."""
    request_id: int
    t_start: float = 0.0
    spans: List[dict] = field(default_factory=list)
    open: Dict[str, tuple] = field(default_factory=dict)
    terminals: List[str] = field(default_factory=list)

    def span_names(self) -> List[str]:
        return [s["name"] for s in self.spans]


class RequestTracer:
    """Collects request traces + server-row events for one Server.

    Armed, retention is BOUNDED (a long-lived server must not grow
    without limit): the server row is a ``deque(maxlen=
    max_server_events)`` and, past ``max_requests`` retained traces,
    each terminal evicts the oldest already-terminated trace —
    still-open traces are never evicted, so an in-flight request
    always reaches its terminal span."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_requests: int = 4096,
                 max_server_events: int = 65536):
        self.enabled = env_bool("PT_TRACE_REQUESTS") \
            if enabled is None else bool(enabled)
        self.max_requests = max_requests
        self.traces: Dict[int, RequestTrace] = {}
        self._server_events: deque = deque(maxlen=max_server_events)
        self._lock = threading.Lock()

    # -- request lifecycle -------------------------------------------------
    def start(self, rid: int):
        """Request submitted: open its trace and its queue_wait span."""
        if not self.enabled:
            return
        t = now_us()
        with self._lock:
            self.traces[rid] = RequestTrace(request_id=rid, t_start=t)
        self.span_begin(rid, "queue_wait")

    def _trace(self, rid) -> Optional[RequestTrace]:
        return self.traces.get(rid)

    def span_begin(self, rid: int, name: str, **args):
        if not self.enabled:
            return
        tr = self._trace(rid)
        if tr is not None:
            tr.open[name] = (now_us(), args)

    def span_end(self, rid: int, name: str, **args):
        """Close an open span; silently a no-op when it never opened
        (e.g. a cancelled request that never reached decode)."""
        if not self.enabled:
            return
        tr = self._trace(rid)
        if tr is None or name not in tr.open:
            return
        t0, a0 = tr.open.pop(name)
        tr.spans.append({"name": name, "ts": t0,
                         "dur": now_us() - t0, "args": {**a0, **args}})

    def span_at(self, rid: int, name: str, ts_begin_us: float, **args):
        """Append a completed span measured by the caller (begin stamp
        taken with :func:`now_us` before a dispatch) — the engine-side
        form that costs nothing when the tracer is absent."""
        if not self.enabled:
            return
        tr = self._trace(rid)
        if tr is not None:
            tr.spans.append({"name": name, "ts": ts_begin_us,
                             "dur": now_us() - ts_begin_us, "args": args})

    def instant(self, rid: int, name: str, **args):
        if not self.enabled:
            return
        tr = self._trace(rid)
        if tr is not None:
            tr.spans.append({"name": name, "ts": now_us(), "dur": None,
                             "args": args})

    def terminal(self, rid: int, state: str, **args):
        """Record the request's terminal state and close every span
        still open at that moment. Deliberately NOT idempotent: a
        double terminal is recorded so the exactly-one test catches the
        server bug instead of masking it."""
        if not self.enabled:
            return
        tr = self._trace(rid)
        if tr is None:
            return
        t = now_us()
        for name, (t0, a0) in list(tr.open.items()):
            tr.spans.append({"name": name, "ts": t0, "dur": t - t0,
                             "args": a0})
        tr.open.clear()
        tr.terminals.append(state)
        tr.spans.append({"name": f"terminal:{state}", "ts": t,
                         "dur": None, "args": args})
        if len(self.traces) > self.max_requests:
            self._evict_terminated()

    def _evict_terminated(self):
        """Drop oldest TERMINATED traces until back under the cap
        (insertion order == submit order; open traces are skipped)."""
        with self._lock:
            excess = len(self.traces) - self.max_requests
            for rid in [r for r, tr in self.traces.items()
                        if tr.terminals][:excess]:
                del self.traces[rid]

    # -- server row --------------------------------------------------------
    def server_span_at(self, name: str, ts_begin_us: float, **args):
        if not self.enabled:
            return
        self._server_events.append(
            {"name": name, "ts": ts_begin_us,
             "dur": now_us() - ts_begin_us, "args": args})

    def server_instant(self, name: str, **args):
        if not self.enabled:
            return
        self._server_events.append({"name": name, "ts": now_us(),
                                    "dur": None, "args": args})

    # -- introspection -----------------------------------------------------
    def terminal_states(self) -> Dict[int, List[str]]:
        return {rid: list(tr.terminals)
                for rid, tr in self.traces.items()}

    def clear(self):
        with self._lock:
            self.traces.clear()
            self._server_events.clear()

    # -- chrome-trace export -----------------------------------------------
    def chrome_events(self, pid: Optional[int] = None) -> List[dict]:
        """The tracer's rows as chrome-trace events (metadata + X spans
        + instants), ready to merge with a RecordEvent drain."""
        pid = os.getpid() if pid is None else pid
        ev: List[dict] = [
            {"ph": "M", "name": "thread_name", "pid": pid,
             "tid": _SERVER_TID, "args": {"name": "server"}}]

        def emit(tid, rec):
            base = {"name": rec["name"], "pid": pid, "tid": tid,
                    "ts": rec["ts"], "args": rec["args"]}
            if rec["dur"] is None:
                ev.append({**base, "ph": "i", "s": "t"})
            else:
                ev.append({**base, "ph": "X", "dur": rec["dur"]})

        for rec in self._server_events:
            emit(_SERVER_TID, rec)
        for rid, tr in sorted(self.traces.items()):
            tid = rid + 1                 # tid 0 is the server row
            ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": f"request {rid}"}})
            for rec in tr.spans:
                emit(tid, rec)
            # still-open spans (export mid-stream): close at export time
            t = now_us()
            for name, (t0, a0) in tr.open.items():
                emit(tid, {"name": name, "ts": t0, "dur": t - t0,
                           "args": {**a0, "open_at_export": True}})
        return ev


def export_chrome_trace(path: str, tracer: Optional[RequestTracer] = None,
                        profiler=None, extra_events=()) -> str:
    """Write ONE Perfetto-loadable chrome-trace JSON merging request
    spans (``tracer``), the profiler's host-span ring (``profiler`` — a
    ``paddle_tpu_torch.profiler.Profiler``, drained destructively, exactly
    what its own export would have written), and any extra pre-built
    events. Parent directories are created. Returns ``path``."""
    events: List[dict] = []
    if tracer is not None:
        events.extend(tracer.chrome_events())
    if profiler is not None:
        events.extend(profiler._drain_events())
    events.extend(extra_events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path
