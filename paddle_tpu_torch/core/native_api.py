"""ctypes façade over the port's native host tracer
(``csrc/host_tracer.cc``), with a pure-Python path: the port's own copy
of ``NativeTracer`` and ``global_tracer`` of
``paddle_tpu/core/native_api.py`` (its ``ShmQueue`` is in
``core/__init__.py``; its ``TCPStore`` comes with ``ROADMAP.md`` A.6).

``NativeTracer`` mirrors the host-tracer half of the reference's
profiler: spans go into per-thread native buffers when the library
builds and loads, else into an in-process Python list; either way
:meth:`NativeTracer.dump` writes the same chrome-trace event
structure."""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from . import load_host_tracer

__all__ = ["NativeTracer", "global_tracer"]


class NativeTracer:
    """Host span tracer. Native per-thread buffers when the
    ``host_tracer`` library builds and loads (``is_native``), otherwise
    an in-process Python list. Thread-safe."""

    def __init__(self):
        self._lib = load_host_tracer()
        self._py_events = []
        self._py_lock = threading.Lock()
        self._enabled = False

    @property
    def is_native(self):
        return self._lib is not None

    def enable(self, on: bool = True):
        self._enabled = on
        if self._lib is not None:
            self._lib.pt_trace_enable(1 if on else 0)

    def begin(self, name: str):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_begin(name.encode())
        else:
            with self._py_lock:
                self._py_events.append(("B", name, time.perf_counter_ns()))

    def end(self):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_end()
        else:
            with self._py_lock:
                self._py_events.append(("E", None, time.perf_counter_ns()))

    def instant(self, name: str):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_instant(name.encode())
        else:
            with self._py_lock:
                self._py_events.append(("i", name, time.perf_counter_ns()))

    def counter(self, name: str, value: int):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_counter(name.encode(), int(value))
        else:
            with self._py_lock:
                self._py_events.append(
                    ("C", name, time.perf_counter_ns(), int(value)))

    def event_count(self) -> int:
        if self._lib is not None:
            return int(self._lib.pt_trace_event_count())
        with self._py_lock:
            return len(self._py_events)

    def clear(self):
        if self._lib is not None:
            self._lib.pt_trace_clear()
        with self._py_lock:
            self._py_events.clear()

    def dump(self, path: str, pid: int = 0):
        """Write chrome://tracing JSON."""
        if self._lib is not None:
            rc = self._lib.pt_trace_dump(path.encode(), pid)
            if rc != 0:
                raise OSError(f"trace dump to {path!r} failed")
            return
        events, stack = [], []
        with self._py_lock:
            for ev in self._py_events:
                if ev[0] == "B":
                    stack.append(ev)
                elif ev[0] == "E" and stack:
                    _, name, t0 = stack.pop()
                    events.append({"ph": "X", "name": name,
                                   "ts": t0 / 1e3,
                                   "dur": (ev[2] - t0) / 1e3,
                                   "pid": pid, "tid": 0})
                elif ev[0] == "i":
                    events.append({"ph": "i", "name": ev[1],
                                   "ts": ev[2] / 1e3, "pid": pid,
                                   "tid": 0, "s": "t"})
                elif ev[0] == "C":
                    events.append({"ph": "C", "name": ev[1],
                                   "ts": ev[2] / 1e3, "pid": pid,
                                   "args": {"value": ev[3]}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


_global_tracer: Optional[NativeTracer] = None


def global_tracer() -> NativeTracer:
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = NativeTracer()
    return _global_tracer
