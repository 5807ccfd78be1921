"""Profiler: the parts of ``paddle_tpu/profiler/__init__.py`` the serving
stack uses — ``RecordEvent`` host spans (through the native host tracer
of ``core.native_api`` when it builds, else a Python ring), ``Profiler``
with its scheduler gating, export and summary, ``ProfilerTarget``,
``ProfilerState``, ``make_scheduler`` and ``export_chrome_tracing``.
``SummaryView`` and ``load_profiler_result`` come with ``ROADMAP.md``
A.10.

Device tracing goes through ``torch.profiler`` (CUPTI on the card)
where the JAX package's goes through ``jax.profiler``: a profiler whose
targets name a device records the device trace beside the host spans
and writes it as ``device_trace.json`` into ``device_trace_dir`` when it
stops. Host spans share the device trace's clock: both read
CLOCK_MONOTONIC."""
from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum
from typing import Callable, Iterable, Optional

__all__ = ["Profiler", "ProfilerTarget", "ProfilerState", "RecordEvent",
           "make_scheduler", "export_chrome_tracing"]


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1      # the card's tracer (torch.profiler, CUPTI)
    TPU = 2      # parity alias: maps to the same device tracer
    CUSTOM_DEVICE = 3


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


_EVENTS: list = []
_EVENTS_LOCK = threading.Lock()
_ACTIVE = [False]


def _tracer():
    """The native host tracer (``core.native_api``); None when its
    library is unavailable — spans then use the Python ring."""
    from ..core.native_api import global_tracer
    t = global_tracer()
    return t if t.is_native else None


class RecordEvent:
    """Host span. Usable as a context manager or begin()/end()."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._begin = None

    def begin(self):
        t = _tracer()
        if t is not None:
            t.begin(self.name)
            self._begin = "native"
            return
        self._begin = time.perf_counter_ns()

    def end(self):
        if self._begin == "native":
            t = _tracer()
            if t is not None:
                t.end()
            return
        if self._begin is None or not _ACTIVE[0]:
            return
        now = time.perf_counter_ns()
        with _EVENTS_LOCK:
            _EVENTS.append({"name": self.name, "ph": "X", "pid": os.getpid(),
                            "tid": threading.get_ident(),
                            "ts": self._begin / 1000.0,
                            "dur": (now - self._begin) / 1000.0})

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(closed: int = 0, ready: int = 0, record: int = 1,
                   repeat: int = 0, skip_first: int = 0):
    total = closed + ready + record

    def scheduler(step: int):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}.json")
        with open(path, "w") as f:
            json.dump({"traceEvents": prof._drain_events()}, f)
        prof._last_export = path
    return handler


class Profiler:
    """Host spans (``RecordEvent``) and, when ``targets`` name a device,
    the ``torch.profiler`` device trace, gated by ``scheduler``
    (a ``make_scheduler`` callable or a ``(start, end)`` step pair)."""

    def __init__(self, targets: Optional[Iterable] = None, scheduler=None,
                 on_trace_ready: Optional[Callable] = None,
                 record_shapes=False, profile_memory=False, timer_only=False,
                 emit_nvtx=False, custom_device_types=None, with_flops=False):
        self.targets = list(targets or [ProfilerTarget.CPU,
                                        ProfilerTarget.GPU])
        if isinstance(scheduler, tuple):
            start, end = scheduler
            scheduler = make_scheduler(closed=start, ready=0,
                                       record=end - start, repeat=1)
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self._step = 0
        self._state = ProfilerState.CLOSED
        self.device_trace_dir = None
        self._device_prof = None
        self._last_export = None

    # -- device tracer ------------------------------------------------------
    def _start_device_trace(self):
        if self.timer_only or self._device_prof is not None:
            return
        if not any(t in (ProfilerTarget.GPU, ProfilerTarget.TPU)
                   for t in self.targets):
            return
        import tempfile
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.device_trace_dir = tempfile.mkdtemp(prefix="pdtorch_prof_")
        self._device_prof = profile(activities=acts)
        self._device_prof.start()

    def _stop_device_trace(self):
        if self._device_prof is None:
            return
        prof, self._device_prof = self._device_prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self.device_trace_dir,
                                              "device_trace.json"))

    def _drain_events(self):
        with _EVENTS_LOCK:
            ev = list(_EVENTS)
            _EVENTS.clear()
        t = _tracer()
        if t is not None and t.event_count():
            import tempfile
            with tempfile.NamedTemporaryFile(suffix=".json",
                                             delete=False) as f:
                tmp = f.name
            try:
                t.dump(tmp, pid=os.getpid())
                with open(tmp) as f:
                    ev.extend(json.load(f).get("traceEvents", []))
                t.clear()
            finally:
                os.unlink(tmp)
        return ev

    # -- lifecycle ----------------------------------------------------------
    @staticmethod
    def _recording(state) -> bool:
        return state in (ProfilerState.RECORD,
                         ProfilerState.RECORD_AND_RETURN)

    def _arm_host_ring(self, on: bool):
        """The host-span ring (and the native tracer) record iff the
        scheduler state says so: nothing through CLOSED warm-up steps,
        and a CLOSED→RECORD transition in :meth:`step` re-arms it."""
        _ACTIVE[0] = on
        t = _tracer()
        if t is not None:
            t.enable(on)

    def start(self):
        self._state = self.scheduler(self._step) if self.scheduler else \
            ProfilerState.RECORD
        self._arm_host_ring(self._recording(self._state))
        if self._recording(self._state):
            self._start_device_trace()

    def stop(self):
        self._stop_device_trace()
        self._arm_host_ring(False)
        if self.on_trace_ready:
            self.on_trace_ready(self)

    def step(self, num_samples=None):
        self._step += 1
        if self.scheduler:
            new_state = self.scheduler(self._step)
            self._arm_host_ring(self._recording(new_state))
            if self._recording(new_state):
                self._start_device_trace()
            elif new_state == ProfilerState.CLOSED:
                self._stop_device_trace()
            if self._state == ProfilerState.RECORD_AND_RETURN and \
                    self.on_trace_ready:
                self.on_trace_ready(self)
            self._state = new_state

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path, format="json"):
        """Write the drained host spans as chrome-trace JSON (parent
        directories created)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self._drain_events()}, f)
        self._last_export = path

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None, print_table=True):
        """Aggregate the drained host spans. Returns ``(table, agg)``
        — the rendered table plus the per-name ``{"calls", "total_us"}``
        dict — and prints only when ``print_table``."""
        ev = self._drain_events()
        agg: dict = {}
        for e in ev:
            if e.get("ph") != "X":
                continue
            a = agg.setdefault(e["name"], {"calls": 0, "total_us": 0.0})
            a["calls"] += 1
            a["total_us"] += e.get("dur", 0.0)
        lines = [f"{'Name':<40}{'Calls':>8}{'Total(ms)':>12}{'Avg(ms)':>12}"]
        for name, a in sorted(agg.items(), key=lambda kv: -kv[1]["total_us"]):
            lines.append(f"{name:<40}{a['calls']:>8}"
                         f"{a['total_us'] / 1000:>12.3f}"
                         f"{a['total_us'] / 1000 / a['calls']:>12.3f}")
        table = "\n".join(lines)
        if print_table:
            print(table)
        return table, agg
