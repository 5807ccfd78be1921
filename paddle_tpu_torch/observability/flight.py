"""Crash flight recorder: a bounded ring of recent structured events.
The port's own copy of ``paddle_tpu/observability/flight.py``.

The serving loop records what a post-mortem needs — per-tick summaries,
step failures, retries, quarantines, load sheds, block-pool pressure,
breaker transitions — into a fixed-size ring
(``PT_FLIGHT_RECORDER_SIZE``, default 256 events). When the circuit
breaker opens the Server dumps it to a JSON file (atomic tmp+rename
through ``distributed.checkpoint``), and every ``Server.snapshot()``
both dumps it beside the snapshot and embeds the events in the
snapshot's metadata, so a restored server carries the pre-crash event
history.

Recording is O(1): one dict append into a ``deque(maxlen=N)`` per
event, at tick granularity. Capacity 0 disables recording entirely.
"""
from __future__ import annotations

import os
import tempfile
import time
from collections import deque
from typing import List, Optional

from ..utils.flags import env_int

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of ``{"seq", "t", "kind", ...fields}`` events."""

    def __init__(self, capacity: Optional[int] = None,
                 dump_dir: Optional[str] = None):
        if capacity is None:
            capacity = env_int("PT_FLIGHT_RECORDER_SIZE", 256)
        if capacity < 0:
            raise ValueError(
                f"flight recorder capacity {capacity}; must be >= 0 "
                "(0 disables)")
        self.capacity = capacity
        self.dump_dir = dump_dir
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0                  # total events ever recorded
        self.last_dump_path: Optional[str] = None

    def record(self, kind: str, **fields):
        if self.capacity == 0:
            return
        self._seq += 1
        self._ring.append({"seq": self._seq, "t": time.time(),
                           "kind": kind, **fields})

    def events(self) -> List[dict]:
        return list(self._ring)

    def recorded_total(self) -> int:
        """Events ever recorded (>= len(events()) once the ring wraps —
        the dump states how much history was lost)."""
        return self._seq

    # -- dumping -----------------------------------------------------------
    def _default_path(self, reason: str) -> str:
        d = self.dump_dir or tempfile.gettempdir()
        return os.path.join(
            d, f"pt-flight-{reason or 'dump'}-{os.getpid()}"
               f"-{self._seq}.json")

    def dump(self, path: Optional[str] = None, reason: str = "") -> str:
        """Write the ring as one JSON file (atomic tmp+rename; parent
        dirs created). Returns the path, also kept in
        ``last_dump_path``."""
        from ..distributed.checkpoint import atomic_json_dump
        if path is None:
            path = self._default_path(reason)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        atomic_json_dump(path, {
            "format": "pt-flight-recorder", "reason": reason,
            "dumped_at": time.time(), "capacity": self.capacity,
            "recorded_total": self._seq, "events": self.events()})
        self.last_dump_path = path
        return path

    # -- snapshot round-trip -----------------------------------------------
    def to_meta(self) -> dict:
        """JSON-safe state for a Server snapshot (the ring rides the
        snapshot's embedded metadata, not a separate file)."""
        return {"capacity": self.capacity, "seq": self._seq,
                "events": self.events()}

    def restore_meta(self, meta: dict):
        """Rehydrate from :meth:`to_meta` — restored events keep their
        original seq numbers; new events continue the sequence."""
        self._seq = int(meta.get("seq", 0))
        self._ring = deque((dict(e) for e in meta.get("events", [])),
                           maxlen=self.capacity)
