"""Process-global metrics registry: Counter / Gauge / Histogram with
labels, JSON and Prometheus-text exposition. The port's own copy of
``paddle_tpu/observability/metrics.py``: the same classes, the same
exposition bytes, and the same family names, help strings and labels
for every module the port has.

Every instrumented module registers its families at import (so
``dump()`` always shows the full catalog, zero-valued when idle) and
updates them from its host-side paths: the Server tick loop, engine
harvest, BlockManager accounting, fault fires. Nothing here ever runs
inside a captured CUDA graph: metrics are host counters around device
dispatches.

Enablement (``PT_METRICS=1`` or :func:`enable`): every update method's
first line reads one module-level bool and returns when disabled — no
lock, no dict lookup, no label-key allocation. Enabled, updates mutate
plain Python floats under the GIL; the registry lock guards only
family/sample creation.

Exposition: :func:`dump` (one JSON-able dict ``{family: {kind, help,
label_names, samples}}``) and :func:`render_prometheus` (the
Prometheus text format, histogram buckets cumulative with ``+Inf``).
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.flags import env_bool

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "dump", "render_prometheus",
           "enable", "enabled", "reset"]

# module-level enable bool: the disabled fast path reads ONLY this
# (list, not bare bool, so `from .metrics import ...` users and the
# module itself share one cell)
_ENABLED = [env_bool("PT_METRICS", False)]


def enabled() -> bool:
    return _ENABLED[0]


def enable(on: bool = True):
    """Flip metric recording globally (env default: ``PT_METRICS``)."""
    _ENABLED[0] = bool(on)


# default histogram bounds: latency-shaped, seconds
_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Metric:
    """Base: one metric family (name + help + label names) holding one
    sample per observed label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help_: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names: Tuple[str, ...] = tuple(labels)
        self._samples: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> Tuple[str, ...]:
        if len(labels) != len(self.label_names):
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got "
                f"{tuple(labels)}")
        try:
            return tuple(str(labels[n]) for n in self.label_names)
        except KeyError as e:
            raise ValueError(
                f"{self.name} takes labels {self.label_names}, got "
                f"{tuple(labels)}") from e

    def _sample(self, labels: dict, zero):
        key = self._key(labels)
        s = self._samples.get(key)
        if s is None:
            with self._lock:
                s = self._samples.setdefault(key, zero())
        return s

    def clear(self):
        with self._lock:
            self._samples.clear()

    # -- exposition --------------------------------------------------------
    def _value_of(self, sample):
        return sample[0]

    def samples(self) -> List[dict]:
        out = []
        for key, s in sorted(self._samples.items()):
            out.append({"labels": dict(zip(self.label_names, key)),
                        "value": self._value_of(s)})
        return out


class Counter(_Metric):
    """Monotone counter. ``inc(amount, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if not _ENABLED[0]:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc")
        self._sample(labels, lambda: [0.0])[0] += amount

    def value(self, **labels) -> float:
        s = self._samples.get(self._key(labels))
        return s[0] if s is not None else 0.0


class Gauge(_Metric):
    """Last-write-wins instantaneous value. ``set(v)`` / ``inc(d)``."""

    kind = "gauge"

    def set(self, value: float, **labels):
        if not _ENABLED[0]:
            return
        self._sample(labels, lambda: [0.0])[0] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        if not _ENABLED[0]:
            return
        self._sample(labels, lambda: [0.0])[0] += amount

    def value(self, **labels) -> float:
        s = self._samples.get(self._key(labels))
        return s[0] if s is not None else 0.0


class Histogram(_Metric):
    """Bucketed distribution: ``observe(v)`` lands in the first bucket
    with upper bound >= v (raw per-bucket counts stored; exposition
    renders them cumulative with ``+Inf``, the Prometheus convention).

    Alongside the cumulative buckets each sample keeps a bounded ring
    of the most recent raw observations (``recent_cap``, default 512)
    so a controller can read a ROLLING-window percentile — the
    cumulative-since-start buckets can never "clear" after a long
    breach, which is exactly wrong for a control loop. The ring only
    exists on the enabled path (one deque append per observe); the
    disabled fast path is untouched."""

    kind = "histogram"

    def __init__(self, name, help_="", labels=(),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 recent_cap: int = 512):
        super().__init__(name, help_, labels)
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self.recent_cap = int(recent_cap)
        self._recent: Dict[Tuple[str, ...], deque] = {}

    def _zero(self):
        # [count, sum, per-bucket counts..., overflow]
        return [0, 0.0] + [0] * (len(self.bounds) + 1)

    def observe(self, value: float, **labels):
        if not _ENABLED[0]:
            return
        s = self._sample(labels, self._zero)
        s[0] += 1
        s[1] += value
        s[2 + bisect.bisect_left(self.bounds, value)] += 1
        key = self._key(labels)
        ring = self._recent.get(key)
        if ring is None:
            with self._lock:
                ring = self._recent.setdefault(
                    key, deque(maxlen=self.recent_cap))
        ring.append(value)

    def count(self, **labels) -> int:
        s = self._samples.get(self._key(labels))
        return s[0] if s is not None else 0

    def recent_quantile(self, q: float, window: Optional[int] = None,
                        **labels) -> Optional[float]:
        """Nearest-rank quantile ``q`` over the last ``window`` raw
        observations (default: everything the ring retains, at most
        ``recent_cap``). None when no samples exist — a controller
        must treat "no data" differently from "0.0 seconds"."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        ring = self._recent.get(self._key(labels))
        if not ring:
            return None
        vals = list(ring)
        if window is not None:
            if window < 1:
                raise ValueError(f"window {window}; must be >= 1")
            vals = vals[-window:]
        vals.sort()
        idx = min(len(vals) - 1,
                  max(0, math.ceil(q * len(vals)) - 1))
        return vals[idx]

    def recent_count(self, **labels) -> int:
        """Raw observations currently retained in the ring."""
        ring = self._recent.get(self._key(labels))
        return len(ring) if ring else 0

    def clear(self):
        super().clear()
        with self._lock:
            self._recent.clear()

    def _value_of(self, sample):
        cum, cum_counts = 0, []
        for c in sample[2:]:
            cum += c
            cum_counts.append(cum)
        return {"count": sample[0], "sum": sample[1],
                "buckets": dict(zip([str(b) for b in self.bounds]
                                    + ["+Inf"], cum_counts))}


class Registry:
    """Name -> metric family. ``counter/gauge/histogram`` get-or-create
    and hard-fail on a kind or label-schema mismatch — two subsystems
    silently sharing one name with different meanings is a bug."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help_, labels, **kw):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, help_, labels, **kw)
                    self._metrics[name] = m
        if not isinstance(m, cls) or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.label_names}; asked for {cls.kind} with "
                f"{tuple(labels)}")
        buckets = kw.get("buckets")
        if buckets is not None and tuple(sorted(buckets)) != m.bounds:
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{m.bounds}; asked for {tuple(sorted(buckets))} — "
                "observations would silently land in the first "
                "registration's layout")
        return m

    def counter(self, name, help_="", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help_, labels)

    def gauge(self, name, help_="", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help_, labels)

    def histogram(self, name, help_="", labels=(),
                  buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help_, labels,
                                   buckets=buckets)

    def get(self, name) -> Optional[_Metric]:
        return self._metrics.get(name)

    def families(self) -> List[str]:
        return sorted(self._metrics)

    def reset(self):
        """Zero every sample (families stay registered) — test/bench
        isolation between runs."""
        for m in self._metrics.values():
            m.clear()

    # -- exposition --------------------------------------------------------
    def dump(self) -> dict:
        return {name: {"kind": m.kind, "help": m.help,
                       "label_names": list(m.label_names),
                       "samples": m.samples()}
                for name, m in sorted(self._metrics.items())}

    def render_prometheus(self) -> str:
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for s in m.samples():
                if m.kind == "histogram":
                    v = s["value"]
                    for le, c in v["buckets"].items():
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels({**s['labels'], 'le': le})} {c}")
                    lines.append(
                        f"{name}_sum{_labels(s['labels'])} {v['sum']}")
                    lines.append(
                        f"{name}_count{_labels(s['labels'])} {v['count']}")
                else:
                    lines.append(
                        f"{name}{_labels(s['labels'])} {s['value']}")
        return "\n".join(lines) + "\n"


def _labels(kv: dict) -> str:
    if not kv:
        return ""
    esc = {k: str(v).replace("\\", r"\\").replace('"', r'\"')
           .replace("\n", r"\n") for k, v in kv.items()}
    return "{" + ",".join(f'{k}="{v}"' for k, v in esc.items()) + "}"


REGISTRY = Registry()


# module-level conveniences over the process-global registry — the form
# the instrumented subsystems use
def counter(name, help_="", labels=()) -> Counter:
    return REGISTRY.counter(name, help_, labels)


def gauge(name, help_="", labels=()) -> Gauge:
    return REGISTRY.gauge(name, help_, labels)


def histogram(name, help_="", labels=(), buckets=_DEFAULT_BUCKETS
              ) -> Histogram:
    return REGISTRY.histogram(name, help_, labels, buckets)


def dump() -> dict:
    return REGISTRY.dump()


def dump_json(**json_kw) -> str:
    return json.dumps(REGISTRY.dump(), **json_kw)


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset():
    REGISTRY.reset()
