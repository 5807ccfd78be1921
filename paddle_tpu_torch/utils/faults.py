"""Deterministic fault injection for resilience testing: the port's own
copy of ``paddle_tpu/utils/faults.py``.

Code threads named *sites* through its hot paths (``should_fire(site)``
/ ``fault_point(site)``), and a test or an operator arms a schedule
that fires at exact call counts or with a seeded probability. The same
spec and seed fire on the same calls as in the JAX package, so a chaos
schedule replays identically in both.

Spec grammar (programmatic via :func:`configure`, or the ``PT_FAULTS``
env var at import, seed from ``PT_FAULTS_SEED``)::

    site:key=val[,key=val...][;site2:...]

    at=N      fire on the Nth call to the site (1-based)
    every=N   fire on every Nth call
    p=F       fire each call with probability F (seeded, deterministic)
    times=K   stop after K fires (default: unlimited)

Zero overhead when disarmed: every entry point checks one module-level
bool first; no site bookkeeping, no RNG draw, no dict lookup happens
unless a schedule is armed.

Sites the port threads (every site of the JAX package):

====================== ============================== ==================
site                   fires in                       failure simulated
====================== ============================== ==================
server.tick            Server.run_until_idle          whole tick skipped
serving.step_block     engine step dispatch           device step error
serving.harvest        engine pending-harvest         host transfer loss
serving.prefill_tick   paged chunked prefill          chunk dispatch err
serving.allocate       BlockManager.allocate          pool exhaustion
serving.poison         engine step (KV NaN)           poisoned slot
fleet.serialize        handoff.encode_handoff         serializer crash
fleet.transport        Transport.send (both kinds)    wire refuses send
fleet.adopt            DecodeWorker.adopt             adopt-side crash
fleet.fetch            Fleet._fetch_prefix op         fetch-op crash
fleet.directory        Fleet._beat_one publish        one publish lost
fleet.scale            Fleet add/drain/remove decode  scale action fails
transport.partial_write SocketTransport frame write   torn TCP write
transport.corrupt      SocketTransport frame write    flipped wire byte
transport.disconnect   SocketTransport ack wait       ack loss/conn drop
journal.write          WriteAheadJournal.append       journal IO error
journal.torn_tail      WriteAheadJournal.append       crash mid-append
checkpoint.commit      durability.write_manifest      die before commit
spill.read             PrefixSpillStore.read          spill file unread
====================== ============================== ==================
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..observability import metrics as _om
from .flags import env_int, env_str

__all__ = ["InjectedFault", "configure", "clear", "active",
           "should_fire", "fault_point", "site_stats", "injected"]

# registered up front so the catalog shows the family before the first
# fire; inc() runs only on the armed-and-fired path
_M_FIRES = _om.counter("pt_fault_fires_total",
                       "injected fault fires by site", labels=("site",))


class InjectedFault(RuntimeError):
    """Raised by an armed fault site. The resilience layer treats it as
    a transient failure (retry / shed / break the circuit)."""


@dataclass
class _Site:
    name: str
    at: Optional[int] = None        # fire on this 1-based call count
    every: Optional[int] = None     # fire when calls % every == 0
    p: float = 0.0                  # per-call probability (seeded)
    times: Optional[int] = None     # max fires (None = unlimited)
    calls: int = 0
    fires: int = 0
    rng: np.random.RandomState = field(
        default_factory=lambda: np.random.RandomState(0))

    def fire(self) -> bool:
        self.calls += 1
        if self.times is not None and self.fires >= self.times:
            return False
        hit = ((self.at is not None and self.calls == self.at)
               or (self.every is not None
                   and self.calls % self.every == 0)
               or (self.p > 0.0 and self.rng.random_sample() < self.p))
        if hit:
            self.fires += 1
            _M_FIRES.inc(site=self.name)
        return hit


_ARMED = False
_SITES: Dict[str, _Site] = {}


def _parse_spec(spec: str, seed: int) -> Dict[str, _Site]:
    sites: Dict[str, _Site] = {}
    for i, part in enumerate(p for p in spec.split(";") if p.strip()):
        name, _, kvs = part.partition(":")
        name = name.strip()
        if not name or not kvs.strip():
            raise ValueError(
                f"bad fault spec {part!r}: want 'site:key=val[,...]'")
        # each site draws from its own stream so adding a site never
        # shifts another site's firing sequence
        site = _Site(name=name, rng=np.random.RandomState((seed, i)))
        for kv in kvs.split(","):
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if k == "at":
                site.at = int(v)
            elif k == "every":
                site.every = int(v)
            elif k == "p":
                site.p = float(v)
            elif k == "times":
                site.times = int(v)
            else:
                raise ValueError(f"unknown fault spec key {k!r} in "
                                 f"{part!r} (want at/every/p/times)")
        sites[name] = site
    return sites


def configure(spec: str, seed: int = 0):
    """Arm a fault schedule (replacing any previous one). An empty spec
    disarms — equivalent to :func:`clear`."""
    global _ARMED, _SITES
    _SITES = _parse_spec(spec, seed) if spec and spec.strip() else {}
    _ARMED = bool(_SITES)


def clear():
    """Disarm every site (the zero-overhead state)."""
    global _ARMED, _SITES
    _ARMED = False
    _SITES = {}


def active() -> bool:
    return _ARMED


def should_fire(site: str) -> bool:
    """True if the armed schedule says this call of ``site`` fails; the
    caller decides what failing means. First line: the disarmed fast
    path."""
    if not _ARMED:
        return False
    s = _SITES.get(site)
    return s.fire() if s is not None else False


def fault_point(site: str):
    """Raise :class:`InjectedFault` when the schedule fires ``site``."""
    if _ARMED and should_fire(site):
        raise InjectedFault(f"injected fault at site {site!r} "
                            f"(call {_SITES[site].calls})")


def site_stats() -> Dict[str, Dict[str, int]]:
    """Per-site ``{"calls": n, "fires": m}`` of the armed schedule."""
    return {name: {"calls": s.calls, "fires": s.fires}
            for name, s in _SITES.items()}


class injected:
    """Context manager: arm a schedule, disarm on exit.

    >>> with faults.injected("serving.step_block:at=2"):
    ...     server.run_until_idle()
    """

    def __init__(self, spec: str, seed: int = 0):
        self.spec, self.seed = spec, seed

    def __enter__(self):
        configure(self.spec, self.seed)
        return self

    def __exit__(self, *exc):
        clear()
        return False


# env arming (operators, bench children): PT_FAULTS="site:spec;..."
_env_spec = env_str("PT_FAULTS")
if _env_spec:
    configure(_env_spec, env_int("PT_FAULTS_SEED", 0))
