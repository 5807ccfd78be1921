"""SLO-driven autoscaling: size the decode pool to the traffic. The
port's counterpart of ``paddle_tpu/serving/autoscaler.py``.

A static fleet is sized for one load level; real traffic breathes (see
:mod:`.loadgen`). This module closes the loop: a control loop watches the
serving stack's public surfaces — the metrics registry's rolling-window
TTFT p95 against a target SLO, queue depth, and block pressure out of
``Fleet.stats()`` — and decides, each evaluation interval, to scale the
decode pool up (adopt an engine from a factory), scale it down (drain
the least-loaded worker, then remove it once its streams finish in
place), or hold.

- :class:`DecisionKernel` is PURE policy: a hysteresis/cooldown state
  machine over :class:`Observation` values with no fleet in sight, so
  synthetic metric streams pin its exact decision sequences.
- :class:`Autoscaler` binds a kernel to a live
  :class:`~paddle_tpu_torch.serving.fleet.Fleet`: it builds observations,
  applies decisions through the fleet's scale surface
  (``add_decode_worker`` / ``drain_decode_worker`` /
  ``remove_decode_worker`` / ``undrain_decode_worker``, each a journal
  record on a durable fleet), retries transiently failed actions under
  the resilience policy (the ``fleet.scale`` fault site), and records
  every decision to the flight recorder and to
  ``pt_autoscaler_decisions_total{action}`` /
  ``pt_autoscaler_fleet_size``.

Hysteresis and cooldowns guard against thrash: a signal must breach for
``breach_intervals`` CONSECUTIVE evaluations before a scale-up, clear for
``clear_intervals`` before a scale-down, and each direction then goes
cold for its cooldown (an up also arms the down-cooldown, so fresh
capacity is never drained at once). One exception bypasses both: a
fleet below ``min_decode`` routable workers (a lease death ate one) is a
known topology loss, not a noisy signal, and is repaired at once.

Streams riding through scale events stay identical to a static fleet's
run: scale-up adopts compatibility-checked engines and drained workers'
streams finish in place. On the card, an engine captures its graphs when
it is built, so a factory that hands out engines built before the
traffic starts adds no capture when the pool grows. ``dry_run`` records
what the loop would do without touching the fleet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..observability import metrics as _om
from .fleet import DecodeWorker, Fleet
from .resilience import ResilienceConfig, ResilienceState

__all__ = ["AutoscalerConfig", "Observation", "DecisionKernel",
           "Autoscaler"]

# registered at import, so the catalog shows the families before the
# first decision
_M_DECISIONS = _om.counter(
    "pt_autoscaler_decisions_total",
    "autoscaler decisions by action (up/down/hold)",
    labels=("action",))
_M_FLEET_SIZE = _om.gauge(
    "pt_autoscaler_fleet_size",
    "live decode workers the autoscaler last observed")


@dataclass
class AutoscalerConfig:
    """Policy knobs for one control loop.

    - ``ttft_slo_s``: target TTFT; the rolling p95 over ``window`` recent
      samples breaching it is the primary scale-up signal.
    - ``queue_high`` / ``pressure_high``: secondary breach signals (summed
      prefill queue depth, max per-worker block pressure).
    - ``breach_intervals`` / ``clear_intervals``: hysteresis — how many
      CONSECUTIVE breaching (resp. clear) evaluations before the loop
      acts.
    - ``up_cooldown`` / ``down_cooldown``: evaluations a direction stays
      cold after acting (an up also arms the down-cooldown).
    - ``min_decode`` / ``max_decode``: fleet-size bounds; below
      ``min_decode`` repairs at once, bypassing hysteresis and cooldown.
    - ``interval_ticks``: evaluation cadence of :meth:`Autoscaler.on_tick`.
    - ``dry_run``: record decisions (flight and metrics) but never act.
    """
    ttft_slo_s: float = 0.25
    window: int = 64
    queue_high: int = 8
    pressure_high: float = 0.92
    breach_intervals: int = 2
    clear_intervals: int = 3
    up_cooldown: int = 3
    down_cooldown: int = 5
    min_decode: int = 1
    max_decode: int = 4
    interval_ticks: int = 8
    dry_run: bool = False


@dataclass
class Observation:
    """One evaluation's inputs: everything the kernel sees. A missing
    TTFT read (metrics off, or no completion since the last evaluation)
    is None and adds no breach on that signal; queue depth and pressure
    stay actionable."""
    ttft_p95_s: Optional[float] = None
    queue_depth: int = 0
    block_pressure: float = 0.0
    fleet_size: int = 1          # live decode workers (draining included)
    draining: int = 0
    dead: int = 0


@dataclass
class Decision:
    action: str                  # "up" | "down" | "hold"
    reason: str
    obs: Observation
    acted: bool = False
    detail: str = ""


class DecisionKernel:
    """Pure hysteresis/cooldown state machine: ``decide(obs)`` once per
    evaluation interval, with no side effect beyond its own streak and
    cooldown counters."""

    def __init__(self, config: Optional[AutoscalerConfig] = None):
        self.cfg = config or AutoscalerConfig()
        self.breach_streak = 0
        self.clear_streak = 0
        self.up_cold = 0         # evaluations until scale-up re-arms
        self.down_cold = 0

    def breach_reasons(self, obs: Observation) -> List[str]:
        c, out = self.cfg, []
        if obs.ttft_p95_s is not None and obs.ttft_p95_s > c.ttft_slo_s:
            out.append("ttft")
        if obs.queue_depth > c.queue_high:
            out.append("queue")
        if obs.block_pressure > c.pressure_high:
            out.append("pressure")
        return out

    def decide(self, obs: Observation) -> Decision:
        c = self.cfg
        # topology repair first: below the floor is a known loss, not a
        # noisy signal, and bypasses hysteresis and cooldown
        routable = obs.fleet_size - obs.draining
        if routable < c.min_decode:
            self.breach_streak = self.clear_streak = 0
            self.up_cold = c.up_cooldown
            return Decision("up", "below_min", obs)

        reasons = self.breach_reasons(obs)
        if reasons:
            self.breach_streak += 1
            self.clear_streak = 0
        else:
            self.clear_streak += 1
            self.breach_streak = 0

        # gate on the value before the decrement, so cooldown=N holds off
        # exactly N evaluations
        up_ok, down_ok = self.up_cold == 0, self.down_cold == 0
        if self.up_cold > 0:
            self.up_cold -= 1
        if self.down_cold > 0:
            self.down_cold -= 1

        if self.breach_streak >= c.breach_intervals and up_ok:
            if obs.fleet_size >= c.max_decode and obs.draining == 0:
                return Decision("hold", "at_max", obs)
            self.breach_streak = 0
            self.up_cold = c.up_cooldown
            # fresh capacity must not be drained at once
            self.down_cold = max(self.down_cold, c.down_cooldown)
            return Decision("up", "+".join(reasons), obs)

        if self.clear_streak >= c.clear_intervals and down_ok:
            if routable <= c.min_decode:
                return Decision("hold", "at_min", obs)
            self.clear_streak = 0
            self.down_cold = c.down_cooldown
            return Decision("down", "clear", obs)

        return Decision("hold", "breaching" if reasons else "clear", obs)


class Autoscaler:
    """Bind a :class:`DecisionKernel` to a live fleet.

    ``engine_factory()`` returns an engine compatible with the fleet's
    decode pool (same config, dtype and layout; the fleet re-validates at
    ``add_decode_worker``). Scale-ups get fresh ``scale{n}`` names: dead
    workers' tombstones keep their names reserved in the fleet's health
    map.

    Scale-down is a two-phase lifecycle across evaluations: the decision
    drains the least-loaded non-draining worker (no new handoff routes to
    it); every later :meth:`step` first REMOVES any drained worker that
    has gone idle. Streams on a draining worker finish in place."""

    def __init__(self, fleet: Fleet,
                 engine_factory: Callable[[], object],
                 config: Optional[AutoscalerConfig] = None,
                 resilience: Optional[ResilienceConfig] = None):
        self.fleet = fleet
        self.factory = engine_factory
        self.cfg = config or AutoscalerConfig()
        self.kernel = DecisionKernel(self.cfg)
        self._res = ResilienceState(resilience or ResilienceConfig())
        self.decisions: List[Decision] = []
        self._next_name = 0
        self._ttft_seen = 0
        self.peak_size = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.removals = 0
        self.retries = 0

    # -- observation (public surfaces only) --------------------------------
    def observe(self) -> Observation:
        st = self.fleet.stats()
        decode = st["decode_workers"]
        live = [d for d in decode if d["state"] == "live"]
        pressures = [d["block_pressure"] for d in live] + \
            [w["block_pressure"] for w in st["prefill_workers"]
             if w["state"] == "live"]
        # p95 over the samples that arrived SINCE the last evaluation
        # (capped at cfg.window): a count-based ring never ages, so the
        # full ring would latch a burst-era breach forever; an interval
        # with no completion reads as no TTFT signal
        ttft = None
        fam = _om.REGISTRY.get("pt_server_ttft_seconds")
        if fam is not None and hasattr(fam, "recent_quantile"):
            n = int(fam.count())   # cumulative, never wraps
            fresh = n - self._ttft_seen
            self._ttft_seen = n
            if fresh > 0:
                ttft = fam.recent_quantile(
                    0.95, window=min(fresh, self.cfg.window))
        return Observation(
            ttft_p95_s=ttft,
            queue_depth=sum(w["queue"] for w in st["prefill_workers"]
                            if w["state"] == "live"),
            block_pressure=max(pressures) if pressures else 0.0,
            fleet_size=len(live),
            draining=sum(1 for d in live if d["draining"]),
            dead=sum(1 for d in decode if d["state"] == "dead"))

    # -- the loop ----------------------------------------------------------
    def on_tick(self, clock: int):
        """Evaluation cadence hook for :func:`.loadgen.replay`: one
        :meth:`step` every ``interval_ticks`` ticks."""
        if clock % self.cfg.interval_ticks == 0:
            self.step()

    def step(self) -> Decision:
        """One evaluation interval: finish pending drains, observe,
        decide, act (unless ``dry_run``), record."""
        if not self.cfg.dry_run:
            self._reap_drained()
        obs = self.observe()
        d = self.kernel.decide(obs)
        if not self.cfg.dry_run and d.action != "hold":
            self._apply(d)
        self.decisions.append(d)
        # the peak counts the size after this interval's action too
        self.peak_size = max(self.peak_size, obs.fleet_size,
                             len(self.fleet._live_decode()))
        _M_DECISIONS.inc(action=d.action)
        _M_FLEET_SIZE.set(obs.fleet_size)
        self.fleet.flight.record(
            "autoscale", action=d.action, reason=d.reason,
            acted=d.acted, detail=d.detail, fleet_size=obs.fleet_size,
            draining=obs.draining, queue=obs.queue_depth,
            pressure=obs.block_pressure, ttft_p95_s=obs.ttft_p95_s,
            dry_run=self.cfg.dry_run)
        return d

    # -- actuation ---------------------------------------------------------
    def _with_retry(self, what: str, fn: Callable[[], object]):
        """The resilience policy around one scale action: transient
        failures (an armed ``fleet.scale`` raises InjectedFault) retry
        with seeded backoff; an action still failing is dropped and the
        NEXT evaluation decides again from fresh observations."""
        attempts = self._res.config.retry_attempts
        for attempt in range(attempts + 1):
            try:
                return fn()
            except self._res.transient:
                if attempt >= attempts:
                    self.fleet.flight.record(
                        "autoscale_action_failed", what=what,
                        attempts=attempt + 1)
                    return None
                self.retries += 1
                self._res.retries += 1
                self._res.backoff_s(attempt)  # seeded draw, no sleep

    def _reap_drained(self):
        """Remove drained workers that have gone idle. The fleet's
        ``remove_decode_worker`` re-validates (busy slots, queued
        adoptions, payloads on the wire all refuse): a drain still busy
        waits for a later interval."""
        st = self.fleet.stats()
        for i in range(len(st["decode_workers"]) - 1, -1, -1):
            d = st["decode_workers"][i]
            if not (d["draining"] and d["state"] == "live"):
                continue

            def _rm(idx=i):
                try:
                    return self.fleet.remove_decode_worker(idx)
                except RuntimeError:
                    return None     # still owns streams; next interval
            if self._with_retry("remove", _rm) is not None:
                self.removals += 1

    def _apply(self, d: Decision):
        if d.action == "up":
            st = self.fleet.stats()
            draining = [i for i, w in enumerate(st["decode_workers"])
                        if w["draining"] and w["state"] == "live"]
            if draining:
                # the cheapest capacity: cancel a pending drain (no new
                # engine)
                idx = draining[0]
                ok = self._with_retry(
                    "undrain",
                    lambda: self.fleet.undrain_decode_worker(idx) or True)
                if ok:
                    d.acted, d.detail = True, \
                        f"undrain:{st['decode_workers'][idx]['name']}"
                    self.scale_ups += 1
                return
            name = f"scale{self._next_name}"
            self._next_name += 1
            # the engine is built ONCE; a retry repeats the fleet's
            # registration, not the engine's construction
            w = DecodeWorker(self.factory(), name=name)

            def _add():
                self.fleet.add_decode_worker(w)
                return True
            if self._with_retry("add", _add):
                d.acted, d.detail = True, f"add:{name}"
                self.scale_ups += 1
        elif d.action == "down":
            st = self.fleet.stats()
            victims = [
                (w["free_slots"], i)
                for i, w in enumerate(st["decode_workers"])
                if w["state"] == "live" and not w["draining"]]
            if len(victims) <= self.cfg.min_decode:
                return
            _, idx = max(victims)   # most free slots = least loaded
            ok = self._with_retry(
                "drain",
                lambda: self.fleet.drain_decode_worker(idx) or True)
            if ok:
                d.acted, d.detail = True, \
                    f"drain:{st['decode_workers'][idx]['name']}"
                self.scale_downs += 1

    # -- reporting ---------------------------------------------------------
    def stats(self) -> dict:
        actions = {"up": 0, "down": 0, "hold": 0}
        for d in self.decisions:
            actions[d.action] += 1
        return {"decisions": actions,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "removals": self.removals,
                "retries": self.retries,
                "peak_size": self.peak_size,
                "dry_run": self.cfg.dry_run}
