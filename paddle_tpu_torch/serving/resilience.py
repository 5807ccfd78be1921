"""Resilience policies for the serving loop: deadlines and
cancellation, bounded-queue admission control with load shedding,
retry with exponential backoff around transient step failures, a
circuit breaker, the NaN-logit quarantine gate, and crash-safe snapshot
plumbing. The port's counterpart of ``paddle_tpu/serving/resilience.py``.

The engine (``engine.py`` / ``paging.py``) owns MECHANISM — it can
cancel a slot, abort a prefill job, report per-row NaN flags from its
captured decode block, and serialize its full state — while this module
owns POLICY: when to shed, when to expire, how many times to retry,
when to give up and drain. ``Server`` threads a
:class:`ResilienceConfig` through its tick loop; the default config
changes nothing observable (no deadlines, shedding off, retries only
ever see :class:`~paddle_tpu_torch.utils.faults.InjectedFault`).

Failure taxonomy (the ``reason`` on every :class:`RequestFailure`):
``"shed"`` (rejected at submit, queue depth at the cap), ``"timeout"``
(deadline/queue-wait exceeded, queued or in flight), ``"poisoned"``
(the slot's log-probs went NaN; only that slot is quarantined) and
``"circuit_open"`` (the breaker tripped after N consecutive step
failures; everything in flight and queued is drained).

Deliberate difference from the JAX package: the retry loop treats
:class:`InjectedFault` and the fleet transport's ``TransportError`` as
transient, but not a device error. A CUDA error is NOT retried: a sticky
CUDA error poisons the process's context, so every later launch fails
too, and retrying would hide the fault behind the breaker instead of
surfacing it.

Snapshots are single npz files written atomically (tmp + rename via
``distributed.checkpoint.atomic_savez``) holding the engine's device
state, copied to the host, plus host metadata as an embedded JSON
string. The format is JAX's (``pt-serving-snapshot`` v1, the same meta
schema and array names); the port's rng keys are int64 words where
JAX's are uint32, so a snapshot restores into the package that wrote
it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.faults import InjectedFault
from ..utils.flags import env_bool, env_float, env_int
from .scheduler import Request

__all__ = ["RequestFailure", "ResilienceConfig", "ResilienceState",
           "save_snapshot", "load_snapshot", "request_to_meta",
           "request_from_meta"]


@dataclass
class RequestFailure:
    """Recorded in ``Server.results[request_id]`` when a request ends
    any way other than completing — the explicit alternative to a
    silent hang. ``tokens_emitted``: useful tokens produced before the
    failure (partial work is accounted, not returned)."""
    request_id: int
    reason: str
    message: str = ""
    tokens_emitted: int = 0

    def __bool__(self):      # `if results[rid]` reads as "succeeded?"
        return False


def _transient_types() -> Tuple[type, ...]:
    """Exception types the retry loop treats as transient: injected
    faults and the fleet transport's wire failure (a send that exhausted
    its reconnect budget — the network being down is operational, not a
    bug); see the module docstring for why a CUDA error is not one.
    Programming errors (ValueError and friends) always propagate."""
    from .transport import TransportError
    return (InjectedFault, TransportError)


@dataclass
class ResilienceConfig:
    """Server-level policy knobs (every one also env-overridable so a
    bench child or an operator can arm them without code):

    - ``deadline_s`` / ``deadline_ticks``: default per-request
      deadlines (a request's own fields win).
    - ``max_queue_wait_ticks``: cap on ticks a request may sit queued
      past its arrival before it times out.
    - ``max_queue_depth``: admission control — a submit beyond this
      many queued requests is shed immediately.
    - ``retry_attempts`` / ``retry_backoff_s`` / ``retry_jitter``:
      exponential backoff (base · 2^attempt, +jitter fraction, seeded)
      around transient step/prefill/harvest failures.
    - ``breaker_threshold``: consecutive transient failures before the
      circuit opens and the server drains everything as
      ``circuit_open``.
    - ``nan_sentinel``: host gate on the engine's in-graph NaN flags.
    """
    deadline_s: Optional[float] = None
    deadline_ticks: Optional[int] = None
    max_queue_wait_ticks: Optional[int] = None
    max_queue_depth: Optional[int] = None
    retry_attempts: int = 2
    retry_backoff_s: float = 0.02
    retry_jitter: float = 0.25
    breaker_threshold: int = 8
    nan_sentinel: bool = True
    seed: int = 0

    @classmethod
    def from_env(cls) -> "ResilienceConfig":
        def opt_f(name):
            v = env_float(name, -1.0)
            return None if v < 0 else v

        def opt_i(name):
            v = env_int(name, -1)
            return None if v < 0 else v

        return cls(
            deadline_s=opt_f("PT_SERVING_DEADLINE_S"),
            deadline_ticks=opt_i("PT_SERVING_DEADLINE_TICKS"),
            max_queue_wait_ticks=opt_i("PT_SERVING_MAX_QUEUE_WAIT"),
            max_queue_depth=opt_i("PT_SERVING_MAX_QUEUE_DEPTH"),
            retry_attempts=env_int("PT_SERVING_RETRIES", 2),
            retry_backoff_s=env_float("PT_SERVING_BACKOFF_S", 0.02),
            retry_jitter=env_float("PT_SERVING_JITTER", 0.25),
            breaker_threshold=env_int("PT_SERVING_BREAKER", 8),
            nan_sentinel=env_bool("PT_SERVING_NAN_SENTINEL", True),
            seed=env_int("PT_SERVING_RESILIENCE_SEED", 0))


@dataclass
class ResilienceState:
    """Mutable runtime state + counters for one Server (surfaced via
    ``Server.stats()``). The jitter RNG is seeded so a replayed fault
    schedule produces the identical backoff sequence."""
    config: ResilienceConfig
    rng: np.random.RandomState = field(init=False)
    transient: Tuple[type, ...] = field(init=False)
    shed_requests: int = 0
    timeouts: int = 0
    retries: int = 0
    step_failures: int = 0
    tick_faults: int = 0
    consecutive_failures: int = 0
    breaker_open: bool = False
    failures_by_reason: Dict[str, int] = field(default_factory=dict)
    last_error: str = ""

    def __post_init__(self):
        self.rng = np.random.RandomState(self.config.seed)
        self.transient = _transient_types()

    def backoff_s(self, attempt: int) -> float:
        c = self.config
        return c.retry_backoff_s * (2.0 ** attempt) \
            * (1.0 + c.retry_jitter * float(self.rng.random_sample()))

    def count_failure(self, reason: str):
        self.failures_by_reason[reason] = \
            self.failures_by_reason.get(reason, 0) + 1
        if reason == "timeout":
            self.timeouts += 1

    def counters(self) -> dict:
        return {
            "requests_failed": sum(self.failures_by_reason.values()),
            "failures_by_reason": dict(self.failures_by_reason),
            "shed_requests": self.shed_requests,
            "timeouts": self.timeouts,
            "retries": self.retries,
            "step_failures": self.step_failures,
            "tick_faults": self.tick_faults,
            "consecutive_failures": self.consecutive_failures,
            "breaker_open": self.breaker_open,
        }

    def restore_counters(self, c: dict):
        """Rehydrate from a snapshot's ``counters()`` dict — the
        breaker state and failure budget survive a restore (an OPEN
        circuit must not silently re-close and resume dispatching to a
        device the policy quarantined)."""
        self.failures_by_reason = dict(c.get("failures_by_reason", {}))
        self.shed_requests = c.get("shed_requests", 0)
        self.timeouts = c.get("timeouts", 0)
        self.retries = c.get("retries", 0)
        self.step_failures = c.get("step_failures", 0)
        self.tick_faults = c.get("tick_faults", 0)
        self.consecutive_failures = c.get("consecutive_failures", 0)
        self.breaker_open = c.get("breaker_open", False)


# ---------------------------------------------------------------------------
# request (de)serialization for snapshots
# ---------------------------------------------------------------------------

_REQ_FIELDS = ("request_id", "max_new_tokens", "temperature", "top_k",
               "top_p", "eos_token_id", "seed", "arrival_step",
               "t_submit", "deadline_ticks", "deadline_s", "tenant",
               "priority", "wait_from")


def request_to_meta(req: Request) -> dict:
    """JSON-safe dict of a Request minus its prompt (prompts are
    arrays — they ride the snapshot's npz payload instead). Preemption
    ``resume`` state — the generated tokens, the slot rng key, the
    first-token timestamp — serializes inline: it is exactly the host
    half of the per-slot snapshot format, small enough for JSON."""
    meta = {f: getattr(req, f) for f in _REQ_FIELDS}
    if req.resume is not None:
        meta["resume"] = {
            "tokens": [int(t) for t in req.resume.tokens],
            "key": [int(k) for k in
                    np.asarray(req.resume.key, np.uint32).reshape(-1)],
            "t_admit": float(req.resume.t_admit),
            "redrive": bool(req.resume.redrive)}
    return meta


def request_from_meta(meta: dict, prompt) -> Request:
    from .scheduler import ResumeState
    resume = None
    rs = meta.get("resume")
    if rs is not None:
        resume = ResumeState(tokens=list(rs["tokens"]),
                             key=np.asarray(rs["key"], np.uint32),
                             t_admit=rs["t_admit"],
                             redrive=bool(rs.get("redrive", False)))
    # tolerant field read: snapshots written before tenant/priority
    # existed restore with the dataclass defaults
    return Request(prompt=np.asarray(prompt, np.int32).reshape(-1),
                   resume=resume,
                   **{f: meta[f] for f in _REQ_FIELDS if f in meta})


# ---------------------------------------------------------------------------
# snapshot file format: one npz, atomic rename, JSON metadata embedded
# ---------------------------------------------------------------------------

_SNAP_VERSION = 1


def save_snapshot(path: str, meta: dict, arrays: Dict[str, np.ndarray]):
    """Write ``{meta, arrays}`` as ONE crash-safe npz: the metadata
    travels as a JSON string array (no pickle), and the write goes
    through the checkpoint module's atomic tmp+rename helper — a crash
    mid-write leaves the previous snapshot intact, never a torn file."""
    from ..distributed.checkpoint import atomic_savez
    payload = dict(arrays)
    payload["__meta__"] = np.array(json.dumps(
        {"format": "pt-serving-snapshot", "version": _SNAP_VERSION,
         **meta}))
    atomic_savez(path, payload)


def load_snapshot(path: str):
    """Returns ``(meta, arrays)``. Arrays are materialized eagerly so
    the npz handle never outlives the call."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("format") != "pt-serving-snapshot":
        raise ValueError(f"{path} is not a serving snapshot")
    if meta.get("version") != _SNAP_VERSION:
        raise ValueError(
            f"snapshot version {meta.get('version')} unsupported "
            f"(this build reads {_SNAP_VERSION})")
    return meta, arrays
