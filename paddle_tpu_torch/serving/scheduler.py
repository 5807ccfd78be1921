"""Host-side request scheduler: FIFO admission over an arrival-ordered
queue with a max-wait batching gate and prefill-token pacing.

Counterpart of ``paddle_tpu/serving/scheduler.py`` (``Request``,
``ResumeState`` and ``Scheduler``). The requests carry the JAX fields
in full (deadlines, tenant, priority, resume state), so snapshots
serialize what the JAX package's do. The server's priority preemption
sets ``resume`` and ``wait_from`` and requeues the victim; it runs only
over a priority-aware scheduler (``serving.frontend.FairScheduler``,
which also sheds at tenant quotas), never over this FIFO one."""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

__all__ = ["Request", "ResumeState", "Scheduler"]


@dataclass
class ResumeState:
    """Carried state of a preempted in-flight request: the token stream
    generated so far (``tokens[-1]`` is the next token to decode,
    sampled but not yet written to KV), the slot's rng key at eviction
    (the key the next step would have split) and the original
    first-token timestamp. ``redrive`` marks fleet failure recovery.
    Serialized into server snapshots by
    ``resilience.request_to_meta``."""
    tokens: List[int] = field(default_factory=list)
    key: Optional[np.ndarray] = None    # (2,) uint32 per-slot PRNG key
    t_admit: float = 0.0
    redrive: bool = False


@dataclass
class Request:
    """One generation request. ``temperature <= 0`` decodes greedily;
    a sampled request draws from threefry keys split from
    ``PRNGKey(seed)``, as in the JAX package. ``arrival_step``: the
    engine-block tick at which the request becomes visible
    (deterministic staggered arrivals).

    ``deadline_ticks`` / ``deadline_s``: per-request deadlines (engine
    ticks past ``arrival_step`` / wall seconds past submit). A request
    still queued or in flight past its deadline is cancelled — slot
    freed, paged blocks released — and a ``RequestFailure`` lands in
    ``Server.results`` (None disables; the server-level
    ``ResilienceConfig`` supplies defaults). ``tenant`` / ``priority``:
    the multi-tenant front-door dimensions; ``resume`` and
    ``wait_from`` are set by a preemption."""
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int = 20
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    seed: int = 0
    arrival_step: int = 0
    t_submit: float = 0.0
    deadline_ticks: Optional[int] = None
    deadline_s: Optional[float] = None
    tenant: str = "default"
    priority: int = 0
    resume: Optional[ResumeState] = None
    # the tick a preemption requeued the request at: the max-queue-wait
    # gate measures from here, not from arrival_step
    wait_from: Optional[int] = None


class Scheduler:
    """FIFO admission queue + batching gate + prefill pacing.

    ``prefill_token_budget``: per-tick cap on admitted PROMPT tokens,
    which also paces the paged engine's chunked prefill, so one tick
    never steals more than about ``budget`` tokens of prefill from the
    in-flight decode. At least one request always passes when the gate
    is open."""

    # strict FIFO pop: a slot freed by preemption would go back to the
    # front-inserted victim, so preemption refuses this class
    priority_aware = False

    def __init__(self, max_wait_steps: int = 0, min_admit: int = 1,
                 prefill_token_budget: Optional[int] = None):
        if min_admit < 1:
            raise ValueError(f"min_admit={min_admit}; must be >= 1")
        if prefill_token_budget is not None and prefill_token_budget < 1:
            raise ValueError(
                f"prefill_token_budget={prefill_token_budget}; must be "
                ">= 1 (None disables pacing)")
        self.max_wait_steps = max_wait_steps
        self.min_admit = min_admit
        self.prefill_token_budget = prefill_token_budget
        self._queue: List[Request] = []

    def submit(self, request: Request):
        # sorted by arrival tick; insort keeps FIFO within a tick
        bisect.insort(self._queue, request, key=lambda r: r.arrival_step)

    def requeue(self, request: Request):
        """Put a popped request back at the FRONT of its arrival tick
        (the engine deferred it: the block pool was exhausted)."""
        bisect.insort_left(self._queue, request,
                           key=lambda r: r.arrival_step)

    def pending(self) -> int:
        return len(self._queue)

    def drop_where(self, pred) -> List[Request]:
        """Remove and return every queued request matching ``pred`` —
        the deadline/queue-wait expiry and circuit-breaker drain hook
        (arrival order of the survivors is preserved)."""
        dropped = [r for r in self._queue if pred(r)]
        if dropped:
            self._queue = [r for r in self._queue if not pred(r)]
        return dropped

    def next_arrival(self) -> Optional[int]:
        return self._queue[0].arrival_step if self._queue else None

    def visible(self, now: int) -> List[Request]:
        """Queued requests already visible at tick ``now`` (a peek: the
        queue is untouched)."""
        n = bisect.bisect_right(self._queue, now,
                                key=lambda r: r.arrival_step)
        return self._queue[:n]

    def _gate_visible(self, now: int, free_slots: int, engine_idle: bool,
                      token_budget: Optional[int]):
        """The admission preamble: ``(n_visible, token_budget)`` when the
        batching gate is open, else None. The gate holds until
        ``min_admit`` requests are visible or the oldest visible one has
        waited ``max_wait_steps`` ticks — unless the engine is idle."""
        if free_slots <= 0 or not self._queue:
            return None
        n_visible = bisect.bisect_right(self._queue, now,
                                        key=lambda r: r.arrival_step)
        if n_visible == 0:
            return None
        oldest_wait = now - self._queue[0].arrival_step
        if not (n_visible >= self.min_admit
                or oldest_wait >= self.max_wait_steps or engine_idle):
            return None
        if token_budget is None:
            token_budget = self.prefill_token_budget
        return n_visible, token_budget

    def pop_ready(self, now: int, free_slots: int, engine_idle: bool,
                  token_budget: Optional[int] = None) -> List[Request]:
        """Requests to admit this tick (see :meth:`_gate_visible`). The
        released prefix is cut at the prefill token budget (the
        argument, else the scheduler's own; the first request is
        exempt)."""
        gate = self._gate_visible(now, free_slots, engine_idle,
                                  token_budget)
        if gate is None:
            return []
        n_visible, token_budget = gate
        take: List[Request] = []
        tokens = 0
        for r in self._queue[:min(free_slots, n_visible)]:
            t = int(np.asarray(r.prompt).size)
            if take and token_budget is not None \
                    and tokens + t > token_budget:
                break
            take.append(r)
            tokens += t
        del self._queue[:len(take)]
        return take
