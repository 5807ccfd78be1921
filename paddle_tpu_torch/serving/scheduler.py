"""Host-side request scheduler: FIFO admission over an arrival-ordered
queue with a max-wait batching gate and prefill-token pacing.

Counterpart of ``paddle_tpu/serving/scheduler.py`` (``Request`` and
``Scheduler``); preemption resume state and fair scheduling come
later."""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = ["Request", "Scheduler"]


@dataclass
class Request:
    """One generation request. ``temperature <= 0`` decodes greedily;
    a sampled request draws from threefry keys split from
    ``PRNGKey(seed)``, as in the JAX package. ``arrival_step``: the
    engine-block tick at which the
    request becomes visible (deterministic staggered arrivals)."""
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


class Scheduler:
    """FIFO admission queue + batching gate + prefill pacing.

    ``prefill_token_budget``: per-tick cap on admitted PROMPT tokens,
    which also paces the paged engine's chunked prefill, so one tick
    never steals more than about ``budget`` tokens of prefill from the
    in-flight decode. At least one request always passes when the gate
    is open."""

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

    def pop_ready(self, now: int, free_slots: int,
                  engine_idle: bool) -> List[Request]:
        """Requests to admit this tick. The gate holds until
        ``min_admit`` requests are visible or the oldest visible one has
        waited ``max_wait_steps`` ticks — unless the engine is idle. The
        released prefix is cut at the prefill token budget (the first
        request is exempt)."""
        if free_slots <= 0 or not self._queue:
            return []
        n_visible = bisect.bisect_right(self._queue, now,
                                        key=lambda r: r.arrival_step)
        if n_visible == 0:
            return []
        oldest_wait = now - self._queue[0].arrival_step
        if not (n_visible >= self.min_admit
                or oldest_wait >= self.max_wait_steps or engine_idle):
            return []
        token_budget = self.prefill_token_budget
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
