"""Multi-tenant serving front door: token streaming, weighted-fair
admission, priority preemption.

Counterpart of ``paddle_tpu/serving/frontend.py`` (which imports no
JAX either, so this is its text over the port's ``Server``):

- token streaming out of the harvest path: a request can carry a
  bounded :class:`TokenStream` (an iterator that pumps the server one
  tick at a time while it is empty) and/or an ``on_token`` callback;
  tokens become visible at decode-block granularity, when the host
  harvests them, through ``Server.stream_sink``;
- weighted-fair queueing with quotas (:class:`FairScheduler`): strict
  priority tiers first; within a tier the tenant with the smallest
  weighted usage (a deficit ledger debiting ``cost / weight``, cost =
  the remaining token budget); arrival FIFO within a tenant; per-tenant
  ``max_queued`` quotas shed at submit; a requeue credits the ledger;
- priority preemption (policy in ``server.py``, mechanism in
  ``engine.py`` / ``paging.py``): a strictly higher-priority request
  that would wait evicts a lower-priority slot; the victim requeues
  with its stream (``ResumeState``) and re-admits by re-prefilling its
  history, its greedy and seeded sampled streams as an uninterrupted
  run's. On the card the resume reuses the engine's captured programs:
  no new graph.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..observability import ObservabilityConfig
from ..observability import metrics as _om
from .engine import ContinuousBatchingEngine
from .resilience import RequestFailure, ResilienceConfig
from .scheduler import Request, Scheduler
from .server import Server

__all__ = ["FairScheduler", "Frontend", "TenantConfig", "TokenStream"]

# front-door stream families (registered at import; no-ops until
# metrics.enable()/PT_METRICS — catalog complete at zero)
_M_STREAM_TOKENS = _om.counter(
    "pt_frontend_stream_tokens_total",
    "tokens fanned out to per-request streams/callbacks")
_M_STREAM_DROPPED = _om.counter(
    "pt_frontend_stream_dropped_total",
    "stream tokens evicted from a bounded queue whose consumer lagged")


@dataclass
class TenantConfig:
    """Front-door policy for one tenant. ``weight`` sets its
    weighted-fair throughput share relative to the other backlogged
    tenants (default 1.0 — equal shares); ``max_queued`` caps its
    queued requests, shedding beyond (None = unbounded, only the
    server-level ``max_queue_depth`` applies)."""
    weight: float = 1.0
    max_queued: Optional[int] = None


class FairScheduler(Scheduler):
    """Per-tenant weighted-fair admission layered on the arrival-sorted
    FIFO queue. The ``_queue`` layout, ``submit``/``requeue``/
    ``drop_where`` and the snapshot format are the base class's —
    only the SELECTION in :meth:`pop_ready` changes:

    1. strict priority tiers (a visible higher-priority request always
       admits before any lower one);
    2. within a tier, the tenant with the smallest deficit ledger
       entry wins; admitting debits ``cost / weight`` where cost is
       the request's remaining token budget, so over a backlogged
       window per-tenant token throughput converges to the weights;
    3. within a tenant, arrival FIFO.

    Tenants enter (and re-enter after going idle) at the ledger floor
    of the currently backlogged set — no credit hoarding while idle.
    The max-wait/min-admit batching gate and the prefill token budget
    apply exactly as in the base scheduler."""

    # Server's preemption policy requires this: a freed slot must go
    # to the highest-priority waiter, which the base FIFO pop cannot
    # guarantee (it would hand the slot back to the requeued victim)
    priority_aware = True

    def __init__(self, tenants: Optional[Dict[str, TenantConfig]] = None,
                 default_weight: float = 1.0, **kw):
        super().__init__(**kw)
        self.tenants: Dict[str, TenantConfig] = dict(tenants or {})
        for name, cfg in self.tenants.items():
            if cfg.weight <= 0:
                raise ValueError(
                    f"tenant {name!r}: weight={cfg.weight}; must be > 0")
        if default_weight <= 0:
            raise ValueError(
                f"default_weight={default_weight}; must be > 0")
        self.default_weight = float(default_weight)
        self._usage: Dict[str, float] = {}    # the deficit ledger
        self._pending: Dict[str, int] = {}    # O(1) quota counts
        self._backlogged: set = set()  # tenants visible at the last pop

    def weight(self, tenant: str) -> float:
        cfg = self.tenants.get(tenant)
        return cfg.weight if cfg is not None else self.default_weight

    def tenant_pending(self, tenant: str) -> int:
        return self._pending.get(tenant, 0)

    def quota_exceeded(self, tenant: str) -> bool:
        """Server.submit's per-tenant shed hook (O(1) — every submit
        pays this, and the base queue was deliberately kept at O(log Q)
        per submit)."""
        cfg = self.tenants.get(tenant)
        return (cfg is not None and cfg.max_queued is not None
                and self.tenant_pending(tenant) >= cfg.max_queued)

    @staticmethod
    def _cost(r: Request) -> float:
        # remaining DECODE budget: what per-tenant throughput is
        # measured in — a resumed request only owes its tail
        done = len(r.resume.tokens) if r.resume is not None else 0
        return float(max(r.max_new_tokens - done, 1))

    # -- queue bookkeeping (pending counts + ledger credits) ---------------
    def submit(self, request: Request):
        self._pending[request.tenant] = \
            self._pending.get(request.tenant, 0) + 1
        super().submit(request)

    def requeue(self, request: Request):
        """Front-insert like the base class, but CREDIT the ledger: the
        pop that released this request debited its cost, and nothing of
        that charge was delivered — the engine deferred it, or a
        preemption carried the delivered part out in ``resume`` (whose
        remaining-tail cost is exactly what the next pop re-debits).
        Without the credit, deferrals and preemptions double-charge
        their tenant and its measured share drifts under its weight."""
        if request.tenant in self._usage:
            self._usage[request.tenant] -= \
                self._cost(request) / self.weight(request.tenant)
        self._pending[request.tenant] = \
            self._pending.get(request.tenant, 0) + 1
        super().requeue(request)

    def drop_where(self, pred) -> List[Request]:
        dropped = super().drop_where(pred)
        for r in dropped:
            self._pending[r.tenant] -= 1
        return dropped

    def pop_ready(self, now: int, free_slots: int, engine_idle: bool,
                  token_budget: Optional[int] = None) -> List[Request]:
        gate = self._gate_visible(now, free_slots, engine_idle,
                                  token_budget)
        if gate is None:
            return []
        n_visible, token_budget = gate
        pool = list(self._queue[:n_visible])
        order = {id(r): i for i, r in enumerate(pool)}  # arrival FIFO
        active = {r.tenant for r in pool}
        # re-entry floor comes from the CONTINUOUSLY backlogged tenants
        # only — including a returning tenant's own stale (frozen-low)
        # entry would make the clamp a no-op and let idling bank credit
        # (it then monopolizes admissions on return until the banked
        # credit drains, starving the tenants that kept submitting)
        cont = [self._usage[t] for t in (active & self._backlogged)
                if t in self._usage]
        floor = min(cont) if cont else 0.0
        for t in active - self._backlogged:
            self._usage[t] = max(self._usage.get(t, floor), floor)
        self._backlogged = active
        take: List[Request] = []
        tokens = 0
        while len(take) < free_slots and pool:
            pmax = max(r.priority for r in pool)
            heads: Dict[str, Request] = {}
            for r in pool:               # oldest per tenant in the tier
                if r.priority == pmax and r.tenant not in heads:
                    heads[r.tenant] = r
            pick = min(heads.values(),
                       key=lambda h: (self._usage[h.tenant],
                                      order[id(h)]))
            t = int(np.asarray(pick.prompt).size)
            if take and token_budget is not None \
                    and tokens + t > token_budget:
                break
            take.append(pick)
            tokens += t
            pool.remove(pick)
            self._usage[pick.tenant] += \
                self._cost(pick) / self.weight(pick.tenant)
        if take:
            taken = set(map(id, take))
            self._queue = [r for r in self._queue
                           if id(r) not in taken]
            for r in take:
                self._pending[r.tenant] -= 1
        return take


class TokenStream:
    """One request's bounded token stream. The frontend pushes freshly
    harvested tokens (and the terminal state) in; the consumer either
    iterates — ``next()`` PUMPS the owning frontend one server tick at
    a time while the buffer is empty — or registers an ``on_token``
    callback invoked inline at harvest. The buffer is BOUNDED: past
    ``capacity`` undrained tokens the oldest are evicted (``dropped``
    counts them), so a stalled consumer can never hold an unbounded
    backlog; ``tokens_seen`` always counts the full stream."""

    def __init__(self, request_id: int, frontend: "Frontend" = None,
                 capacity: int = 1024,
                 on_token: Optional[Callable[[int], None]] = None):
        if capacity < 1:
            raise ValueError(f"capacity={capacity}; must be >= 1")
        self.request_id = request_id
        self.capacity = capacity
        self.on_token = on_token
        self.tokens_seen = 0
        self.dropped = 0
        self.done = False
        self.failure: Optional[str] = None
        self._frontend = frontend
        self._buf: deque = deque()

    # -- producer side (frontend sink) -------------------------------------
    def _push(self, toks):
        for t in toks:
            t = int(t)
            self.tokens_seen += 1
            _M_STREAM_TOKENS.inc()
            if self.on_token is not None:
                self.on_token(t)
            if len(self._buf) >= self.capacity:
                self._buf.popleft()
                self.dropped += 1
                _M_STREAM_DROPPED.inc()
            self._buf.append(t)

    def _finish(self, failure: Optional[str]):
        self.done = True
        self.failure = failure

    # -- consumer side ------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> int:
        while not self._buf:
            if self.done:
                raise StopIteration
            if self._frontend is None or not self._frontend.pump():
                raise RuntimeError(
                    f"stream for request {self.request_id} stalled: the "
                    "server is idle but the request never terminated — "
                    "a serving-loop bug, not a consumer error")
        return self._buf.popleft()

    def drain(self) -> List[int]:
        """Buffered tokens right now, without pumping the server."""
        out = list(self._buf)
        self._buf.clear()
        return out

    def read_all(self) -> List[int]:
        """Drive the stream to its terminal and return every token
        (minus any evicted past the bound — check ``dropped``)."""
        return list(self)


class Frontend:
    """The multi-tenant front door over an engine: builds the
    :class:`FairScheduler` + :class:`~.server.Server` pair, fans
    harvested tokens out to per-request streams, and (with
    ``preemption=True``) lets higher-priority traffic evict and later
    resume lower-priority slots. ``results``/``stats`` proxy the
    server's; everything the plain Server contract pins (bit-identity,
    one compiled decode program, exactly-one terminal per request)
    holds with the front door in place."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 tenants: Optional[Dict[str, TenantConfig]] = None,
                 scheduler: Optional[Scheduler] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 observability: Optional[ObservabilityConfig] = None,
                 preemption: Optional[bool] = None,
                 stream_capacity: int = 1024):
        scheduler = self._resolve_scheduler(tenants, scheduler)
        server = Server(engine, scheduler, resilience,
                        observability, preemption=preemption)
        self._wire(engine, scheduler, server, stream_capacity)

    @staticmethod
    def _resolve_scheduler(tenants, scheduler) -> Scheduler:
        """ONE tenants/scheduler contract for __init__ AND restore —
        the two entry points cannot drift."""
        if scheduler is None:
            return FairScheduler(tenants=tenants)
        if tenants:
            raise ValueError(
                "pass tenants= (builds a FairScheduler) or an explicit "
                "scheduler, not both — silently ignoring the tenant "
                "weights would be a misconfiguration")
        return scheduler

    def _wire(self, engine, scheduler, server: Server,
              stream_capacity: int):
        """Attach this frontend to a server (fresh or restored)."""
        self.engine = engine
        self.scheduler = scheduler
        self.server = server
        self.stream_capacity = stream_capacity
        self._streams: Dict[int, TokenStream] = {}
        self._emitted: Dict[int, int] = {}
        self.tenant_tokens: Dict[str, int] = {}   # streamed, per tenant
        ex = server.restored_extras.get("frontend")
        if ex is not None:
            # delivered offsets ride the snapshot: a re-attached
            # consumer (or a migrated decode worker's streams) sees
            # only the tokens the pre-kill consumer never took —
            # buffered-but-unconsumed tokens were subtracted at
            # snapshot time, so they re-deliver
            self._emitted = {int(k): v
                             for k, v in ex["emitted"].items()}
            self.tenant_tokens = dict(ex["tenant_tokens"])
        self.server.stream_sink = self._sink
        self.server.snapshot_extras["frontend"] = self._snapshot_extra

    @classmethod
    def restore(cls, path: str, engine: ContinuousBatchingEngine,
                tenants: Optional[Dict[str, TenantConfig]] = None,
                scheduler: Optional[Scheduler] = None,
                resilience: Optional[ResilienceConfig] = None,
                observability=None, preemption: Optional[bool] = None,
                stream_capacity: int = 1024) -> "Frontend":
        """Rebuild a front door from a ``Server`` snapshot (fresh
        process simulation). The per-request delivered offsets saved by
        the frontend's snapshot-extras provider rehydrate here, so
        streams re-attached via :meth:`attach_stream` resume at the
        first unseen token instead of re-streaming from offset 0."""
        scheduler = cls._resolve_scheduler(tenants, scheduler)
        server = Server.restore(path, engine, scheduler, resilience,
                                observability, preemption=preemption)
        fe = cls.__new__(cls)
        fe._wire(engine, scheduler, server, stream_capacity)
        return fe

    def _snapshot_extra(self) -> dict:
        """Snapshot-extras provider (server.snapshot_extras hook): the
        per-request DELIVERED offsets. Tokens still sitting in a LIVE
        stream's bounded buffer were never taken by the consumer, so
        they are subtracted — after a restore they deliver again,
        exactly once. Terminal streams keep their full offset (the
        sink never fires for them again, so subtracting would only
        undercount the tenant tallies forever — a re-attached consumer
        of a finished request reads ``results`` instead), and so do
        callback streams: ``on_token`` already fired for every pushed
        token, so their buffered copies WERE delivered."""
        emitted = dict(self._emitted)
        tenant_tokens = dict(self.tenant_tokens)
        for rid, ts in self._streams.items():
            buffered = len(ts._buf)
            if buffered and not ts.done and ts.on_token is None \
                    and rid in emitted:
                emitted[rid] -= buffered
                tenant = self.server._tenant_of.get(rid, "default")
                tenant_tokens[tenant] = \
                    tenant_tokens.get(tenant, 0) - buffered
        return {"emitted": {str(k): v for k, v in emitted.items()},
                "tenant_tokens": tenant_tokens}

    def attach_stream(self, rid: int,
                      on_token: Optional[Callable[[int], None]] = None
                      ) -> TokenStream:
        """(Re-)attach a consumer to a known request — the other half
        of the delivered-offset contract: after a restore, the new
        stream yields only tokens past the saved offset. Re-attaching
        over a LIVE existing stream hands its buffered-but-unconsumed
        tokens to the new one (exactly-once holds across re-attach
        too). A request already terminal closes the stream immediately
        (its full output lives in ``results``)."""
        ts = TokenStream(rid, frontend=self,
                         capacity=self.stream_capacity,
                         on_token=on_token)
        old = self._streams.get(rid)
        if old is not None:
            ts._buf.extend(old.drain())
            if old.done:
                ts._finish(old.failure)
        self._streams[rid] = ts
        v = self.server.results.get(rid)
        if v is not None and not ts.done:
            ts._finish(v.reason if isinstance(v, RequestFailure)
                       else None)
        return ts

    # -- server glue --------------------------------------------------------
    def _sink(self, rid: int, tokens, done: bool,
              failure: Optional[str]):
        """Server harvest hook: diff the run's token list against what
        this request already streamed, push the new suffix, and close
        the stream at its terminal. Per-tenant streamed-token tallies
        accumulate here for every request (the live share measure the
        fairness bench reads), streams or not."""
        emitted = self._emitted.get(rid, 0)
        if tokens is not None and len(tokens) > emitted:
            new = tokens[emitted:]
            self._emitted[rid] = len(tokens)
            tenant = self.server._tenant_of.get(rid, "default")
            self.tenant_tokens[tenant] = \
                self.tenant_tokens.get(tenant, 0) + len(new)
            stream = self._streams.get(rid)
            if stream is not None:
                stream._push(new)
        if done:
            stream = self._streams.get(rid)
            if stream is not None and not stream.done:
                stream._finish(failure)

    # -- API ----------------------------------------------------------------
    def submit(self, prompt, *, tenant: str = "default",
               priority: int = 0, stream: bool = False,
               on_token: Optional[Callable[[int], None]] = None,
               **kw):
        """Submit one request. Plain form returns the request id (same
        contract as ``Server.submit``); with ``stream=True`` and/or an
        ``on_token`` callback it returns a :class:`TokenStream` whose
        ``request_id`` indexes ``results``."""
        rid = self.server.submit(prompt, tenant=tenant,
                                 priority=priority, **kw)
        if not stream and on_token is None:
            return rid
        ts = TokenStream(rid, frontend=self,
                         capacity=self.stream_capacity,
                         on_token=on_token)
        self._streams[rid] = ts
        # a submit-time shed already recorded its failure before the
        # handle existed — close the stream now
        v = self.server.results.get(rid)
        if isinstance(v, RequestFailure):
            ts._finish(v.reason)
        return ts

    def stream(self, rid: int) -> Optional[TokenStream]:
        return self._streams.get(rid)

    def pump(self) -> bool:
        """Advance the server by ONE tick if it has work; returns
        whether it did. The pull edge of the streaming API — iterator
        consumers call this transparently via ``next()``."""
        busy = self.scheduler.pending() > 0 or self.engine.has_live()
        if busy:
            self.server.run_until_idle(max_ticks=1)
        return busy

    def run_until_idle(self, max_ticks: Optional[int] = None):
        return self.server.run_until_idle(max_ticks=max_ticks)

    @property
    def results(self):
        return self.server.results

    def stats(self) -> dict:
        out = self.server.stats()
        out["stream_tokens"] = sum(self._emitted.values())
        out["tenant_stream_tokens"] = dict(sorted(
            self.tenant_tokens.items()))
        return out
