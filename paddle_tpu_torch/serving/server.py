"""Serving loop: Scheduler + engine (dense or paged) + metrics +
resilience policies.

Counterpart of ``paddle_tpu/serving/server.py``. One iteration of the
loop is one tick of the engine-block clock: expire deadlined requests,
admit whatever the scheduler releases into free slots (requests the
paged engine defers for want of KV blocks re-queue), advance the paged
engine's chunked prefills within the scheduler's prefill token budget,
run one decode block, harvest retired requests.

Failure paths are first-class (``serving/resilience.py``): every
submitted request ends either in a completed output array or an
explicit ``RequestFailure`` in ``results`` — deadlines cancel (slot
freed, paged blocks released), bounded queues shed, transient step
failures retry with seeded exponential backoff, a circuit breaker
drains after N consecutive failures, and a NaN-poisoned slot is
quarantined alone. ``snapshot()``/``restore()`` make the server
crash-safe: a process killed between ticks resumes from the snapshot
in a freshly built engine (its CUDA graphs captured anew) and finishes
every stream token-identical to an uninterrupted run. Request traces,
the metrics registry and the flight recorder (``observability``) hook
in where the JAX server's do.

Priority preemption (``preemption=True`` over a priority-aware
scheduler, ``serving.frontend.FairScheduler``): a strictly
higher-priority request that would wait on a full pool evicts a
lower-priority slot at a tick boundary (``engine.preempt_slot``); the
victim requeues carrying its stream (``ResumeState``) and re-admits by
re-prefilling its history, so its greedy and seeded sampled streams end
as an uninterrupted run's. Preempt and resume are span events on the
request's trace, never terminals."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from ..observability import (FlightRecorder, ObservabilityConfig,
                             RequestTracer)
from ..observability import metrics as _om
from ..observability.tracing import export_chrome_trace, now_us
from ..utils import faults
from ..utils.flags import env_bool
from .engine import ContinuousBatchingEngine
from .resilience import (RequestFailure, ResilienceConfig,
                         ResilienceState, load_snapshot,
                         request_from_meta, request_to_meta,
                         save_snapshot)
from .scheduler import Request, ResumeState, Scheduler

__all__ = ["Server"]

# metric families (JAX's names; registered at import, no-ops until
# metrics.enable() / PT_METRICS arms the registry)
_M_TICKS = _om.counter("pt_server_ticks_total", "server ticks executed")
_M_TICK_S = _om.histogram("pt_server_tick_seconds",
                          "wall seconds per server tick")
_M_QUEUE = _om.gauge("pt_server_queue_depth",
                     "requests waiting in the scheduler queue")
_M_SUBMIT = _om.counter("pt_server_requests_submitted_total",
                        "requests submitted (accepted or shed)")
_M_DONE = _om.counter("pt_server_requests_completed_total",
                      "requests that completed with output tokens")
_M_FAILED = _om.counter("pt_server_requests_failed_total",
                        "requests ending in a RequestFailure, by reason",
                        labels=("reason",))
_M_SHED = _om.counter("pt_server_shed_total",
                      "submits rejected at the queue-depth cap")
_M_DEADLINE = _om.counter("pt_server_deadline_cancels_total",
                          "requests cancelled past a deadline/queue wait")
_M_DEFER = _om.counter("pt_server_admit_deferred_total",
                       "admissions re-queued (paged block pool exhausted)")
_M_RETRY = _om.counter("pt_server_retries_total",
                       "transient-failure retry attempts")
_M_STEPFAIL = _om.counter("pt_server_step_failures_total",
                          "transient step/prefill/harvest failures")
_M_BREAKER = _om.gauge("pt_server_breaker_open",
                       "1 while the circuit breaker is open")
_M_LAT = _om.histogram("pt_server_request_latency_seconds",
                       "submit -> harvest wall time per completed request")
_M_TTFT = _om.histogram("pt_server_ttft_seconds",
                        "submit -> first token per completed request")
_M_OCC = _om.gauge("pt_server_slot_occupancy",
                   "fraction of decode slot-steps that emitted a token")
# the per-tenant lifecycle families (the front door, serving/frontend.py,
# sets the tenants; the Server owns the accounting)
_M_T_DONE = _om.counter("pt_server_tenant_completed_total",
                        "completed requests by tenant",
                        labels=("tenant",))
_M_T_FAILED = _om.counter("pt_server_tenant_failed_total",
                          "failed requests by tenant",
                          labels=("tenant",))
_M_T_SHED = _om.counter("pt_server_tenant_shed_total",
                        "submits shed at the global depth cap or the "
                        "tenant queue quota, by tenant",
                        labels=("tenant",))
_M_T_PREEMPT = _om.counter("pt_server_tenant_preemptions_total",
                           "priority preemptions (slot evicted "
                           "mid-flight) by victim tenant",
                           labels=("tenant",))
_M_T_LAT = _om.histogram("pt_server_tenant_request_latency_seconds",
                         "submit -> harvest wall time per completed "
                         "request, by tenant", labels=("tenant",))
_M_T_TTFT = _om.histogram("pt_server_tenant_ttft_seconds",
                          "submit -> first token per completed "
                          "request, by tenant", labels=("tenant",))
_M_PREEMPT = _om.counter("pt_server_preemptions_total",
                         "slots evicted mid-flight for higher-priority "
                         "work (preempt/resume are span events, never "
                         "request terminals)")
_M_RESUMED = _om.counter("pt_server_resumes_total",
                         "preempted requests re-admitted via history "
                         "re-prefill")


class Server:
    """Continuous-batching server over an engine. ``submit()`` requests
    (optionally with future ``arrival_step`` ticks and per-request
    deadlines), then ``run_until_idle()``: ``results[rid]`` is prompt +
    generated ids, rows that hit eos padded with eos to
    ``max_new_tokens``, or a :class:`RequestFailure`.

    ``preemption=True`` (or ``PT_SERVING_PREEMPTION=1`` when the
    argument is None) arms priority preemption; it needs a
    priority-aware scheduler (``FairScheduler``): an explicit request
    over a FIFO scheduler is refused, the env knob, weaker than an
    explicit argument, then leaves it off, as in JAX."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 scheduler: Optional[Scheduler] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 observability: Optional[ObservabilityConfig] = None,
                 preemption: Optional[bool] = None):
        self.engine = engine
        self.scheduler = scheduler or Scheduler()
        self.resilience = resilience or ResilienceConfig()
        env_armed = preemption is None
        if env_armed:
            preemption = env_bool("PT_SERVING_PREEMPTION")
        if preemption and not getattr(self.scheduler, "priority_aware",
                                      False):
            # a FIFO scheduler hands the freed slot straight back to the
            # front-inserted victim: eviction churn instead of lower TTFT
            if env_armed:
                preemption = False
            else:
                raise ValueError(
                    "preemption=True needs a priority-aware scheduler "
                    "(serving.frontend.FairScheduler): the FIFO "
                    "scheduler would hand every freed slot back to the "
                    "evicted victim")
        if preemption and engine.tp_degree() > 1:
            # the sharded state's eviction path is unpinned in JAX;
            # refused loudly there and here, never run silently
            if env_armed:
                preemption = False
            else:
                raise NotImplementedError(
                    "priority preemption is not yet composed with "
                    "tensor-parallel engines — drop preemption= or "
                    "tp= (ROADMAP follow-up)")
        self.preemption = bool(preemption)
        self.preemptions = 0
        self.resumes = 0
        # per-tenant lifecycle accounting
        self.tenant_counts: Dict[str, Dict[str, int]] = {}
        self._tenant_of: Dict[int, str] = {}
        # token-stream hook: when set, called as sink(rid, tokens or
        # None, done, failure) from the harvest/fail paths and once per
        # tick for live runs
        self.stream_sink = None
        self._res = ResilienceState(self.resilience)
        engine.nan_sentinel = self.resilience.nan_sentinel
        # the breaker gauge tracks THIS server from birth
        _M_BREAKER.set(1 if self._res.breaker_open else 0)
        obs = observability or ObservabilityConfig()
        self.observability = obs
        self.tracer = RequestTracer(enabled=obs.trace_requests)
        self.flight = FlightRecorder(capacity=obs.flight_size,
                                     dump_dir=obs.flight_dump_dir)
        # the engine carries a tracer only when tracing is armed
        engine.tracer = self.tracer if self.tracer.enabled else None
        # layered state that rides snapshots: name -> zero-arg callable
        # returning a JSON-safe dict; a restored server surfaces the
        # saved dicts in ``restored_extras``
        self.snapshot_extras: Dict[str, object] = {}
        self.restored_extras: Dict[str, dict] = {}
        self.results: Dict[int, object] = {}
        self.latencies: Dict[int, float] = {}
        self.ttft: Dict[int, float] = {}       # submit -> first token
        self.tick_seconds: list = []           # per-tick wall times
        self._next_id = 0
        self._clock = 0
        self._wall = 0.0

    def submit(self, prompt, max_new_tokens: int = 20,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, eos_token_id: Optional[int] = None,
               seed: int = 0, arrival_step: int = 0,
               deadline_ticks: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tenant: str = "default", priority: int = 0) -> int:
        """Queue one request; returns its id (key into ``results``). A
        request that can never fit a slot or the block pool is rejected
        here with ValueError. With ``max_queue_depth`` set, a submit
        beyond the cap is shed: the id comes back with a
        ``RequestFailure(reason="shed")`` already recorded."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.engine.validate_request(int(prompt.size), max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        _M_SUBMIT.inc()
        self._tenant_of[rid] = tenant
        self._tcount(tenant)["submitted"] += 1
        self.tracer.start(rid)
        depth = self.resilience.max_queue_depth
        if depth is not None and self.scheduler.pending() >= depth:
            self._res.shed_requests += 1
            _M_SHED.inc()
            self.flight.record("shed", rid=rid, depth=depth)
            self._fail(rid, "shed",
                       f"queue depth at cap ({depth}); retry later")
            return rid
        quota = getattr(self.scheduler, "quota_exceeded", None)
        if quota is not None and quota(tenant):
            self._res.shed_requests += 1
            _M_SHED.inc()
            self.flight.record("shed", rid=rid, tenant=tenant)
            self._fail(rid, "shed",
                       f"tenant {tenant!r} queue quota exhausted; "
                       "retry later")
            return rid
        self.scheduler.submit(Request(
            request_id=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, seed=seed,
            arrival_step=arrival_step, t_submit=time.perf_counter(),
            deadline_ticks=deadline_ticks, deadline_s=deadline_s,
            tenant=tenant, priority=priority))
        _M_QUEUE.set(self.scheduler.pending())
        return rid

    def inject(self, req: Request):
        """Queue an externally constructed :class:`Request` under ITS
        OWN id (a resubmission whose id was assigned elsewhere). Door
        policies (shed) deliberately do not run: this is recovery, not
        new load."""
        self._tenant_of[req.request_id] = req.tenant
        self._tcount(req.tenant)["submitted"] += 1
        _M_SUBMIT.inc()
        self.tracer.start(req.request_id)
        self.scheduler.submit(req)
        _M_QUEUE.set(self.scheduler.pending())

    def _tcount(self, tenant: str) -> Dict[str, int]:
        c = self.tenant_counts.get(tenant)
        if c is None:
            c = {"submitted": 0, "completed": 0, "failed": 0,
                 "shed": 0, "preemptions": 0, "tokens": 0}
            self.tenant_counts[tenant] = c
        return c

    # -- failure plumbing --------------------------------------------------
    def _fail(self, rid: int, reason: str, message: str = "",
              tokens: int = 0):
        self.results[rid] = RequestFailure(
            request_id=rid, reason=reason, message=message,
            tokens_emitted=tokens)
        self._res.count_failure(reason)
        _M_FAILED.inc(reason=reason)
        tenant = self._tenant_of.get(rid, "default")
        tc = self._tcount(tenant)
        tc["failed"] += 1
        _M_T_FAILED.inc(tenant=tenant)
        if reason == "shed":
            tc["shed"] += 1
            _M_T_SHED.inc(tenant=tenant)
        if reason == "timeout":
            _M_DEADLINE.inc()
        self.flight.record("request_failed", rid=rid, reason=reason,
                           tokens=tokens)
        self.tracer.terminal(rid, reason, tokens=tokens)
        if self.stream_sink is not None:
            self.stream_sink(rid, None, True, reason)

    def _deadline_hit(self, req: Request, now: float) -> bool:
        cfg = self.resilience
        dt = req.deadline_ticks if req.deadline_ticks is not None \
            else cfg.deadline_ticks
        if dt is not None and self._clock - req.arrival_step > dt:
            return True
        ds = req.deadline_s if req.deadline_s is not None \
            else cfg.deadline_s
        return ds is not None and now - req.t_submit > ds

    def _expire(self):
        """Cancel queued and in-flight requests past their deadline (and
        queued ones past the max queue wait). In-flight cancellation
        goes through ``engine.cancel_slot``: the slot is killed on the
        device and paged blocks release at correct refcounts; the
        failure surfaces through the normal harvest."""
        now = time.perf_counter()
        mw = self.resilience.max_queue_wait_ticks

        def queued_out(r):
            base = r.arrival_step if r.wait_from is None else r.wait_from
            if mw is not None and self._clock - base > mw:
                return True
            return self._deadline_hit(r, now)

        for r in self.scheduler.drop_where(queued_out):
            self._fail(r.request_id, "timeout",
                       f"expired in queue at tick {self._clock}")
        for slot, run in self.engine.live_runs():
            if self._deadline_hit(run.request, now):
                self.engine.cancel_slot(slot, "timeout")

    def _with_retry(self, fn) -> bool:
        """Run ``fn`` with the transient-failure policy: seeded
        exponential backoff between attempts; every failed attempt
        counts toward the consecutive-failure budget that opens the
        circuit breaker. Returns False if ``fn`` never succeeded."""
        res, cfg = self._res, self.resilience
        for attempt in range(cfg.retry_attempts + 1):
            if res.breaker_open:
                return False
            try:
                fn()
                res.consecutive_failures = 0
                return True
            except res.transient as e:
                res.step_failures += 1
                res.consecutive_failures += 1
                res.last_error = f"{type(e).__name__}: {e}"
                _M_STEPFAIL.inc()
                self.flight.record(
                    "step_failure", error=res.last_error[:200],
                    consecutive=res.consecutive_failures,
                    clock=self._clock)
                if res.consecutive_failures >= cfg.breaker_threshold:
                    res.breaker_open = True
                    _M_BREAKER.set(1)
                    self.flight.record("breaker_open", clock=self._clock,
                                       after=res.consecutive_failures)
                    self.tracer.server_instant(
                        "breaker_open", clock=self._clock)
                    return False
                if attempt < cfg.retry_attempts:
                    res.retries += 1
                    _M_RETRY.inc()
                    backoff = res.backoff_s(attempt)
                    self.flight.record("retry", attempt=attempt,
                                       backoff_s=round(backoff, 6),
                                       clock=self._clock)
                    self.tracer.server_instant("retry", attempt=attempt,
                                               clock=self._clock)
                    time.sleep(backoff)
        return False

    def _quarantine_all(self, reason: str):
        """Circuit-breaker drain: cancel every in-flight request and
        fail everything still queued."""
        for slot, _ in self.engine.live_runs():
            self.engine.cancel_slot(slot, reason)
        for r in self.scheduler.drop_where(lambda r: True):
            self._fail(r.request_id, reason,
                       "circuit breaker open: queue drained")

    # -- priority preemption -----------------------------------------------
    def _preempt_victim(self, below: int) -> bool:
        """Evict ONE live run with priority strictly under ``below``:
        lowest priority first, then fewest generated tokens (least
        re-prefill lost), then highest slot. Only resumable victims
        (``engine.can_resume``) qualify. False when none does."""
        cands = [(run.request.priority, len(run.tokens), -slot, slot, run)
                 for slot, run in self.engine.live_runs()
                 if run.request.priority < below
                 and self.engine.can_resume(run)]
        if not cands:
            return False
        *_, slot, run = min(cands, key=lambda c: c[:3])
        self._do_preempt(slot, run)
        return True

    def _do_preempt(self, slot: int, run):
        """Evict through the engine, attach the carried stream to the
        request and requeue it at the front of its arrival tick. The
        request stays open: preempt and resume are span events on its
        trace, never terminals."""
        req = run.request
        _, key = self.engine.preempt_slot(slot)
        if key is not None:          # was decoding: carry the stream
            req.resume = ResumeState(tokens=list(run.tokens),
                                     key=np.asarray(key, np.uint32),
                                     t_admit=run.t_admit)
        # else mid-prefill: a fresh victim requeues as submitted, one
        # mid-resume-prefill keeps its resume state
        req.wait_from = self._clock      # queue wait restarts here
        self.scheduler.requeue(req)
        self.tracer.span_begin(req.request_id, "queue_wait", requeued=True)
        self.preemptions += 1
        tenant = req.tenant
        self._tcount(tenant)["preemptions"] += 1
        _M_PREEMPT.inc()
        _M_T_PREEMPT.inc(tenant=tenant)
        self.flight.record("preempt", rid=req.request_id, slot=slot,
                           tokens=len(run.tokens), clock=self._clock)

    def _preempt_for_priority(self):
        """Admission-side preemption: walk the visible queue from the
        highest priority down; each request that would otherwise wait on
        a full pool evicts one strictly lower-priority victim. The
        scheduler's pop then hands out the freed slots. Runs only when
        the batching gate would release work (probed with one free
        slot): evicting into a held gate idles the slot."""
        gate = getattr(self.scheduler, "_gate_visible", None)
        if gate is not None and gate(self._clock, 1,
                                     not self.engine.has_live(),
                                     None) is None:
            return
        vis = self.scheduler.visible(self._clock)
        if not vis:
            return
        free = self.engine.free_slot_count()
        if free >= len(vis):
            return          # every waiter gets a slot without eviction
        runs = self.engine.live_runs()
        if not runs or min(r.request.priority for _, r in runs) >= \
                max(r.priority for r in vis):
            return          # nothing waiting outranks anything running
        for req in sorted(vis, key=lambda r: -r.priority):
            if free > 0:
                free -= 1            # a free slot serves this request
                continue
            if not self._preempt_victim(below=req.priority):
                break    # nothing evictable at this (or any lower) tier

    # -- the tick ----------------------------------------------------------
    def _tick(self):
        self._expire()
        if self.preemption and not self.engine.has_pending_harvest():
            # only at a clean block boundary: a dispatched block awaiting
            # a harvest retry lands before any eviction
            self._preempt_for_priority()
        admitted = self.scheduler.pop_ready(
            self._clock, self.engine.free_slot_count(),
            engine_idle=not self.engine.has_live())
        for i, req in enumerate(admitted):
            resumed = req.resume is not None
            ok = self.engine.try_admit(req)
            while not ok and self.preemption and \
                    not self.engine.has_pending_harvest() and \
                    self._preempt_victim(below=req.priority):
                # paged: the block pool, not the slots, was the limit
                ok = self.engine.try_admit(req)
            if ok:
                if resumed:
                    self.resumes += 1
                    _M_RESUMED.inc()
                continue
            # re-queue in reverse: requeue() front-inserts per arrival
            # tick, so forward order would flip same-tick FIFO
            _M_DEFER.inc(len(admitted) - i)
            self.flight.record("block_pool_defer", rid=req.request_id,
                               clock=self._clock,
                               deferred=len(admitted) - i)
            for r in reversed(admitted[i:]):
                self.scheduler.requeue(r)
            break
        prefill_tick = getattr(self.engine, "prefill_tick", None)
        if prefill_tick is not None:
            # chunks dispatched before a mid-loop fault keep their
            # cursors, so a retry gets only the UNSPENT part of the
            # tick's budget
            budget = self.scheduler.prefill_token_budget
            spent = [0]

            def _prefill():
                b = None if budget is None else budget - spent[0]
                if b is not None and b <= 0 and spent[0] > 0:
                    return           # budget already consumed this tick
                # spend from the engine counter, not the return value: a
                # fault raises out of prefill_tick after some chunks ran
                before = self.engine.prefilled_tokens
                try:
                    prefill_tick(b)
                finally:
                    spent[0] += self.engine.prefilled_tokens - before

            self._with_retry(_prefill)
        if self.engine.has_decoding() or \
                self.engine.has_pending_harvest():
            self._with_retry(self.engine.step_block)

    def _harvest(self):
        now = time.perf_counter()
        for run in self.engine.drain_finished():
            req = run.request
            if run.failure is not None:
                self._fail(req.request_id, run.failure,
                           f"cancelled after {len(run.tokens)} tokens",
                           tokens=len(run.tokens))
                continue
            toks = np.asarray(run.tokens, np.int32)
            if len(toks) < req.max_new_tokens:
                # retired early at eos: pad to max_new (generate parity)
                toks = np.concatenate([toks, np.full(
                    (req.max_new_tokens - len(toks),), req.eos_token_id,
                    np.int32)])
            self.results[req.request_id] = np.concatenate(
                [np.asarray(req.prompt, np.int32).reshape(-1), toks])
            self.latencies[req.request_id] = now - req.t_submit
            self.ttft[req.request_id] = run.t_admit - req.t_submit
            _M_DONE.inc()
            _M_LAT.observe(self.latencies[req.request_id])
            _M_TTFT.observe(self.ttft[req.request_id])
            tenant = req.tenant
            tc = self._tcount(tenant)
            tc["completed"] += 1
            tc["tokens"] += len(run.tokens)
            _M_T_DONE.inc(tenant=tenant)
            _M_T_LAT.observe(self.latencies[req.request_id], tenant=tenant)
            _M_T_TTFT.observe(self.ttft[req.request_id], tenant=tenant)
            self.tracer.instant(req.request_id, "harvest",
                                tokens=len(run.tokens))
            self.tracer.terminal(req.request_id, "completed",
                                 tokens=len(run.tokens))
            if self.stream_sink is not None:
                self.stream_sink(req.request_id, run.tokens, True, None)

    def run_until_idle(self, max_ticks: Optional[int] = None
                       ) -> Dict[int, object]:
        """Drive the loop until the queue is empty and every slot is
        free (or ``max_ticks`` ticks ran: the kill point for
        snapshot/restore and a hang bound for chaos schedules); returns
        ``results``. A tick that trips the ``server.tick`` fault site is
        counted and skipped (requests stay queued; nothing is lost)."""
        t0 = time.perf_counter()
        ticks = 0
        while self.scheduler.pending() or self.engine.has_live():
            if max_ticks is not None and ticks >= max_ticks:
                break
            if self._res.breaker_open:   # incl. restored-open circuits
                self._circuit_open_drain()
                break
            t_tick = time.perf_counter()
            t_tick_us = now_us() if self.tracer.enabled else 0.0
            try:
                faults.fault_point("server.tick")
                self._tick()
            except faults.InjectedFault:
                self._res.tick_faults += 1
                self.flight.record("tick_fault", clock=self._clock)
            self._clock += 1
            ticks += 1
            self._harvest()
            self._drain_live_streams()
            tick_s = time.perf_counter() - t_tick
            self.tick_seconds.append(tick_s)
            self.tracer.server_span_at("tick", t_tick_us,
                                       clock=self._clock - 1)
            _M_TICKS.inc()
            _M_TICK_S.observe(tick_s)
            _M_QUEUE.set(self.scheduler.pending())
            _M_OCC.set(self.engine.occupancy())
            self.flight.record(
                "tick", clock=self._clock - 1,
                queue=self.scheduler.pending(),
                live=len(self.engine.live_runs()),
                tokens=self.engine.tokens_emitted,
                tick_ms=round(tick_s * 1000, 3))
            if self._res.breaker_open:
                self._circuit_open_drain()
                break
        self._wall += time.perf_counter() - t0
        return self.results

    def _drain_live_streams(self):
        """After each tick's harvest, in-flight runs' tokens flow to the
        stream sink (token visibility granularity is the decode
        block)."""
        if self.stream_sink is None:
            return
        for _slot, run in self.engine.live_runs():
            if run.tokens:
                self.stream_sink(run.request.request_id, run.tokens,
                                 False, None)

    def _circuit_open_drain(self):
        """Breaker-open endgame: dump the flight recorder, then drain
        and account every in-flight/queued request as
        ``circuit_open``."""
        self.flight.record("circuit_open_drain", clock=self._clock,
                           queue=self.scheduler.pending(),
                           live=len(self.engine.live_runs()))
        _M_BREAKER.set(1)
        try:
            self.flight.dump(reason="circuit_open")
        except OSError as e:             # diagnostics must never block
            self.flight.record("flight_dump_failed",  # the drain
                               error=f"{type(e).__name__}: {e}"[:200])
        self._quarantine_all("circuit_open")
        self._harvest()

    def stats(self) -> dict:
        """Host-clock serving figures of the runs so far, with the
        resilience counters and the per-tenant breakdown. On the GPU
        every time includes the device work: each decode block and each
        finished prefill ends in a host sync."""
        eng = self.engine
        lat = list(self.latencies.values())
        ttft = list(self.ttft.values())
        ticks = self.tick_seconds
        completed = sum(1 for v in self.results.values()
                        if not isinstance(v, RequestFailure))
        out = {
            "requests_completed": completed,
            "tokens_emitted": eng.tokens_emitted,
            "decode_steps": eng.steps,
            "decode_tokens": eng.decode_tokens,
            "slot_occupancy": eng.occupancy(),
            "wall_s": self._wall,
            "tokens_per_sec": eng.tokens_emitted / self._wall
            if self._wall else 0.0,
            "decode_tokens_per_sec": eng.decode_tokens / eng.decode_s
            if eng.decode_s else 0.0,
            "decode_step_ms": 1e3 * eng.decode_s / eng.steps
            if eng.steps else 0.0,
            "decode_compile_count": eng.decode_compile_count(),
            "latency_avg_s": float(np.mean(lat)) if lat else 0.0,
            "latency_p95_s": float(np.percentile(lat, 95)) if lat else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "max_tick_s": max(ticks) if ticks else 0.0,
            "p95_tick_s": float(np.percentile(ticks, 95)) if ticks else 0.0,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "tenants": {t: dict(c)
                        for t, c in sorted(self.tenant_counts.items())},
        }
        out.update(self._res.counters())
        if eng.tp_degree() > 1:                # tensor-parallel extras
            out["tp_degree"] = eng.tp_degree()
        hit_rate = getattr(eng, "prefix_cache_hit_rate", None)
        if hit_rate is not None:               # paged engine extras
            out["prefix_cache_hit_rate"] = hit_rate()
            out["kv_bytes_per_slot"] = eng.backend.kv_bytes_per_slot()
            out["prefill_chunks"] = eng.prefill_chunks
            out["prefill_s"] = eng.prefill_s
        return out

    def export_trace(self, path: str, profiler=None) -> str:
        """Write the served stream as ONE Perfetto-loadable chrome-trace
        JSON: this server's request rows and tick markers, merged (on
        the same clock) with the profiler's ``RecordEvent`` host spans
        when a :class:`~paddle_tpu_torch.profiler.Profiler` is passed
        (drained destructively, like its own export)."""
        return export_chrome_trace(path, tracer=self.tracer,
                                   profiler=profiler)

    # -- crash-safe snapshot / restore -------------------------------------
    def snapshot(self, path: str):
        """Write server + engine state as ONE atomic npz: queue,
        results, clocks, resilience counters, and the engine's full
        device (copied to the host) and host state. Taken between ticks
        (the engine refuses a pending harvest)."""
        meta, arrays = self.engine.snapshot_state()
        res_meta = {}
        for rid, v in self.results.items():
            if isinstance(v, RequestFailure):
                res_meta[str(rid)] = {
                    "kind": "failure", "reason": v.reason,
                    "message": v.message,
                    "tokens_emitted": v.tokens_emitted}
            else:
                res_meta[str(rid)] = {"kind": "ok"}
                arrays[f"res_{rid}"] = np.asarray(v, np.int32)
        # a direct read: a scheduler without a _queue list must fail the
        # snapshot loudly, not serialize an empty queue
        queue = list(self.scheduler._queue)
        qmeta = []
        for i, r in enumerate(queue):
            arrays[f"q{i}_prompt"] = np.asarray(r.prompt,
                                                np.int32).reshape(-1)
            qmeta.append(request_to_meta(r))
        # recorded BEFORE the ring is captured, so the restored server's
        # history and the dump beside the snapshot agree on it
        self.flight.record("snapshot", path=path, clock=self._clock)
        smeta = {
            "next_id": self._next_id, "clock": self._clock,
            "wall": self._wall,
            "latencies": {str(k): v for k, v in self.latencies.items()},
            "ttft": {str(k): v for k, v in self.ttft.items()},
            "results": res_meta, "queue": qmeta,
            "counters": self._res.counters(),
            "preemption_enabled": self.preemption,
            "preemptions": self.preemptions,
            "resumes": self.resumes,
            "tenant_counts": self.tenant_counts,
            "tenant_of": {str(k): v for k, v in self._tenant_of.items()},
            "flight": self.flight.to_meta(),
            "extras": {name: fn()
                       for name, fn in self.snapshot_extras.items()},
        }
        self.flight.dump(path + ".flight.json", reason="snapshot")
        save_snapshot(path, {"engine": meta, "server": smeta}, arrays)

    @classmethod
    def restore(cls, path: str, engine: ContinuousBatchingEngine,
                scheduler: Optional[Scheduler] = None,
                resilience: Optional[ResilienceConfig] = None,
                observability: Optional[ObservabilityConfig] = None,
                preemption: Optional[bool] = None) -> "Server":
        """Rebuild a server from a snapshot into a freshly constructed
        engine of the same configuration (a process restart: its CUDA
        graphs are captured anew, the state is copied into the tensors
        they read) — then ``run_until_idle()`` finishes every stream
        token-identical to the uninterrupted run. Pass the original
        ``observability`` config to keep tracing armed and the flight
        ring at its configured capacity."""
        meta, arrays = load_snapshot(path)
        engine.restore_state(meta["engine"], arrays)
        sm = meta["server"]
        if preemption is None:   # the saved policy survives by default
            preemption = sm.get("preemption_enabled")
        srv = cls(engine, scheduler, resilience, observability,
                  preemption=preemption)
        srv._next_id = sm["next_id"]
        srv._clock = sm["clock"]
        srv._wall = sm["wall"]
        srv.latencies = {int(k): v for k, v in sm["latencies"].items()}
        srv.ttft = {int(k): v for k, v in sm["ttft"].items()}
        for rid_s, info in sm["results"].items():
            rid = int(rid_s)
            if info["kind"] == "ok":
                srv.results[rid] = np.asarray(arrays[f"res_{rid}"],
                                              np.int32)
            else:
                srv.results[rid] = RequestFailure(
                    request_id=rid, reason=info["reason"],
                    message=info["message"],
                    tokens_emitted=info["tokens_emitted"])
        # the resilience runtime state (failure counts, retry budget,
        # breaker) survives: an open circuit stays open
        srv._res.restore_counters(sm["counters"])
        srv.preemptions = sm["preemptions"]
        srv.resumes = sm["resumes"]
        srv.tenant_counts = {t: dict(c)
                             for t, c in sm["tenant_counts"].items()}
        srv._tenant_of = {int(k): v for k, v in sm["tenant_of"].items()}
        srv.restored_extras = dict(sm["extras"])
        _M_BREAKER.set(1 if srv._res.breaker_open else 0)
        srv.flight.restore_meta(sm["flight"])
        srv.flight.record("restored", path=path, clock=srv._clock)
        # re-submit in saved order: insort is stable, so same-tick FIFO
        # order survives; carried-over requests (re)enter the tracer
        for i, rm in enumerate(sm["queue"]):
            req = request_from_meta(rm, arrays[f"q{i}_prompt"])
            srv.scheduler.submit(req)
            srv.tracer.start(req.request_id)
        for slot, run in engine.live_runs():
            rid = run.request.request_id
            srv.tracer.start(rid)
            srv.tracer.span_end(rid, "queue_wait", restored=True)
            # mid-prefill paged slots re-open this span at
            # _finish_prefill; decoding slots simply resume it
            srv.tracer.span_begin(rid, "decode", slot=slot,
                                  restored=True)
        return srv
