"""Serving loop: Scheduler + engine (dense or paged) + per-request
latency.

Counterpart of ``paddle_tpu/serving/server.py`` (``submit``/``_tick``/
``_harvest``/``run_until_idle``/``stats``). One iteration of the loop is
one tick of the engine-block clock: admit whatever the scheduler
releases into free slots (the dense engine prefills each at admission;
requests the paged engine defers for want of KV blocks re-queue),
advance the paged engine's chunked prefills within the scheduler's
prefill token budget, run one decode block, harvest retired requests.
Resilience, preemption, tracing, the flight recorder, the metrics
registry and snapshots come later."""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from .engine import ContinuousBatchingEngine
from .scheduler import Request, Scheduler

__all__ = ["Server"]


class Server:
    """Continuous-batching server over an engine. ``submit()`` requests,
    then ``run_until_idle()``: ``results[rid]`` is prompt + generated
    ids, rows that hit eos padded with eos to ``max_new_tokens``."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 scheduler: Optional[Scheduler] = None):
        self.engine = engine
        self.scheduler = scheduler or Scheduler()
        self.results: Dict[int, np.ndarray] = {}
        self.latencies: Dict[int, float] = {}
        self.ttft: Dict[int, float] = {}       # submit -> first token
        self.tick_seconds: list = []
        self._next_id = 0
        self._clock = 0
        self._wall = 0.0

    def submit(self, prompt, max_new_tokens: int = 20,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, eos_token_id: Optional[int] = None,
               seed: int = 0, arrival_step: int = 0) -> int:
        """Queue one request; returns its id (key into ``results``).
        A request that can never fit a slot or the block pool is
        rejected here with ValueError."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.engine.validate_request(int(prompt.size), max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self.scheduler.submit(Request(
            request_id=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, seed=seed,
            arrival_step=arrival_step, t_submit=time.perf_counter()))
        return rid

    def _tick(self):
        admitted = self.scheduler.pop_ready(
            self._clock, self.engine.free_slot_count(),
            engine_idle=not self.engine.has_live())
        for i, req in enumerate(admitted):
            if self.engine.try_admit(req):
                continue
            # re-queue in reverse: requeue() front-inserts per arrival
            # tick, so forward order would flip same-tick FIFO
            for r in reversed(admitted[i:]):
                self.scheduler.requeue(r)
            break
        prefill_tick = getattr(self.engine, "prefill_tick", None)
        if prefill_tick is not None:
            prefill_tick(self.scheduler.prefill_token_budget)
        if self.engine.has_decoding():
            self.engine.step_block()

    def _harvest(self):
        now = time.perf_counter()
        for run in self.engine.drain_finished():
            req = run.request
            if run.failure is not None:
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

    def run_until_idle(self, max_ticks: Optional[int] = None
                       ) -> Dict[int, np.ndarray]:
        """Drive the loop until the queue is empty and every slot is
        free (or ``max_ticks`` ticks ran); returns ``results``."""
        t0 = time.perf_counter()
        ticks = 0
        while self.scheduler.pending() or self.engine.has_live():
            if max_ticks is not None and ticks >= max_ticks:
                break
            t_tick = time.perf_counter()
            self._tick()
            self._clock += 1
            ticks += 1
            self._harvest()
            self.tick_seconds.append(time.perf_counter() - t_tick)
        self._wall += time.perf_counter() - t0
        return self.results

    def stats(self) -> dict:
        """Host-clock serving figures of the runs so far. On the GPU
        every figure includes the device work: each decode block and
        each finished prefill ends in a host sync."""
        eng = self.engine
        lat = list(self.latencies.values())
        ttft = list(self.ttft.values())
        out = {
            "requests_completed": len(self.results),
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
            "latency_avg_s": float(np.mean(lat)) if lat else 0.0,
            "latency_p95_s": float(np.percentile(lat, 95)) if lat else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else 0.0,
            "max_tick_s": max(self.tick_seconds)
            if self.tick_seconds else 0.0,
        }
        hit_rate = getattr(eng, "prefix_cache_hit_rate", None)
        if hit_rate is not None:               # paged engine extras
            out["prefix_cache_hit_rate"] = hit_rate()
            out["kv_bytes_per_slot"] = eng.backend.kv_bytes_per_slot()
            out["prefill_chunks"] = eng.prefill_chunks
            out["prefill_s"] = eng.prefill_s
        return out
