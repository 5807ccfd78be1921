"""Deterministic open-loop trace-driven load generation: the port's own
copy of ``paddle_tpu/serving/loadgen.py`` (numpy only), built on the
port's :class:`~paddle_tpu_torch.serving.scheduler.Request`.

Realistic serving traffic is not a fixed request list: arrivals are
Poisson, the rate breathes with a diurnal cycle and spikes in bursts,
prompt/output lengths are heavy-tailed, tenants and priorities mix, and
a large fraction of prompts share a system prefix. This module
materializes such traffic UP FRONT as a replayable schedule:
``generate_trace(TraceConfig(...))`` returns a :class:`Trace` whose
requests are fully built requests pinned to submit ticks. Every
stochastic component (arrivals, lengths, tenant/priority mix, prompt
content, burst windows) draws from its OWN seeded
``np.random.RandomState((seed, i))`` stream, so adding a component never
shifts another's sequence and the same config replays byte-identically.
A trace serializes to the JSON of the JAX package
(:meth:`Trace.to_json`, ``pt-loadgen-trace`` v1): the same config gives
the same string in both packages.

Open-loop means arrivals do not wait for completions: the schedule says
WHEN each request submits, the serving stack says how it copes. The
:func:`replay` driver walks the tick clock, submitting due requests and
ticking the serving loop — the same traffic against a fleet or a single
``Server``.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .scheduler import Request

__all__ = ["TraceConfig", "Trace", "generate_trace", "replay"]

# per-component rng stream ids (the faults.py idiom: one stream each,
# so adding a component never shifts another's sequence)
_S_ARRIVALS, _S_LENGTHS, _S_MIX, _S_CONTENT, _S_BURSTS = range(5)


def _bounded_pareto(rng: np.random.RandomState, alpha: float,
                    lo: int, hi: int) -> int:
    """Inverse-CDF sample of a bounded Pareto(alpha) on [lo, hi] —
    heavy-tailed like real prompt/output lengths, but never past the
    engine's validated capacity."""
    if lo >= hi:
        return lo
    u = float(rng.random_sample())
    la, ha = lo ** -alpha, hi ** -alpha
    x = (la - u * (la - ha)) ** (-1.0 / alpha)
    return int(min(hi, max(lo, round(x))))


def _weighted_pick(rng: np.random.RandomState, items: List,
                   weights: List[float]):
    total = float(sum(weights))
    u = float(rng.random_sample()) * total
    acc = 0.0
    for it, w in zip(items, weights):
        acc += w
        if u < acc:
            return it
    return items[-1]


@dataclass
class TraceConfig:
    """Workload shape knobs. Every field is JSON-serializable so the
    config rides the trace artifact.

    - ``base_rate``: mean arrivals per tick before modulation.
    - ``diurnal_period`` / ``diurnal_amplitude``: sinusoidal rate
      cycle (period in ticks; 0 disables). Rate swings between
      ``base*(1-a)`` and ``base*(1+a)``.
    - ``bursts`` / ``burst_mult`` / ``burst_len``: seeded burst
      episodes — each picks a start tick and a length in
      ``burst_len`` and multiplies the arrival rate by ``burst_mult``
      inside the window.
    - ``prompt_*`` / ``output_*``: bounded-Pareto length
      distributions (alpha, lo, hi).
    - ``tenants`` / ``priority_weights``: weighted mixes.
    - ``shared_fraction`` / ``shared_len`` / ``shared_prompts``: the
      fraction of prompts carrying one of N shared system prefixes
      (the prefix tier's reuse signal).
    - ``sampled_fraction``: fraction of requests decoded with seeded
      sampling instead of greedy (temperature/top_k below).
    """
    seed: int = 0
    horizon: int = 120                   # submit window, in ticks
    base_rate: float = 0.25
    diurnal_period: int = 0
    diurnal_amplitude: float = 0.5
    bursts: int = 0
    burst_mult: float = 4.0
    burst_len: Tuple[int, int] = (10, 25)
    prompt_alpha: float = 1.5
    prompt_lo: int = 4
    prompt_hi: int = 24
    output_alpha: float = 1.2
    output_lo: int = 4
    output_hi: int = 24
    vocab_size: int = 512
    tenants: Dict[str, float] = field(
        default_factory=lambda: {"default": 1.0})
    priority_weights: Dict[int, float] = field(
        default_factory=lambda: {0: 1.0})
    shared_fraction: float = 0.0
    shared_len: int = 16
    shared_prompts: int = 1
    sampled_fraction: float = 0.0
    temperature: float = 0.9
    top_k: int = 40

    def to_dict(self) -> dict:
        return {
            "seed": self.seed, "horizon": self.horizon,
            "base_rate": self.base_rate,
            "diurnal_period": self.diurnal_period,
            "diurnal_amplitude": self.diurnal_amplitude,
            "bursts": self.bursts, "burst_mult": self.burst_mult,
            "burst_len": list(self.burst_len),
            "prompt_alpha": self.prompt_alpha,
            "prompt_lo": self.prompt_lo, "prompt_hi": self.prompt_hi,
            "output_alpha": self.output_alpha,
            "output_lo": self.output_lo, "output_hi": self.output_hi,
            "vocab_size": self.vocab_size,
            "tenants": dict(self.tenants),
            "priority_weights": {str(k): v for k, v
                                 in self.priority_weights.items()},
            "shared_fraction": self.shared_fraction,
            "shared_len": self.shared_len,
            "shared_prompts": self.shared_prompts,
            "sampled_fraction": self.sampled_fraction,
            "temperature": self.temperature, "top_k": self.top_k}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceConfig":
        d = dict(d)
        d["burst_len"] = tuple(d.get("burst_len", (10, 25)))
        d["priority_weights"] = {int(k): v for k, v in
                                 d.get("priority_weights",
                                       {"0": 1.0}).items()}
        return cls(**d)


class Trace:
    """A materialized schedule: requests pinned to submit ticks.
    ``requests[i].request_id`` is the TRACE-LOCAL id ``i`` — the
    serving stack assigns its own ids at submit; :func:`replay`
    returns the mapping."""

    def __init__(self, config: TraceConfig, requests: List[Request],
                 burst_windows: List[Tuple[int, int]]):
        self.config = config
        self.requests = requests
        self.burst_windows = burst_windows

    def schedule(self) -> List[Tuple[int, Request]]:
        return [(r.arrival_step, r) for r in self.requests]

    def __len__(self):
        return len(self.requests)

    def stats(self) -> dict:
        """Workload summary (counts and means of the schedule)."""
        if not self.requests:
            return {"requests": 0}
        plens = [int(r.prompt.size) for r in self.requests]
        olens = [r.max_new_tokens for r in self.requests]
        # shared-prefix reuse: requests whose leading shared_len tokens
        # coincide with at least one other request's
        heads: Dict[Tuple[int, ...], int] = {}
        for r in self.requests:
            h = tuple(int(t) for t in r.prompt[:self.config.shared_len])
            heads[h] = heads.get(h, 0) + 1
        return {
            "requests": len(self.requests),
            "horizon": self.config.horizon,
            "burst_windows": [list(w) for w in self.burst_windows],
            "prompt_len_mean": round(float(np.mean(plens)), 2),
            "prompt_len_max": int(max(plens)),
            "output_len_mean": round(float(np.mean(olens)), 2),
            "shared_prefix": sum(n for n in heads.values() if n > 1),
            "sampled": sum(1 for r in self.requests
                           if r.temperature > 0.0),
        }

    # -- JSON round trip ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "format": "pt-loadgen-trace", "version": 1,
            "config": self.config.to_dict(),
            "burst_windows": [list(w) for w in self.burst_windows],
            "requests": [{
                "id": r.request_id, "t": r.arrival_step,
                "prompt": [int(t) for t in r.prompt],
                "max_new_tokens": r.max_new_tokens,
                "temperature": r.temperature, "top_k": r.top_k,
                "seed": r.seed, "tenant": r.tenant,
                "priority": r.priority,
            } for r in self.requests]}, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Trace":
        d = json.loads(s)
        if d.get("format") != "pt-loadgen-trace":
            raise ValueError("not a loadgen trace")
        reqs = [Request(
            request_id=r["id"],
            prompt=np.asarray(r["prompt"], np.int32),
            max_new_tokens=r["max_new_tokens"],
            temperature=r["temperature"], top_k=r["top_k"],
            seed=r["seed"], arrival_step=r["t"],
            tenant=r["tenant"], priority=r["priority"])
            for r in d["requests"]]
        return cls(TraceConfig.from_dict(d["config"]), reqs,
                   [tuple(w) for w in d.get("burst_windows", [])])


def generate_trace(config: TraceConfig) -> Trace:
    """Materialize the full schedule for ``config`` — same config,
    same trace, byte-for-byte (JSON-equality pinned)."""
    cfg = config
    arrivals = np.random.RandomState((cfg.seed, _S_ARRIVALS))
    lengths = np.random.RandomState((cfg.seed, _S_LENGTHS))
    mix = np.random.RandomState((cfg.seed, _S_MIX))
    content = np.random.RandomState((cfg.seed, _S_CONTENT))
    bursts = np.random.RandomState((cfg.seed, _S_BURSTS))

    windows: List[Tuple[int, int]] = []
    for _ in range(cfg.bursts):
        start = int(bursts.randint(0, max(1, cfg.horizon)))
        length = int(bursts.randint(cfg.burst_len[0],
                                    cfg.burst_len[1] + 1))
        windows.append((start, min(cfg.horizon, start + length)))

    shared = [content.randint(0, cfg.vocab_size,
                              (cfg.shared_len,)).astype(np.int32)
              for _ in range(max(1, cfg.shared_prompts))]
    t_names = sorted(cfg.tenants)
    t_weights = [cfg.tenants[n] for n in t_names]
    p_vals = sorted(cfg.priority_weights)
    p_weights = [cfg.priority_weights[p] for p in p_vals]

    def rate(t: int) -> float:
        r = cfg.base_rate
        if cfg.diurnal_period > 0:
            r *= 1.0 + cfg.diurnal_amplitude * math.sin(
                2.0 * math.pi * t / cfg.diurnal_period)
        if any(a <= t < b for a, b in windows):
            r *= cfg.burst_mult
        return max(0.0, r)

    requests: List[Request] = []
    rid = 0
    for t in range(cfg.horizon):
        for _ in range(int(arrivals.poisson(rate(t)))):
            plen = _bounded_pareto(lengths, cfg.prompt_alpha,
                                   cfg.prompt_lo, cfg.prompt_hi)
            olen = _bounded_pareto(lengths, cfg.output_alpha,
                                   cfg.output_lo, cfg.output_hi)
            tenant = _weighted_pick(mix, t_names, t_weights)
            priority = _weighted_pick(mix, p_vals, p_weights)
            # every mix draw happens unconditionally so changing one
            # fraction never shifts a later request's tenant/seed —
            # the same per-stream independence faults.py keeps
            is_shared = (float(mix.random_sample())
                         < cfg.shared_fraction)
            is_sampled = (float(mix.random_sample())
                          < cfg.sampled_fraction)
            spi = int(mix.randint(0, len(shared)))
            rseed = int(mix.randint(0, 2 ** 31))
            if is_shared:
                sp = shared[spi]
                tail_len = max(1, plen - int(sp.size))
                prompt = np.concatenate(
                    [sp, content.randint(
                        0, cfg.vocab_size,
                        (tail_len,)).astype(np.int32)])
            else:
                prompt = content.randint(
                    0, cfg.vocab_size, (plen,)).astype(np.int32)
            requests.append(Request(
                request_id=rid, prompt=prompt, max_new_tokens=olen,
                temperature=cfg.temperature if is_sampled else 0.0,
                top_k=cfg.top_k if is_sampled else 0,
                seed=rseed if is_sampled else 0,
                arrival_step=t, tenant=tenant, priority=priority))
            rid += 1
    return Trace(cfg, requests, windows)


def replay(trace: Trace, submit: Callable[[Request], int],
           tick: Callable[[], None], busy: Callable[[], bool],
           max_ticks: int = 5000,
           on_tick: Optional[Callable[[int], None]] = None
           ) -> Dict[int, int]:
    """Open-loop drive: walk the tick clock over the trace horizon,
    submitting each request at its pinned tick, then drain until
    ``busy()`` clears or ``max_ticks``. ``submit(req)`` returns the
    serving stack's id; the returned dict maps trace-local ids to
    them. ``on_tick(clock)`` runs after every tick (a control loop's
    evaluation hook)."""
    sched = sorted(trace.schedule(), key=lambda e: (e[0],
                                                    e[1].request_id))
    ids: Dict[int, int] = {}
    i, clock = 0, 0
    while clock < trace.config.horizon or (busy() and
                                           clock < max_ticks):
        while i < len(sched) and sched[i][0] <= clock:
            req = sched[i][1]
            ids[req.request_id] = submit(req)
            i += 1
        tick()
        clock += 1
        if on_tick is not None:
            on_tick(clock)
    return ids
