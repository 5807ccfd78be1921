"""Disaggregated prefill/decode serving fleet: prefill workers, decode
workers, KV-block handoff, prefix-affinity routing, the fleet-wide
prefix cache, failure redrive, live migration and the durable control
plane.

Counterpart of ``paddle_tpu/serving/fleet.py``. Prefill is compute-bound
and decode bandwidth-bound; at scale they want different hardware pools.
This module splits the Server into replicas of two specialties and a
router:

- **PrefillWorker**: a Server over a prefill-only engine
  (:class:`PrefillDenseEngine` / :class:`PrefillPagedEngine`). Prompts
  admit, (chunked-)prefill and sample their first token exactly as on a
  unified server — same programs, same key schedule — but a finished
  prefill parks in a handoff **outbox** instead of arming the slot. The
  slot and its arena blocks stay held until the payload ships, so a
  serialize/transport fault retries against live state. A prefill-only
  engine is built without a decode program: on the card it captures its
  prefill graph(s) and no decode graph.
- **KV handoff** (``serving.handoff``): the outbox entry serializes to a
  versioned, bytes-true payload, wire-compatible with the JAX package's:
  prompt-position KV blocks at storage dtype (int8 codes + scales ship
  quantized), the in-hand token, the post-split rng key (uint32 on the
  wire, int64 words in the port's slot state), the request.
- **DecodeWorker**: a Server over an ordinary engine. ``adopt()``
  allocates the request's blocks from its OWN BlockManager at exact
  refcounts, copies the shipped rows into its arena IN PLACE
  (``index_copy_``: the captured decode graph reads the arena, the block
  tables and the slot state by address, so nothing may be rebound),
  registers the prompt prefix in its own index, and arms the slot by
  writing its state in place — no new program on the decode path. Only
  the ``n_ship`` shipped blocks are written (the JAX adopt pads each
  payload to ``max_blocks`` to keep one jitted shape; decode-position
  blocks are written before they are read either way). A request
  prefilled on worker A and decoded on worker B streams token-identical
  to a single-replica Server (greedy and seeded sampled; dense, paged,
  paged + kv_int8).
- **FleetRouter**: chained-SHA1 prefix-hash affinity — the digest of a
  prompt's first full block (the key the BlockManager indexes it under)
  picks the prefill worker, so a shared system prompt lands where its
  registered blocks live. Queue-depth spillover diverts from a
  backlogged affinity target to the least-loaded worker.
- **Transport** (``serving.transport``): the in-process FIFO default or
  the localhost-TCP :class:`SocketTransport` (length-framed, CRC32,
  sequence-numbered, acked, reconnecting, at-least-once — ``adopt()``
  restores exactly-once by (rid, payload seq) dedup). Handoff failures
  ride the resilience machinery (``ResilienceState``: retry with seeded
  backoff, breaker); a permanent failure records an explicit
  ``RequestFailure(reason="handoff")``, an open circuit fails fast as
  ``circuit_open``.
- **Failure domains**: per-worker heartbeat leases (a worker missing N
  beats is DEAD, never read again) and REDRIVE of streams lost with a
  dead decode worker, rebuilt from the fleet's own records (submission
  + shipped key + heartbeat token progress, the key host-replayed one
  split per observed token), re-prefilled on a surviving prefill worker
  via a ``redrive`` ResumeState, completing identical to an unfailed
  run. A dead prefill worker's un-shipped requests resubmit under their
  original ids; unrecoverable streams fail as ``worker_lost``.
- **Fleet-wide prefix cache** (``serving.prefix_cache``): paged workers
  publish their registered digest chains with each heartbeat into a
  :class:`PrefixCacheDirectory`; on a prefill-admission miss where the
  directory holds a longer chain, the admitting worker FETCHES the
  covered blocks from the owner over the same transport (a
  ``pt-kv-fetch`` payload on the worker's ``#fetch`` side channel), and
  chunk-prefills only the uncovered suffix. Any fetch failure falls back
  to local prefill. Fleet-global block-pressure watermarks evict LRU
  unreferenced registered blocks.
- **Live migration / scale**: ``migrate_decode_worker`` (Server
  snapshot/restore into a fresh engine), ``add_decode_worker``,
  ``drain_*`` / ``remove_*`` (``serving.autoscaler`` drives them).
- **Durable control plane** (``serving.durability``, ``durability=<dir>``):
  every control-plane transition is appended to an fsync'd write-ahead
  journal, :meth:`Fleet.checkpoint` snapshots every live worker and
  commits a manifest, and :meth:`Fleet.recover` rebuilds a whole killed
  fleet from the directory — the newest manifest plus the journal's
  tail — and redrives every stream that was in flight, completing
  identical to a run that was never killed. The directory is the JAX
  package's format: either package recovers the other's. Watermark-
  evicted prefix chains spill to disk under it (``spill_max_bytes``)
  and are fetched back from there.

Every worker's engine may take the SAME model object: engines hold the
model by reference (the weight-only quantized backends, ``quant=``, hold
their own copy of the quantized linears), so one copy of the weights
serves the fleet.

Knobs (``utils.flags``): ``PT_SERVING_FLEET_AFFINITY`` (default on),
``PT_SERVING_FLEET_SPILL_DEPTH`` (default 8),
``PT_SERVING_FLEET_LEASE_MISSES`` (default 3),
``PT_SERVING_FLEET_PREFIX_CACHE`` (default on, paged fleets) and the
eviction watermarks ``PT_SERVING_FLEET_EVICT_HIGH`` / ``_LOW`` (default
0.85 / 0.70 of fleet-global block pressure).
"""
from __future__ import annotations

import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import random as prng
from ..observability import FlightRecorder
from ..observability import metrics as _om
from ..profiler import RecordEvent
from ..utils import faults
from ..utils.flags import env_bool, env_float, env_int
from .engine import (_M_PREFILLS, _M_TOKENS, ContinuousBatchingEngine,
                     ModelStepBackend, _arm_fn, _key_tensor, _SlotRun,
                     _to_host)
from .handoff import (KVHandoff, decode_handoff, encode_handoff,
                      leaf_to_wire, wire_to_tensor)
from .paging import PagedEngine, PagedModelStepBackend, _sha1_chain
from . import durability as _dur
from . import prefix_cache as _pc
from .prefix_cache import (PrefixCacheDirectory, adopt_prefix, copy_rows,
                           extract_prefix, gather_rows, leaf_specs)
from .resilience import (RequestFailure, ResilienceConfig,
                         ResilienceState, request_from_meta,
                         request_to_meta)
from .scheduler import Request, ResumeState
from .server import Server
from .transport import (InProcessTransport, SocketTransport, Transport,
                        TransportError, fetch_endpoint)

__all__ = ["DecodeWorker", "Fleet", "FleetRouter", "InProcessTransport",
           "PrefillDenseEngine", "PrefillPagedEngine", "PrefillWorker",
           "SocketTransport", "Transport", "TransportError"]

# fleet metric families (JAX's names; no-ops until metrics.enable() /
# PT_METRICS)
_M_HANDOFFS = _om.counter("pt_fleet_handoffs_total",
                          "KV handoff payloads adopted by decode "
                          "workers")
_M_HANDOFF_BYTES = _om.counter("pt_fleet_handoff_bytes_total",
                               "wire bytes of shipped handoff payloads")
_M_HANDOFF_FAILS = _om.counter(
    "pt_fleet_handoff_failures_total",
    "handoffs that permanently failed, by reason", labels=("reason",))
_M_FLEET_RETRIES = _om.counter("pt_fleet_retries_total",
                               "transient handoff-op retry attempts")
_M_ADOPT_DEFERS = _om.counter(
    "pt_fleet_adopt_defers_total",
    "adoptions deferred (decode slot/block pool momentarily full)")
_M_AFFINITY = _om.counter("pt_fleet_affinity_routes_total",
                          "submissions routed by prefix-hash affinity")
_M_SPILL = _om.counter("pt_fleet_spillovers_total",
                       "submissions diverted off their affinity worker "
                       "by queue-depth spillover")
_M_MIGRATIONS = _om.counter("pt_fleet_migrations_total",
                            "live worker migrations (snapshot/restore)")
_M_PF_DEPTH = _om.gauge("pt_fleet_prefill_queue_depth",
                        "queued requests per prefill worker",
                        labels=("worker",))
_M_DEC_FREE = _om.gauge("pt_fleet_decode_free_slots",
                        "free decode slots per decode worker",
                        labels=("worker",))
_M_WORKER_STATE = _om.gauge("pt_fleet_worker_state",
                            "per-worker lease state: 1 live, 0 dead",
                            labels=("worker",))
_M_WORKERS_LOST = _om.counter("pt_fleet_workers_lost_total",
                              "workers whose lease expired, by role",
                              labels=("role",))
_M_REDRIVES = _om.counter(
    "pt_fleet_redrives_total",
    "streams reconstructed from fleet records after a worker died")
_M_ADOPT_DUPS = _om.counter(
    "pt_fleet_adopt_duplicates_total",
    "adopt() calls deduplicated on (rid, payload seq) — the "
    "at-least-once wire's retransmits made idempotent")

#: phases of one handoff whose host wall time the fleet records
HANDOFF_PHASES = ("extract", "encode", "transport", "decode", "adopt")


def _replay_key(key0, n: int) -> np.ndarray:
    """Host replay of the decode block's per-slot key schedule: the
    in-graph step does ``key, sub = split(key)`` exactly once per emitted
    token, so a slot that produced ``n`` decode tokens after arming with
    ``key0`` holds ``split^n(key0)[0]`` — bit-equal to ``jax.random
    .split`` applied n times (the port's threefry). This is what makes a
    stream reconstructible from OBSERVED tokens alone."""
    k = torch.from_numpy(np.asarray(key0, np.uint32).reshape(2)
                         .astype(np.int64))
    for _ in range(n):
        k = prng.split(k)[0]
    return k.numpy().astype(np.uint32)


def _key_words(key: torch.Tensor) -> np.ndarray:
    """A slot key (int64 words, any device) as the wire's (2,) uint32."""
    return key.cpu().numpy().astype(np.uint32)


def _plain(v):
    """A submit keyword as plain JSON for the journal and the manifest:
    numpy scalars become Python ints and floats (``json`` refuses
    them)."""
    return v.item() if isinstance(v, np.generic) else v


def _stamp_resume_meta(meta: dict, ph: "_PendingHandoff"):
    """Redrive payloads carry the generated history: the decode worker
    arms with ``tokens[-1]`` and its run starts from the FULL token list.
    ``orig_prompt_len`` is recorded because ``arrays["prompt"]`` is then
    the re-prefilled ``prompt + tokens[:-1]`` sequence."""
    if ph.tokens is not None:
        meta["tokens"] = [int(t) for t in ph.tokens]
        meta["orig_prompt_len"] = int(ph.orig_len)


# ---------------------------------------------------------------------------
# prefill-only engines
# ---------------------------------------------------------------------------

@dataclass
class _PendingHandoff:
    """One finished prefill waiting to ship. The slot stays occupied (in
    ``_prefill_slots``, so it never decodes) and paged blocks stay
    referenced until the payload is on the wire."""
    run: _SlotRun
    slot: int
    prompt: np.ndarray                  # the PREFILLED token sequence
    tok0: int
    rem0: int
    key: np.ndarray                     # (2,) uint32 post-split key
    row: Optional[tuple] = None         # dense: the row's [:, :bucket]
    pad0: int = 0                       # dense: bucket pad count
    bucket: int = 0                     # dense: bucket length Lb
    # redrive resume: the carried generated history (tokens[-1] ==
    # tok0) and the ORIGINAL prompt length
    tokens: Optional[List[int]] = None
    orig_len: Optional[int] = None


class _PrefillEngineMixin:
    """Outbox plumbing shared by the dense and paged prefill engines."""

    _decodes = False          # a sharded backend builds no decode program

    def reset(self):
        super().reset()
        self._outbox: List[_PendingHandoff] = []

    def take_handoffs(self) -> List[_PendingHandoff]:
        """Drain ship-ready outbox entries; entries whose run was
        cancelled meanwhile (deadline expiry already released the slot
        and blocks) are dropped, not shipped."""
        live, self._outbox = self._outbox, []
        return [ph for ph in live
                if ph.run.failure is None
                and self._slots[ph.slot] is ph.run]

    def release_handoff(self, ph: _PendingHandoff):
        """Free everything a shipped (or permanently failed) handoff
        held on this worker: the slot and — paged — its arena blocks at
        exact refcounts (registered prefix blocks park in the LRU
        cache)."""
        self._prefill_slots.discard(ph.slot)
        if self._slots[ph.slot] is ph.run:
            self._slots[ph.slot] = None
        self._release_slot_resources(ph.run)

    def snapshot_state(self):
        """Un-shipped handoffs ride the snapshot: each live outbox entry
        serializes beside the engine state (its run is a live slot, so
        the base snapshot already carries the slot and blocks)."""
        meta, arrays = super().snapshot_state()
        ob_meta = []
        for ph in self._outbox:
            if ph.run.failure is not None \
                    or self._slots[ph.slot] is not ph.run:
                continue                    # cancelled — never ships
            k = len(ob_meta)
            arrays[f"ob{k}_prompt"] = np.asarray(ph.prompt, np.int32)
            arrays[f"ob{k}_key"] = np.asarray(ph.key, np.uint32)
            if ph.row is not None:
                for i, r in enumerate(ph.row):
                    arrays[f"ob{k}_row{i}"] = _to_host(r)
            ob_meta.append({
                "slot": int(ph.slot), "tok0": int(ph.tok0),
                "rem0": int(ph.rem0), "pad0": int(ph.pad0),
                "bucket": int(ph.bucket),
                "row": ph.row is not None,
                "tokens": None if ph.tokens is None
                else [int(t) for t in ph.tokens],
                "orig_len": None if ph.orig_len is None
                else int(ph.orig_len)})
        meta["outbox"] = ob_meta
        return meta, arrays

    def restore_state(self, meta, arrays):
        super().restore_state(meta, arrays)
        self._outbox = []
        leaves = self.backend.caches()
        dev = self.backend.device
        for k, e in enumerate(meta.get("outbox", ())):
            run = self._slots[e["slot"]]
            if run is None:
                continue
            row = None
            if e["row"]:
                # bf16 rows as JAX's npz |V2 words or the port's older
                # int16 bits
                row = tuple(wire_to_tensor(arrays[f"ob{k}_row{i}"],
                                           t.dtype, dev)
                            for i, t in enumerate(leaves))
            self._outbox.append(_PendingHandoff(
                run=run, slot=int(e["slot"]),
                prompt=np.asarray(arrays[f"ob{k}_prompt"], np.int32),
                tok0=int(e["tok0"]), rem0=int(e["rem0"]),
                key=np.asarray(arrays[f"ob{k}_key"], np.uint32),
                row=row, pad0=int(e["pad0"]), bucket=int(e["bucket"]),
                tokens=e["tokens"], orig_len=e["orig_len"]))


def _refuse_user_resume(request):
    resume = getattr(request, "resume", None)
    if resume is not None and resume.tokens and not resume.redrive:
        raise NotImplementedError(
            "prefill workers do not take preemption resumes — the fleet "
            "never preempts (route resumes to a unified Server)")
    return resume


class PrefillPagedEngine(_PrefillEngineMixin, PagedEngine):
    """Paged engine that prefills but never decodes: chunked prefill,
    prefix reuse and the block manager are inherited unchanged; a
    finished prefill parks in the handoff outbox with its blocks still
    referenced instead of arming the slot. Requests that finish AT
    prefill (eos on the first token, max_new == 1) complete here. Built
    without a decode program: on the card it captures its prefill chunk
    and nothing else (:meth:`decode_compile_count` 0)."""

    def _build_paged_backend(self, model, num_slots, max_len, decode_block,
                             block_size, num_blocks, prefill_chunk, kv_int8,
                             megakernel, quant):
        return PagedModelStepBackend(model, num_slots, max_len, decode_block,
                                     block_size, num_blocks, prefill_chunk,
                                     kv_int8, megakernel, quant,
                                     decode=False)

    def try_admit(self, request) -> bool:
        # a redrive resume rides the paged resume branch unchanged:
        # chunked re-prefill of prompt + tokens[:-1] (mostly prefix-index
        # hits), the carried key armed, the chunks' samples discarded
        _refuse_user_resume(request)
        return super().try_admit(request)

    #: fleet-installed hook ``fn(full_tokens, local_blocks) ->
    #: fetched_block_ids | None``: consult the fleet prefix directory and
    #: fetch the covered blocks a remote worker holds beyond the local
    #: match (``Fleet._fetch_prefix``). None outside a fleet.
    prefix_fetcher = None

    def _match_prefix_for_admission(self, full):
        shared = self.manager.match_prefix(full)
        if self.prefix_fetcher is not None:
            fetched = self.prefix_fetcher(full, shared)
            if fetched:
                # fetched blocks arrive allocated at refcount 1 and
                # already registered — exactly the hold a local match
                # would have acquired
                shared = shared + fetched
                self.fetched_tokens += len(fetched) * self.kv_block_size
        return shared

    def _finish_prefill(self, job, tok0):
        req = job.run.request
        now = time.perf_counter()
        eos = req.eos_token_id
        if job.resume_tok is not None:      # redrive re-prefill done
            tok0 = job.resume_tok           # the carried in-hand token
            rem0 = req.max_new_tokens - len(job.run.tokens)
            req.resume = None
            tokens = list(job.run.tokens)
            orig_len = int(np.asarray(req.prompt).reshape(-1).size)
            if self.tracer is not None:
                self.tracer.instant(req.request_id, "resume",
                                    slot=job.slot, redrive=True,
                                    reused_tokens=len(tokens))
        else:
            job.run.tokens = [tok0]
            job.run.t_admit = now           # the fleet TTFT timestamp
            self.tokens_emitted += 1
            _M_TOKENS.inc()
            rem0 = req.max_new_tokens - 1
            if eos is not None and tok0 == eos:
                rem0 = 0
            tokens, orig_len = None, None
        self.manager.register_prefix(job.prompt, job.run.block_ids)
        if rem0 <= 0:                       # finished at admission
            self._prefill_slots.discard(job.slot)
            self._retire(job.slot, job.run, now)
            return
        if self.tracer is not None:
            self.tracer.instant(req.request_id, "handoff_ready",
                                slot=job.slot)
        self._outbox.append(_PendingHandoff(
            run=job.run, slot=job.slot, prompt=job.prompt, tok0=tok0,
            rem0=rem0, key=_key_words(job.key), tokens=tokens,
            orig_len=orig_len))

    def extract_handoff(self, ph: _PendingHandoff,
                        source: str = "") -> KVHandoff:
        """Build the wire payload from live state: only the blocks
        holding prompt positions ``[0, L)`` ship. Arrays leave at
        storage dtype (int8 codes stay int8)."""
        L = int(ph.prompt.shape[0])
        bs = self.kv_block_size
        n_ship = -(-L // bs)
        arrays = {"prompt": np.asarray(ph.prompt, np.int32),
                  "key": np.asarray(ph.key, np.uint32)}
        for i, rows in enumerate(gather_rows(self,
                                             ph.run.block_ids[:n_ship])):
            arrays[f"kv_{i}"] = rows
        req = ph.run.request
        meta = {
            "kind": "paged", "request": request_to_meta(req),
            "tok0": ph.tok0, "pos0": L, "rem0": ph.rem0,
            "n_blocks": len(ph.run.block_ids), "n_ship": n_ship,
            "block_size": bs, "kv_int8": bool(self.kv_int8),
            "leaf_specs": leaf_specs(self.backend),
            "t_admit": float(ph.run.t_admit),
            "source": {"worker": source, "tp_degree": self.tp_degree()},
        }
        _stamp_resume_meta(meta, ph)
        return KVHandoff(meta=meta, arrays=arrays)


class PrefillDenseEngine(_PrefillEngineMixin, ContinuousBatchingEngine):
    """Dense engine that prefills but never decodes. Admission runs the
    SAME bucket prefill and key schedule as the unified dense engine
    (``key, sub = split(PRNGKey(seed))``; ``sub`` samples the first
    token, ``key`` rides the handoff), but the prefilled row's populated
    prefix parks in the outbox (a copy on the device: the backend's row
    is rewritten by the next prefill) instead of splicing into the pool.
    Built without a decode program."""

    def _build_backend(self, model, num_slots, max_len, decode_block,
                       megakernel, quant):
        return ModelStepBackend(model, num_slots, max_len, decode_block,
                                megakernel, quant, decode=False)

    def _row_prefix(self, Lb: int) -> tuple:
        return tuple(t[:, :Lb].clone()
                     for layer in self.backend.row for t in layer)

    def _prefill(self, request, ids, pad0, key, temperature, top_k, top_p):
        t0 = time.perf_counter()
        with RecordEvent("serving.prefill"):
            tok = int(self.backend.prefill(ids, pad0, key, temperature,
                                           top_k, top_p))
        _M_PREFILLS.inc()
        self.prefills += 1
        self.prefill_s += time.perf_counter() - t0
        return tok

    def _free_slot(self) -> int:
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError("no free slot (scheduler bug)")
        return slot

    def admit(self, request) -> bool:
        resume = _refuse_user_resume(request)
        if resume is not None and resume.tokens:
            return self._admit_redrive(request, resume)
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        self.validate_request(L, request.max_new_tokens)
        Lb = self.bucket_len(L)
        slot = self._free_slot()
        if self.tracer is not None:
            self.tracer.span_end(request.request_id, "queue_wait")
        ids = np.zeros((1, Lb), np.int32)
        ids[0, Lb - L:] = prompt
        pad0 = Lb - L
        # generate()'s key schedule: PRNGKey(seed) split into the slot's
        # key and the first token's sub-key
        key, sub = prng.split(prng.prng_key(request.seed)) \
            .to(self.backend.device)
        tok0 = self._prefill(request, ids, pad0, sub, request.temperature,
                             request.top_k, request.top_p)
        _M_TOKENS.inc()
        run = _SlotRun(request, tokens=[tok0], t_admit=time.perf_counter())
        self.tokens_emitted += 1
        eos = request.eos_token_id
        rem0 = request.max_new_tokens - 1
        if eos is not None and tok0 == eos:
            rem0 = 0
        if rem0 <= 0:                        # finished at admission
            run.t_done = time.perf_counter()
            self._finished.append(run)
            return True
        self._slots[slot] = run
        self._prefill_slots.add(slot)        # occupied, never decoding
        self._outbox.append(_PendingHandoff(
            run=run, slot=slot, prompt=prompt, tok0=tok0, rem0=rem0,
            key=_key_words(key), row=self._row_prefix(Lb), pad0=pad0,
            bucket=Lb))
        return False

    def _admit_redrive(self, request, resume) -> bool:
        """Redrive re-prefill, dense flavour: prompt + tokens[:-1]
        left-padded to its bucket, the sample DISCARDED (the stream owns
        its next token and the carried key must not advance), the row
        parked in the outbox with the carried history."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        toks = list(resume.tokens)
        full = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        pl = int(full.shape[0])
        rem0 = request.max_new_tokens - len(toks)
        self.validate_request(pl, rem0 + 1)
        Lb = self.bucket_len(pl)
        slot = self._free_slot()
        if self.tracer is not None:
            self.tracer.span_end(request.request_id, "queue_wait",
                                 resumed=True, redrive=True)
        ids = np.zeros((1, Lb), np.int32)
        ids[0, Lb - pl:] = full
        pad0 = Lb - pl
        self._prefill(request, ids, pad0,
                      prng.prng_key(0).to(self.backend.device), 0.0, 0, 1.0)
        run = _SlotRun(request, tokens=toks, t_admit=resume.t_admit)
        request.resume = None
        if rem0 <= 0:                        # defensive: already done
            run.t_done = time.perf_counter()
            self._finished.append(run)
            return True
        self._slots[slot] = run
        self._prefill_slots.add(slot)
        if self.tracer is not None:
            self.tracer.instant(request.request_id, "resume", slot=slot,
                                redrive=True, reused_tokens=len(toks))
        self._outbox.append(_PendingHandoff(
            run=run, slot=slot, prompt=full, tok0=int(toks[-1]),
            rem0=rem0, key=np.asarray(resume.key, np.uint32),
            row=self._row_prefix(Lb), pad0=pad0, bucket=Lb, tokens=toks,
            orig_len=int(prompt.shape[0])))
        return False

    def extract_handoff(self, ph: _PendingHandoff,
                        source: str = "") -> KVHandoff:
        """Dense payload: the populated row prefix ``[:, :Lb]``. The row
        beyond the bucket is zeros by construction (prefill starts from
        a zero row), so zero-filling on adopt reconstructs it EXACTLY."""
        arrays = {"prompt": np.asarray(ph.prompt, np.int32),
                  "key": np.asarray(ph.key, np.uint32)}
        for i, r in enumerate(ph.row):
            arrays[f"kv_{i}"] = leaf_to_wire(r)
        req = ph.run.request
        meta = {
            "kind": "dense", "request": request_to_meta(req),
            "tok0": ph.tok0, "pos0": ph.bucket, "pad0": ph.pad0,
            "rem0": ph.rem0,
            "leaf_specs": leaf_specs(self.backend),
            "t_admit": float(ph.run.t_admit),
            "source": {"worker": source, "tp_degree": self.tp_degree()},
        }
        _stamp_resume_meta(meta, ph)
        return KVHandoff(meta=meta, arrays=arrays)


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

class FleetRouter:
    """Prefix-affinity request router with queue-depth spillover.

    The affinity key of a prompt is the chained-SHA1 digest of its FIRST
    full block — the key the BlockManager's prefix index stores that
    block under — so every request sharing a system prompt maps to the
    same prefill worker. Prompts with no full block key on their whole
    token tuple. Spillover: when the affinity target's queue is
    ``spill_depth`` deeper than the shallowest worker's, the request
    diverts to the least-loaded worker (counted)."""

    def __init__(self, block_size: int, affinity: Optional[bool] = None,
                 spill_depth: Optional[int] = None):
        if affinity is None:
            affinity = env_bool("PT_SERVING_FLEET_AFFINITY", True)
        if spill_depth is None:
            spill_depth = env_int("PT_SERVING_FLEET_SPILL_DEPTH", 8)
        if spill_depth < 1:
            raise ValueError(
                f"spill_depth={spill_depth}; must be >= 1")
        self.block_size = block_size
        self.affinity = bool(affinity)
        self.spill_depth = spill_depth
        self.affinity_routes = 0
        self.spillovers = 0

    def affinity_key(self, prompt) -> bytes:
        toks = np.asarray(prompt).reshape(-1)
        if toks.size > self.block_size:      # has a shareable block
            toks = toks[:self.block_size]
        return _sha1_chain(b"", tuple(int(t) for t in toks))

    def route(self, prompt, depths: List[int],
              eligible: List[int], warm=None) -> int:
        """Pick a prefill worker index. ``depths`` aligns with
        ``eligible`` (the non-draining workers). ``warm`` (optional) is
        the set of positions within ``eligible`` whose worker the fleet
        prefix directory lists as holding this prompt's chain head: when
        the affinity target spills over, a warm worker within tolerance
        beats the plain least-loaded one."""
        if not eligible:
            raise RuntimeError("no routable prefill worker (all "
                               "draining)")
        least = min(range(len(eligible)), key=lambda i: (depths[i], i))
        if not self.affinity:
            return eligible[least]
        pick = int.from_bytes(self.affinity_key(prompt)[:8], "big") \
            % len(eligible)
        if depths[pick] - depths[least] > self.spill_depth:
            self.spillovers += 1
            _M_SPILL.inc()
            if warm:
                wl = min((i for i in warm if i != pick),
                         key=lambda i: (depths[i], i), default=None)
                if wl is not None \
                        and depths[wl] - depths[least] \
                        <= self.spill_depth:
                    return eligible[wl]
            return eligible[least]
        self.affinity_routes += 1
        _M_AFFINITY.inc()
        return eligible[pick]


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

class PrefillWorker:
    """A Server over a prefill-only engine. The door machinery applies —
    scheduler gating, queue-depth shedding, deadlines (an expired outbox
    entry is dropped un-shipped), retries around prefill faults — while
    decode never runs here."""

    def __init__(self, engine, *, name: str = "",
                 scheduler=None, resilience=None, observability=None,
                 server: Optional[Server] = None):
        if not isinstance(engine, (PrefillDenseEngine,
                                   PrefillPagedEngine)):
            raise ValueError(
                "PrefillWorker needs a prefill-only engine "
                "(PrefillDenseEngine / PrefillPagedEngine); got "
                f"{type(engine).__name__}")
        self.engine = engine
        self.name = name
        self.server = server or Server(engine, scheduler, resilience,
                                       observability)
        self.killed = False

    def kill(self):
        """Simulate whole-worker loss (see DecodeWorker.kill)."""
        self.killed = True

    def heartbeat(self) -> Optional[dict]:
        if self.killed:
            return None
        hb = {"queue_depth": self.server.scheduler.pending(),
              "occupancy": self.engine.occupancy(),
              "outbox": len(self.engine._outbox)}
        if isinstance(self.engine, PagedEngine):
            # the prefix-directory publish rides the heartbeat
            hb["prefixes"] = self.engine.manager.registered_chains()
        return hb

    def queue_depth(self) -> int:
        return self.server.scheduler.pending()

    def busy(self) -> bool:
        return self.server.scheduler.pending() > 0 \
            or self.engine.has_live()

    def tick(self):
        if self.killed:
            return
        self.server.run_until_idle(max_ticks=1)


class DecodeWorker:
    """A Server over an ordinary engine whose requests arrive by
    adoption instead of submission. ``adopt()`` is the only addition;
    decode, harvest, deadlines, NaN quarantine, streaming sinks and
    snapshot/restore are the stock Server/engine paths — which is why
    migration is just snapshot/restore.

    Liveness: the worker emits a :meth:`heartbeat` each fleet tick
    (queue depth, occupancy and per-stream token progress — the
    observations the fleet's redrive records are built from). A worker
    ``kill()``-ed to simulate whole-process loss stops ticking, adopting
    and heartbeating; the fleet notices via its lease and redrives every
    stream the corpse owned."""

    def __init__(self, engine, *, name: str = "", resilience=None,
                 observability=None, server: Optional[Server] = None):
        if isinstance(engine, (PrefillDenseEngine, PrefillPagedEngine)):
            raise ValueError("DecodeWorker needs a decoding engine, "
                             "not a prefill-only one")
        self.engine = engine
        self.name = name
        self.server = server or Server(engine, resilience=resilience,
                                       observability=observability)
        self.killed = False
        # exactly-once adoption over an at-least-once wire: payloads
        # already armed, keyed (rid, payload seq)
        self._adopted: set = set()
        self.duplicate_adopts = 0

    # -- liveness ----------------------------------------------------------
    def kill(self):
        """Simulate whole-worker loss: the worker stops participating
        (no ticks, no adopts, no heartbeats). Its ENGINE state is never
        read again by the fleet: stream recovery works from the fleet's
        own records. Its ``server.results`` ledger IS still read: those
        outputs were delivered at harvest time, before any kill could
        land."""
        self.killed = True

    def heartbeat(self) -> Optional[dict]:
        """One liveness report, or None from a dead worker: queue depth,
        occupancy and per-live-stream token progress — everything needed
        to reconstruct a stream is on this side of the wire BEFORE the
        worker can die."""
        if self.killed:
            return None
        if len(self._adopted) > 256:
            # duplicates only arrive within one ship's retransmit window;
            # a terminated stream's dedup entries are dead weight
            self._adopted = {t for t in self._adopted
                             if t[0] not in self.server.results}
        hb = {
            "queue_depth": self.server.scheduler.pending(),
            "occupancy": self.engine.occupancy(),
            "free_slots": self.engine.free_slot_count(),
            "progress": {run.request.request_id: list(run.tokens)
                         for _slot, run in self.engine.live_runs()},
        }
        if isinstance(self.engine, PagedEngine):
            # decode workers publish too: adopted prompts and decode-time
            # shared sequences are fetchable warm state
            hb["prefixes"] = self.engine.manager.registered_chains()
        return hb

    # -- capacity ----------------------------------------------------------
    def free_slots(self) -> int:
        return self.engine.free_slot_count()

    def busy(self) -> bool:
        return self.engine.has_live()

    def tick(self):
        if self.killed:
            return
        self.server.run_until_idle(max_ticks=1)

    # -- adoption ----------------------------------------------------------
    def _validate(self, h: KVHandoff):
        eng = self.engine
        paged = isinstance(eng, PagedEngine)
        want_kind = "paged" if paged else "dense"
        if h.kind != want_kind:
            raise ValueError(
                f"{h.kind} handoff cannot adopt into a {want_kind} "
                "engine")
        specs = leaf_specs(eng.backend)
        if h.meta["leaf_specs"] != specs:
            raise ValueError(
                "handoff KV layout does not match this engine "
                f"(payload {h.meta['leaf_specs'][:2]}..., engine "
                f"{specs[:2]}...) — same model config / paging layout "
                "required")
        if paged and (h.meta["block_size"] != eng.kv_block_size
                      or bool(h.meta["kv_int8"]) != bool(eng.kv_int8)):
            raise ValueError(
                "handoff arena geometry mismatch (block_size/kv_int8)")
        if h.meta["pos0"] + h.meta["rem0"] > eng.max_len:
            raise ValueError(
                f"handoff needs {h.meta['pos0'] + h.meta['rem0']} "
                f"positions but this engine's max_len is {eng.max_len}")

    #: adopt() outcomes
    ADOPTED = "adopted"         # slot armed for the decode block
    DEFER = "defer"             # momentarily out of slots/blocks
    DUPLICATE = "duplicate"     # (rid, payload seq) already armed

    def adopt(self, h: KVHandoff) -> str:
        """Adopt one payload; returns :data:`ADOPTED`, :data:`DEFER`
        (retry after retirements) or :data:`DUPLICATE`. The
        ``fleet.adopt`` fault site fires before any state mutates, so a
        retry is clean.

        Idempotency: a payload whose ``(rid, meta["seq"])`` was already
        armed — an ack-lost retransmit — is a NO-OP at exact refcounts.
        A payload whose ``meta["crc32"]`` does not match its arrays is
        refused loudly BEFORE any allocator state is touched."""
        faults.fault_point("fleet.adopt")
        if self.killed:
            raise TransportError(
                f"decode worker {self.name!r} is dead")
        h.verify_crc()                  # loud, pre-allocation
        rid = h.request_id
        seq = h.meta.get("seq")
        if (seq is not None and (rid, seq) in self._adopted) \
                or rid in self.server.results:
            self.duplicate_adopts += 1
            _M_ADOPT_DUPS.inc()
            return self.DUPLICATE
        self._validate(h)
        eng = self.engine
        slot = next((i for i, s in enumerate(eng._slots) if s is None),
                    None)
        if slot is None:
            return self.DEFER
        if isinstance(eng, PagedEngine):
            ok = self._adopt_paged(h, slot)
        else:
            ok = self._adopt_dense(h, slot)
        if not ok:
            return self.DEFER
        if seq is not None:
            self._adopted.add((rid, seq))
        srv = self.server
        srv._tenant_of[rid] = h.meta["request"].get("tenant", "default")
        if srv.tracer.enabled:
            srv.tracer.start(rid)
            srv.tracer.span_begin(rid, "decode", slot=slot, adopted=True)
        _M_HANDOFFS.inc()
        return self.ADOPTED

    @staticmethod
    def _carried(meta, prompt):
        """(request, tokens) for the adopted run: a redrive payload's
        ``arrays["prompt"]`` is the re-prefilled prompt + history, so the
        request is rebuilt over the ORIGINAL prompt prefix and the run
        starts from the full carried token list."""
        orig = prompt[:int(meta.get("orig_prompt_len",
                                    prompt.shape[0]))]
        req = request_from_meta(meta["request"], orig)
        toks = [int(t) for t in meta.get("tokens", [meta["tok0"]])]
        return req, toks

    def _arm(self, h: KVHandoff, slot: int, req, **extra):
        """Arm ``slot`` in place with the payload's stream state (the
        tensors the captured decode block reads)."""
        eng, meta = self.engine, h.meta
        eos = req.eos_token_id
        _arm_fn(eng._state, slot, tok=meta["tok0"], pos=meta["pos0"],
                live=True, eos=-1 if eos is None else eos,
                remaining=meta["rem0"], temp=req.temperature,
                topk=req.top_k, topp=req.top_p,
                key=_key_tensor(h.arrays["key"], eng.backend.device),
                **extra)
        eng._remaining_host[slot] = meta["rem0"]

    def _adopt_paged(self, h: KVHandoff, slot: int) -> bool:
        eng = self.engine
        meta = h.meta
        prompt = h.arrays["prompt"]
        n_total, n_ship = meta["n_blocks"], meta["n_ship"]
        blocks = eng.manager.allocate(n_total)
        if blocks is None:
            return False
        req, toks = self._carried(meta, prompt)
        # only the shipped prompt blocks are written; decode-position
        # blocks are written by the decode block before it reads them
        copy_rows(eng, blocks[:n_ship],
                  [h.arrays[f"kv_{i}"]
                   for i in range(len(eng.backend.pool_specs))])
        # index the prompt's prefix blocks in THIS worker's manager so
        # the adopted copy is reusable here too
        eng.manager.register_prefix(prompt, blocks)
        eng._slots[slot] = _SlotRun(req, tokens=toks,
                                    t_admit=meta["t_admit"],
                                    block_ids=blocks)
        table_row = np.zeros((eng.max_blocks,), np.int32)
        table_row[:n_total] = blocks
        self._arm(h, slot, req, table=torch.as_tensor(
            table_row, device=eng.backend.device))
        return True

    def _adopt_dense(self, h: KVHandoff, slot: int) -> bool:
        eng = self.engine
        meta = h.meta
        req, toks = self._carried(meta, h.arrays["prompt"])
        Lb = meta["pos0"]
        dev = eng.backend.device
        leaves = [t for layer in eng.backend.row for t in layer]
        for i, t in enumerate(leaves):
            t.zero_()
            t[:, :Lb].copy_(wire_to_tensor(h.arrays[f"kv_{i}"], t.dtype,
                                           dev))
        eng.backend.splice(slot)
        eng._slots[slot] = _SlotRun(req, tokens=toks,
                                    t_admit=meta["t_admit"])
        self._arm(h, slot, req, pad=meta["pad0"])
        return True


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

class Fleet:
    """N prefill workers + M decode workers + router + transport, one
    deterministic tick loop. ``submit()`` routes by prefix affinity; each
    tick advances every prefill worker, ships ready handoffs to the
    least-loaded decode worker, adopts delivered payloads, advances every
    decode worker, then collects heartbeats and renews leases.
    ``results`` aggregates every worker's results plus explicit handoff
    failures — each submitted request ends in exactly one of them, under
    one fleet-wide id.

    **Failure domains**: every worker holds a lease renewed by its
    per-tick heartbeat; a worker missing ``lease_misses`` consecutive
    heartbeats is DEAD (flight-recorder event + ``pt_fleet_worker_state``
    gauge) and never read again. Streams a dead decode worker owned are
    REDRIVEN from the fleet's own records via a ``redrive``
    :class:`ResumeState`. A dead prefill worker's un-handed-off requests
    resubmit under their original ids. Streams that cannot be redriven
    fail explicitly as ``RequestFailure(reason="worker_lost")``.

    ``handoff_timing`` holds, per phase of :data:`HANDOFF_PHASES`, the
    host wall seconds of each shipped handoff (the device copies at
    extract and adopt included)."""

    def __init__(self, prefill_workers: List[PrefillWorker],
                 decode_workers: List[DecodeWorker], *,
                 transport: Optional[Transport] = None,
                 affinity: Optional[bool] = None,
                 spill_depth: Optional[int] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 lease_misses: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 evict_high: Optional[float] = None,
                 evict_low: Optional[float] = None,
                 durability: Optional[str] = None,
                 spill_max_bytes: Optional[int] = None):
        if not prefill_workers or not decode_workers:
            raise ValueError("need at least one prefill and one decode "
                             "worker")
        if lease_misses is None:
            lease_misses = env_int("PT_SERVING_FLEET_LEASE_MISSES", 3)
        if lease_misses < 1:
            raise ValueError(
                f"lease_misses={lease_misses}; must be >= 1")
        self.lease_misses = lease_misses
        self.prefill = list(prefill_workers)
        self.decode = list(decode_workers)
        for i, w in enumerate(self.prefill):
            w.name = w.name or f"prefill{i}"
            # disjoint request-id ranges: the rid a prefill worker assigns
            # IS the fleet-wide id the decode worker completes
            if w.server._next_id == 0:
                w.server._next_id = (i + 1) * 1_000_000
        for i, d in enumerate(self.decode):
            d.name = d.name or f"decode{i}"
        names = [w.name for w in self.prefill] \
            + [d.name for d in self.decode]
        if len(set(names)) != len(names):
            raise ValueError(
                f"duplicate worker names {sorted(names)} — names address "
                "transport queues, leases and assignment counters, so "
                "they must be unique")
        self._check_compat()
        self.transport = transport or InProcessTransport()
        paged = isinstance(self.prefill[0].engine, PagedEngine)
        self.router = FleetRouter(
            self.prefill[0].engine.kv_block_size if paged else 16,
            affinity=affinity, spill_depth=spill_depth)
        self.resilience = resilience or ResilienceConfig()
        self._res = ResilienceState(self.resilience)
        self.flight = FlightRecorder()
        self._failures: Dict[int, RequestFailure] = {}
        # redrive-completed streams that never re-reach a worker (the
        # carried history already held every token), and the results of
        # removed workers
        self._local_results: Dict[int, np.ndarray] = {}
        self._pending_adopt: Dict[str, deque] = {
            d.name: deque() for d in self.decode}
        self._assigned: Dict[str, int] = {d.name: 0 for d in self.decode}
        self._draining: set = set()          # prefill indices
        self._draining_decode: set = set()   # decode NAMES
        # -- failure-domain records (everything redrive needs lives on
        # THIS side of the wire) --
        # rid -> {prompt, kw, worker, t_submit}: every submission
        self._requests: Dict[int, dict] = {}
        # rid -> {dst, key0, base_len, tokens0, t_admit}: every shipped
        # handoff (key0 = the rng key at ship, base_len = carried tokens)
        self._handoffs: Dict[int, dict] = {}
        # rid -> last observed token list (heartbeat-carried)
        self._progress: Dict[int, list] = {}
        self._health: Dict[str, dict] = {
            n: {"state": "live", "misses": 0} for n in names}
        for n in names:
            _M_WORKER_STATE.set(1, worker=n)
        # -- fleet-wide prefix cache --
        if prefix_cache is None:
            prefix_cache = env_bool("PT_SERVING_FLEET_PREFIX_CACHE", True)
        if evict_high is None:
            evict_high = env_float("PT_SERVING_FLEET_EVICT_HIGH", 0.85)
        if evict_low is None:
            evict_low = env_float("PT_SERVING_FLEET_EVICT_LOW", 0.70)
        if not 0.0 < evict_low <= evict_high <= 1.0:
            raise ValueError(
                f"eviction watermarks need 0 < low <= high <= 1; got "
                f"low={evict_low}, high={evict_high}")
        self.prefix_cache_enabled = bool(prefix_cache) and paged
        self.evict_high, self.evict_low = float(evict_high), \
            float(evict_low)
        self.directory = PrefixCacheDirectory()
        self._fetch_seq = 0
        self._fetch_endpoints: set = set()
        self.prefix_fetches = 0
        self.prefix_fetch_blocks = 0
        self.prefix_fetch_kv_bytes: List[int] = []
        self.prefix_fetch_failures: Dict[str, int] = {}
        self.prefix_fetch_duplicates = 0
        self.prefix_evictions = 0
        if self.prefix_cache_enabled:
            for w in self.prefill:
                w.engine.prefix_fetcher = self._make_fetcher(w)
        self._handoff_seq = 0
        self.handoffs = 0
        self.handoff_wire_bytes: List[int] = []
        self.handoff_kv_bytes: List[int] = []
        self.handoff_timing: Dict[str, List[float]] = {
            p: [] for p in HANDOFF_PHASES}
        self.migrations = 0
        self.redrives = 0
        self.workers_lost = 0
        self.redrive_latencies: List[float] = []
        # rid -> detection wall time, for redriven streams still open
        self._redrive_t0: Dict[int, float] = {}
        self._clock = 0
        # -- durable control plane --
        self.durability_dir: Optional[str] = None
        self._dur_epoch = 0
        self._journal: Optional[_dur.WriteAheadJournal] = None
        self._spill: Optional[_dur.PrefixSpillStore] = None
        # rid -> journaled token high-water mark / terminals written
        self._journaled_progress: Dict[int, int] = {}
        self._journaled_terminals: set = set()
        self.recoveries = 0
        self.last_recovery: Optional[dict] = None
        self.last_checkpoint: Optional[dict] = None
        if spill_max_bytes is None:
            spill_max_bytes = env_int("PT_SERVING_SPILL_MAX_BYTES", 1 << 28)
        self._spill_max_bytes = int(spill_max_bytes)
        if durability is not None:
            self._attach_durability(durability, epoch=0)
            if self._journal.empty():
                self._jrec({"k": "genesis",
                            "prefill": [w.name for w in self.prefill],
                            "decode": [d.name for d in self.decode]})

    def _attach_durability(self, dirname: str, epoch: int):
        """Open (or, in recovery, reopen) the journal segment of ``epoch``
        and the spill tier under ``dirname``."""
        os.makedirs(dirname, exist_ok=True)
        self.durability_dir = dirname
        self._dur_epoch = int(epoch)
        self._journal = _dur.WriteAheadJournal(
            _dur.journal_path(dirname, epoch))
        if self.prefix_cache_enabled:
            self._spill = _dur.PrefixSpillStore(
                os.path.join(dirname, "spill"),
                max_bytes=self._spill_max_bytes)

    def _jrec(self, rec: dict):
        """Append one control-plane record, retrying transient failures
        with the fleet's seeded backoff. A journal that still fails past
        the retry budget raises: a fleet without its log is a crashed
        fleet, never a silently forgetful one."""
        if self._journal is None:
            return
        last = None
        for attempt in range(self.resilience.retry_attempts + 1):
            try:
                self._journal.append(rec)
                return
            except (faults.InjectedFault, OSError) as e:
                last = e
                if attempt < self.resilience.retry_attempts:
                    time.sleep(self._res.backoff_s(attempt))
        raise RuntimeError(
            f"write-ahead journal append failed past the retry budget: "
            f"{type(last).__name__}: {last}")

    def _check_compat(self):
        """Every engine in the fleet must share the KV layout — a payload
        must adopt onto ANY decode worker. Refused loudly at
        construction (and at add_decode_worker)."""
        engines = [w.engine for w in self.prefill] \
            + [d.engine for d in self.decode]
        for e in engines[1:]:
            self._check_engine_compat(e, engines[0])

    @staticmethod
    def _check_engine_compat(e, first):
        paged0 = isinstance(first, PagedEngine)
        if isinstance(e, PagedEngine) != paged0:
            raise ValueError("mixed dense/paged fleet — every worker "
                             "must share the engine kind")
        if e.max_len != first.max_len:
            raise ValueError(
                f"max_len mismatch across the fleet "
                f"({e.max_len} vs {first.max_len})")
        if leaf_specs(e.backend) != leaf_specs(first.backend):
            raise ValueError(
                "KV leaf layout mismatch across the fleet — same model "
                "config / paging layout required")
        if paged0 and (e.kv_block_size != first.kv_block_size
                       or bool(e.kv_int8) != bool(first.kv_int8)):
            raise ValueError(
                "paged arena geometry mismatch across the fleet "
                "(block_size/kv_int8)")

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 20,
               prefill_worker: Optional[str] = None, **kw) -> int:
        """Route and submit one request; returns the fleet-wide id (key
        into ``results``). Capacity is validated against BOTH pools at
        the door: the routed prefill worker's (inside ``Server.submit``)
        and the largest decode pool's. ``prefill_worker`` pins the
        request to a named routable worker, bypassing the router."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        err = None
        for d in self._live_decode():
            try:
                d.engine.validate_request(int(prompt.size),
                                          max_new_tokens)
                err = None
                break
            except ValueError as e:
                err = e
        if err is not None:
            raise ValueError(f"no decode worker can serve this "
                             f"request: {err}")
        eligible = self._routable_prefill()
        if prefill_worker is not None:
            by_name = {self.prefill[i].name: i for i in eligible}
            if prefill_worker not in by_name:
                raise ValueError(
                    f"prefill worker {prefill_worker!r} is not routable "
                    f"(have {sorted(by_name)})")
            wi = by_name[prefill_worker]
        else:
            depths = [self.prefill[i].queue_depth() for i in eligible]
            warm = None
            if self.prefix_cache_enabled:
                owners = set(self.directory.owners(
                    self.router.affinity_key(prompt)))
                if owners:
                    warm = {pos for pos, i in enumerate(eligible)
                            if self.prefill[i].name in owners}
            wi = self.router.route(prompt, depths, eligible, warm=warm)
        w = self.prefill[wi]
        rid = w.server.submit(prompt, max_new_tokens=max_new_tokens, **kw)
        # the submission record: with it (plus the shipped key and the
        # heartbeat-carried progress) the fleet can rebuild the request
        # after ANY worker holding it dies
        self._requests[rid] = {
            "prompt": prompt.copy(), "worker": w.name,
            "t_submit": time.perf_counter(),
            "kw": dict(kw, max_new_tokens=max_new_tokens)}
        if self._journal is not None:
            self._jrec({"k": "submit", "rid": int(rid),
                        "prompt": [int(t) for t in prompt],
                        "worker": w.name,
                        "kw": {k: _plain(v) for k, v in
                               self._requests[rid]["kw"].items()}})
        return rid

    # -- liveness views ----------------------------------------------------
    def _alive(self, name: str) -> bool:
        return self._health[name]["state"] == "live"

    def _live_decode(self) -> List[DecodeWorker]:
        return [d for d in self.decode if self._alive(d.name)]

    def _routable_prefill(self) -> List[int]:
        return [i for i in range(len(self.prefill))
                if i not in self._draining
                and self._alive(self.prefill[i].name)]

    # -- the tick ----------------------------------------------------------
    def _with_retry(self, fn):
        """The retry/backoff/breaker policy around one handoff op (the
        loop of ``Server._with_retry`` over the same
        ``ResilienceState``). Returns ``(ok, value)``."""
        res, cfg = self._res, self.resilience
        for attempt in range(cfg.retry_attempts + 1):
            if res.breaker_open:
                return False, None
            try:
                out = fn()
                res.consecutive_failures = 0
                return True, out
            except res.transient as e:
                res.step_failures += 1
                res.consecutive_failures += 1
                res.last_error = f"{type(e).__name__}: {e}"
                if res.consecutive_failures >= cfg.breaker_threshold:
                    res.breaker_open = True
                    return False, None
                if attempt < cfg.retry_attempts:
                    res.retries += 1
                    _M_FLEET_RETRIES.inc()
                    time.sleep(res.backoff_s(attempt))
        return False, None

    def _fail_handoff(self, rid: int, reason: str, message: str,
                      tokens: int = 0):
        self._failures[rid] = RequestFailure(
            request_id=rid, reason=reason, message=message,
            tokens_emitted=tokens)
        self._res.count_failure(reason)
        _M_HANDOFF_FAILS.inc(reason=reason)

    def _pick_decode(self) -> Optional[int]:
        """Least-loaded LIVE decode worker: free slots minus payloads
        assigned but not yet adopted; ties break low-index. A
        killed-but-undetected worker is still a target (its payloads
        redrive when the lease expires); a detected-dead one never is; a
        DRAINING one only when no other survives."""
        names = [d.name for d in self.decode]
        live = [i for i in range(len(self.decode))
                if self._alive(names[i])]
        if not live:
            return None
        routable = [i for i in live
                    if names[i] not in self._draining_decode]
        return max(routable or live,
                   key=lambda i: (self.decode[i].free_slots()
                                  - self._assigned[names[i]], -i))

    def _ship(self, w: PrefillWorker, ph: _PendingHandoff):
        rid = ph.run.request.request_id
        if self._res.breaker_open:
            w.engine.release_handoff(ph)
            self._fail_handoff(rid, "circuit_open",
                               "fleet handoff circuit open")
            return
        di = self._pick_decode()
        if di is None:
            w.engine.release_handoff(ph)
            self._fail_handoff(rid, "worker_lost",
                               "no live decode worker to ship to",
                               tokens=len(ph.run.tokens))
            return
        dst = self.decode[di].name
        self._handoff_seq += 1
        seq = self._handoff_seq
        holder = {"transport": 0.0}

        def _do():
            if "data" not in holder:          # extract + serialize ONCE
                t0 = time.perf_counter()
                h = w.engine.extract_handoff(ph, source=w.name)
                h.meta["seq"] = seq
                h.meta["crc32"] = h.payload_crc32()
                t1 = time.perf_counter()
                data = encode_handoff(h)
                holder.update(h=h, kv=h.kv_bytes(), data=data,
                              extract=t1 - t0,
                              encode=time.perf_counter() - t1)
            t0 = time.perf_counter()
            try:
                self.transport.send(dst, holder["data"])
            finally:
                holder["transport"] += time.perf_counter() - t0

        ok, _ = self._with_retry(_do)
        w.engine.release_handoff(ph)
        if not ok:
            reason = "circuit_open" if self._res.breaker_open \
                else "handoff"
            self._fail_handoff(
                rid, reason,
                f"handoff to {dst} failed: {self._res.last_error}",
                tokens=len(ph.run.tokens))
            return
        self._assigned[dst] += 1
        self.handoffs += 1
        self.handoff_wire_bytes.append(len(holder["data"]))
        self.handoff_kv_bytes.append(holder["kv"])
        for p in ("extract", "encode", "transport"):
            self.handoff_timing[p].append(holder[p])
        _M_HANDOFF_BYTES.inc(len(holder["data"]))
        # the redrive record: the key the slot arms with and how many
        # tokens it carried — with heartbeat progress, the slot key after
        # m more emissions is split^m(key0)
        h = holder["h"]
        toks = [int(t) for t in h.meta.get("tokens", [h.meta["tok0"]])]
        self._handoffs[rid] = {
            "dst": dst, "key0": np.asarray(h.arrays["key"], np.uint32),
            "base_len": len(toks), "tokens0": list(toks),
            "t_admit": float(h.meta["t_admit"])}
        self._progress[rid] = toks
        if self._journal is not None:
            # the key as the wire's uint32 words, a JSON int list
            self._jrec({
                "k": "ship", "rid": int(rid), "dst": dst, "seq": int(seq),
                "key0": [int(x) for x in np.asarray(
                    h.arrays["key"], np.uint32).reshape(-1)],
                "base_len": len(toks), "tokens0": list(toks),
                "t_admit": float(h.meta["t_admit"])})
            self._journaled_progress[rid] = len(toks)

    def _deliver(self, d: DecodeWorker):
        if d.killed:        # a dead process runs no receive loop; its
            return          # queued payloads redrive at lease expiry
        q = self._pending_adopt[d.name]
        while True:
            if not q:
                data = self.transport.recv(d.name)
                if data is None:
                    return
                t0 = time.perf_counter()
                q.append(decode_handoff(data))
                self.handoff_timing["decode"].append(
                    time.perf_counter() - t0)
            h = q[0]
            if h.request_id in self._failures:
                # an at-least-once straggler of a ship recorded as a
                # permanent failure: drop it, never adopt it
                q.popleft()
                continue
            carried = len(h.meta.get("tokens", [h.meta.get("tok0")]))
            t0 = time.perf_counter()
            try:
                ok, status = self._with_retry(lambda: d.adopt(h))
            except ValueError as e:
                # corrupt/incompatible payload: permanent, loud, no retry
                self._fail_handoff(h.request_id, "handoff",
                                   f"adopt refused: {e}", tokens=carried)
                q.popleft()
                self._assigned[d.name] -= 1
                continue
            if ok and status == DecodeWorker.ADOPTED:
                self.handoff_timing["adopt"].append(
                    time.perf_counter() - t0)
                q.popleft()
                self._assigned[d.name] -= 1
                if self._journal is not None:
                    self._jrec({"k": "adopt", "rid": int(h.request_id),
                                "worker": d.name,
                                "seq": int(h.meta.get("seq", 0))})
                continue
            if ok and status == DecodeWorker.DUPLICATE:
                q.popleft()           # the first copy already counted
                continue
            if ok:                            # DEFER: retry next tick
                _M_ADOPT_DEFERS.inc()
                return
            reason = "circuit_open" if self._res.breaker_open \
                else "handoff"
            self._fail_handoff(
                h.request_id, reason,
                f"adopt on {d.name} failed: {self._res.last_error}",
                tokens=carried)
            q.popleft()
            self._assigned[d.name] -= 1

    # -- fleet-wide prefix cache: fetch / directory / eviction -------------
    def _make_fetcher(self, w: PrefillWorker):
        def _fetch(full, local_blocks):
            return self._fetch_prefix(w, full, local_blocks)
        return _fetch

    def _worker_by_name(self, name: str):
        for w in list(self.prefill) + list(self.decode):
            if w.name == name:
                return w
        return None

    def _note_fetch_fail(self, reason: str):
        self.prefix_fetch_failures[reason] = \
            self.prefix_fetch_failures.get(reason, 0) + 1
        _pc._M_FETCH_FAILS.inc(reason=reason)

    def _drain_fetch_endpoint(self, ep: str):
        """Discard stray frames on a fetch side channel (late
        at-least-once retransmits of concluded fetches)."""
        while self.transport.recv(ep) is not None:
            self.prefix_fetch_duplicates += 1
            _pc._M_FETCH_DUPS.inc()

    def _fetch_prefix(self, w: PrefillWorker, full,
                      local_blocks) -> Optional[List[int]]:
        """One synchronous remote prefix fetch on behalf of worker
        ``w``'s admission: directory lookup → owner-side extract →
        transport round trip on ``w``'s ``#fetch`` side channel → CRC
        verify → adopt → register. Returns the adopted block ids, or
        None — EVERY failure is a None: the request prefills locally."""
        eng = w.engine
        n_local = len(local_blocks)
        exclude = {w.name} | {n for n, h in self._health.items()
                              if h["state"] != "live"}
        depth, owners = self.directory.deepest_covered(
            full, eng.kv_block_size, eng.manager.hash_fn,
            exclude=exclude)
        if self._spill is not None:
            # the disk tier competes with live owners: strictly deeper
            # spilled coverage wins (a tie goes to the fresher live
            # owner); any spill failure falls through to the remote path
            got = self._spill_fetch(w, full, local_blocks, depth)
            if got is not None:
                return got
        if depth <= n_local:
            return None                  # nothing beyond the local match
        if self._res.breaker_open:
            self._note_fetch_fail("circuit_open")
            return None
        owner = self._worker_by_name(owners[0])
        if owner is None:
            self._note_fetch_fail("stale")
            return None
        self._fetch_seq += 1
        seq = self._fetch_seq
        ep = fetch_endpoint(w.name)
        self._fetch_endpoints.add(ep)
        holder: dict = {}

        def _do():
            faults.fault_point("fleet.fetch")
            if owner.killed:
                raise TransportError(
                    f"prefix owner {owner.name!r} is dead")
            if "data" not in holder and "stale" not in holder:
                h = extract_prefix(owner.engine, full, depth,
                                   skip=n_local, source=owner.name)
                if h is None:    # owner evicted since its last beat
                    holder["stale"] = True
                    return
                h.meta["request"] = {"request_id": -seq}
                h.meta["seq"] = seq
                h.meta["crc32"] = h.payload_crc32()
                holder["kv"] = h.kv_bytes()
                holder["data"] = encode_handoff(h)
            self.transport.send(ep, holder["data"])

        ok, _ = self._with_retry(_do)
        if holder.get("stale"):
            self._note_fetch_fail("stale")
            return None
        if not ok:
            self._note_fetch_fail("circuit_open"
                                  if self._res.breaker_open
                                  else "transport")
            self._drain_fetch_endpoint(ep)
            return None
        fetched = None
        while True:                      # drain the side channel FULLY
            data = self.transport.recv(ep)
            if data is None:
                break
            try:
                h = decode_handoff(data)
                if h.meta.get("seq") != seq or fetched is not None:
                    self.prefix_fetch_duplicates += 1
                    _pc._M_FETCH_DUPS.inc()
                    continue
                h.verify_crc()           # loud, pre-allocation
            except ValueError:
                self._note_fetch_fail("corrupt")
                continue
            got = adopt_prefix(eng, h, local_blocks, full)
            if got is None:
                self._note_fetch_fail("pool_full")
                continue
            fetched = got
            self.prefix_fetches += 1
            self.prefix_fetch_blocks += len(got)
            self.prefix_fetch_kv_bytes.append(holder["kv"])
            _pc._M_FETCHES.inc()
            _pc._M_FETCH_BLOCKS.inc(len(got))
            _pc._M_FETCH_BYTES.inc(len(holder["data"]))
            self.flight.record("prefix_fetch", worker=w.name,
                               owner=owner.name, blocks=len(got),
                               clock=self._clock)
        return fetched

    def _spill_fetch(self, w: PrefillWorker, full, local_blocks,
                     dir_depth: int) -> Optional[List[int]]:
        """Serve a prefix fetch from the disk spill tier: the deepest
        spilled chain on the prompt's digest path, CRC-verified,
        token-compared, re-skipped past the local match and adopted
        through the SAME copy as a live fetch (bit-identical state either
        way). Every failure (an armed ``spill.read``, an unreadable file,
        a CRC or token mismatch, a full pool) counts a miss and returns
        None: the caller falls back to a live owner or local prefill."""
        eng = w.engine
        n_local = len(local_blocks)
        sdepth, digest = self._spill.lookup(
            full, eng.kv_block_size, eng.manager.hash_fn)
        if digest is None or sdepth <= max(dir_depth, n_local):
            return None
        try:
            h = self._spill.read(digest)
        except (faults.InjectedFault, OSError, ValueError):
            self._spill.note_miss()
            self._note_fetch_fail("spill")
            return None
        bs = eng.kv_block_size
        stored = [int(t) for t in h.arrays["tokens"][:sdepth * bs]]
        if stored != [int(t) for t in full[:sdepth * bs]] \
                or int(h.meta.get("n_blocks", 0)) != sdepth:
            self._spill.note_miss()      # hash collision / stale file
            self._note_fetch_fail("spill")
            return None
        try:
            got = adopt_prefix(eng, _dur.slice_prefix_payload(h, n_local),
                               local_blocks, full)
        except ValueError:
            self._spill.note_miss()      # incompatible payload
            self._note_fetch_fail("spill")
            return None
        if got is None:
            self._spill.note_miss()
            self._note_fetch_fail("pool_full")
            return None
        self._spill.note_hit()
        self.prefix_fetches += 1
        self.prefix_fetch_blocks += len(got)
        self.flight.record("prefix_spill_hit", worker=w.name,
                           blocks=len(got), depth=sdepth,
                           clock=self._clock)
        return got

    def _evict_tick(self):
        """Watermark eviction: when fleet-global block pressure exceeds
        ``evict_high``, evict LRU unreferenced registered blocks — most
        pressured arenas first — until it is back at ``evict_low``.
        Referenced blocks are untouchable; the owners' next heartbeats
        retract the evicted digests from the directory. With a spill
        tier the chains about to go are copied to disk first."""
        pool = [(w.engine, w.name) for w in self.prefill
                if self._alive(w.name)] \
            + [(d.engine, d.name) for d in self.decode
               if self._alive(d.name)]
        usable = sum(e.manager.usable_blocks() for e, _ in pool)
        if not usable:
            return
        free = sum(len(e.manager._free) for e, _ in pool)
        if 1.0 - free / usable <= self.evict_high:
            return
        need = int(np.ceil((1.0 - self.evict_low) * usable)) - free
        done = 0
        for e, name in sorted(pool,
                              key=lambda p: p[0].manager.block_pressure(),
                              reverse=True):
            if need <= 0:
                break
            if self._spill is not None:
                self._spill_victims(e, name, need)
            n = e.manager.evict_cached(need)
            need -= n
            done += n
        if done:
            self.prefix_evictions += done
            self.flight.record("prefix_evict", blocks=done,
                               clock=self._clock)

    def _spill_victims(self, engine, name: str, n: int):
        """Copy the chains about to be watermark-evicted from
        ``engine``'s arena into the spill tier — BEFORE ``evict_cached``
        frees them, through the side-effect-free preview and extraction
        (the spill must not change which blocks the eviction picks).
        Deepest chains only, deduplicated by prefix containment; a failed
        spill write is a lost optimization, never a failed eviction."""
        m = engine.manager
        victims = set(m.eviction_victims(n))
        if not victims:
            return
        tok_map = m.chain_tokens_map()
        cands = []
        for b in victims:
            d = m._digest_of.get(b)
            t = tok_map.get(d) if d is not None else None
            if t is not None:
                cands.append((m._depth.get(d, 0), d, t))
        cands.sort(key=lambda c: (-c[0], c[1]))
        kept = []
        for depth, d, t in cands:
            if any(kt[:len(t)] == t for _, _, kt in kept):
                continue            # covered by a deeper kept chain
            kept.append((depth, d, t))
        for depth, d, t in kept:
            try:
                h = _dur.extract_chain(engine, t, depth, source=name)
                if h is not None:
                    self._spill.put(d, h)
            except (faults.InjectedFault, OSError, ValueError):
                continue            # the spill is best effort

    def tick(self):
        """One fleet tick: prefill advance → ship → deliver/adopt →
        decode advance → heartbeats/lease scan. Deterministic given the
        same submissions, kill schedule and fault schedule."""
        self._clock += 1
        for w in self.prefill:
            if self._alive(w.name):
                w.tick()
        for w in self.prefill:
            if w.killed or not self._alive(w.name):
                continue        # a dead process ships nothing
            for ph in w.engine.take_handoffs():
                self._ship(w, ph)
        for d in self.decode:
            if self._alive(d.name):
                self._deliver(d)
        for d in self.decode:
            if self._alive(d.name):
                d.tick()
        self._beat()
        if self.prefix_cache_enabled:
            for ep in list(self._fetch_endpoints):
                self._drain_fetch_endpoint(ep)
            self._evict_tick()
        if self._redrive_t0:
            self._settle_redrives()
        if self._journal is not None:
            # terminals are journaled BEFORE the gc can drop their
            # records: a crash after the gc must still know the stream
            # concluded
            self._journal_terminals()
        if self._clock % 64 == 0:
            self._gc_records()
        if _om.enabled():
            for w in self.prefill:
                if self._alive(w.name):
                    _M_PF_DEPTH.set(w.queue_depth(), worker=w.name)
            for d in self.decode:
                if self._alive(d.name):
                    _M_DEC_FREE.set(d.free_slots(), worker=d.name)

    def busy(self) -> bool:
        return (any(w.busy() for w in self.prefill
                    if self._alive(w.name))
                or self.transport.pending() > 0
                or any(q for n, q in self._pending_adopt.items()
                       if self._alive(n))
                or any(d.busy() for d in self.decode
                       if self._alive(d.name)))

    def run_until_idle(self, max_ticks: Optional[int] = None
                       ) -> Dict[int, object]:
        ticks = 0
        while self.busy():
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.tick()
            ticks += 1
        return self.results

    # -- worker health: heartbeats, leases, death --------------------------
    def _beat(self):
        for w in self.prefill:
            self._beat_one(w, "prefill")
        for d in self.decode:
            self._beat_one(d, "decode")

    def _beat_one(self, worker, role: str):
        h = self._health[worker.name]
        if h["state"] == "dead":
            return
        hb = worker.heartbeat()
        if hb is None:
            h["misses"] += 1
            self.flight.record("heartbeat_miss", worker=worker.name,
                               role=role, misses=h["misses"],
                               clock=self._clock)
            if h["misses"] >= self.lease_misses:
                self._declare_dead(worker, role)
            return
        h["misses"] = 0
        h["last"] = hb
        if self.prefix_cache_enabled and "prefixes" in hb:
            # the fleet.directory fault drops ONE publish: the directory
            # serves a stale view until the next beat
            if not faults.should_fire("fleet.directory"):
                self.directory.publish(worker.name, hb["prefixes"])
        if role == "decode":
            # progress carried by the heartbeat IS the redrive record
            for rid, toks in hb["progress"].items():
                if rid in self._handoffs:
                    self._progress[rid] = list(toks)
                    if self._journal is not None:
                        n0 = self._journaled_progress.get(rid, 0)
                        if len(toks) > n0:
                            # high-water marks journal as deltas; the
                            # only-extend replay guard makes them
                            # idempotent over a newer manifest
                            self._jrec({
                                "k": "progress", "rid": int(rid),
                                "base": int(n0),
                                "ext": [int(t) for t in toks[n0:]]})
                            self._journaled_progress[rid] = len(toks)

    def _declare_dead(self, worker, role: str):
        h = self._health[worker.name]
        h["state"] = "dead"
        self.workers_lost += 1
        _M_WORKERS_LOST.inc(role=role)
        _M_WORKER_STATE.set(0, worker=worker.name)
        self.flight.record("worker_dead", worker=worker.name,
                           role=role, clock=self._clock,
                           lease_misses=self.lease_misses)
        self.directory.drop_worker(worker.name)
        if self._journal is not None:
            # recovery must not restore a worker that died after the
            # checkpoint: its streams redrive below, and their fresh ship
            # records would conflict with the restored corpse
            self._jrec({"k": "scale", "action": "dead",
                        "worker": worker.name, "role": role})
        if role == "decode":
            self._recover_decode_streams(worker)
        else:
            self._recover_prefill_streams(worker)

    def kill_decode_worker(self, idx: int):
        """Test/chaos hook: kill decode worker ``idx`` (the fleet notices
        via the lease and redrives its streams ``lease_misses`` ticks
        later)."""
        self.decode[idx].kill()

    def kill_prefill_worker(self, idx: int):
        self.prefill[idx].kill()

    # -- redrive: streams lost with a dead worker --------------------------
    def _terminal(self, rid: int) -> bool:
        return (rid in self._failures or rid in self._local_results
                or any(rid in w.server.results for w in self.prefill)
                or any(rid in d.server.results for d in self.decode))

    def _terminal_value(self, rid: int):
        """The terminal row or failure of ``rid``, or None while the
        stream is open."""
        if rid in self._failures:
            return self._failures[rid]
        if rid in self._local_results:
            return self._local_results[rid]
        for w in list(self.prefill) + list(self.decode):
            v = w.server.results.get(rid)
            if v is not None:
                return v
        return None

    def _journal_terminals(self):
        """Journal every terminal not yet written: completed ROWS ride
        the journal (first write wins), so finished results survive a
        whole-process crash without decoding again."""
        for rid in list(self._requests):
            if rid in self._journaled_terminals:
                continue
            v = self._terminal_value(rid)
            if v is None:
                continue
            self._jrec_terminal(rid, v)
            self._journaled_terminals.add(rid)
            self._journaled_progress.pop(rid, None)

    def _jrec_terminal(self, rid: int, v):
        if isinstance(v, RequestFailure):
            self._jrec({"k": "terminal", "rid": int(rid), "failure": {
                "reason": v.reason, "message": v.message,
                "tokens_emitted": int(v.tokens_emitted)}})
        else:
            self._jrec({"k": "terminal", "rid": int(rid),
                        "tokens": [int(t) for t in
                                   np.asarray(v).reshape(-1)]})

    def _jrec_removed_results(self, worker):
        """Journal every result of a worker leaving the fleet. A
        checkpoint holds a worker's results only in that worker's
        snapshot, which recovery no longer restores once the journal
        says it was removed, so each goes into the journal again (a
        terminal replays first write wins). The JAX package skips the
        ones its checkpoint marked journaled, and a recovery there loses
        them (``ROADMAP.md`` C)."""
        for rid, v in worker.server.results.items():
            self._jrec_terminal(rid, v)

    def _recover_decode_streams(self, d: DecodeWorker):
        """Every stream the dead decode worker owned — adopted, in flight
        on the wire, or queued for adoption — is redriven from the
        fleet's records; the corpse's ENGINE state is never read."""
        self.transport.drop_endpoint(d.name)
        self._pending_adopt[d.name].clear()
        self._assigned[d.name] = 0
        lost = [rid for rid, rec in self._handoffs.items()
                if rec["dst"] == d.name and not self._terminal(rid)]
        for rid in sorted(lost):
            self._redrive(rid)

    def _recover_prefill_streams(self, w: PrefillWorker):
        """A dead prefill worker's un-handed-off requests resubmit from
        the fleet's submission records under their ORIGINAL ids."""
        ep = fetch_endpoint(w.name)
        self.transport.drop_endpoint(ep)
        self._fetch_endpoints.discard(ep)
        lost = [rid for rid, rec in self._requests.items()
                if rec["worker"] == w.name and rid not in self._handoffs
                and not self._terminal(rid)]
        for rid in sorted(lost):
            self._reinject(rid, resume=None)

    def _request_from_record(self, rid: int, resume) -> Request:
        rec = self._requests[rid]
        kw = rec["kw"]
        return Request(
            request_id=rid, prompt=rec["prompt"],
            max_new_tokens=kw.get("max_new_tokens", 20),
            temperature=kw.get("temperature", 0.0),
            top_k=kw.get("top_k", 0), top_p=kw.get("top_p", 1.0),
            eos_token_id=kw.get("eos_token_id"),
            seed=kw.get("seed", 0), t_submit=rec["t_submit"],
            deadline_ticks=kw.get("deadline_ticks"),
            deadline_s=kw.get("deadline_s"),
            tenant=kw.get("tenant", "default"),
            priority=kw.get("priority", 0), resume=resume)

    def _reinject(self, rid: int, resume) -> bool:
        """Route a reconstructed request to a surviving prefill worker
        under its original id. False = nowhere to go / cannot fit — the
        stream fails explicitly as ``worker_lost``."""
        if rid not in self._requests:
            self._fail_handoff(rid, "worker_lost",
                               "no submission record to redrive from")
            return False
        eligible = self._routable_prefill()
        if not eligible:
            self._fail_handoff(rid, "worker_lost",
                               "no surviving prefill worker to redrive on")
            return False
        rec = self._requests[rid]
        req = self._request_from_record(rid, resume)
        pl = int(rec["prompt"].size)
        mnt = req.max_new_tokens
        if resume is not None and resume.tokens:
            pl += len(resume.tokens) - 1
            mnt = req.max_new_tokens - len(resume.tokens) + 1
        depths = [self.prefill[i].queue_depth() for i in eligible]
        wi = self.router.route(rec["prompt"], depths, eligible)
        w = self.prefill[wi]
        try:
            w.engine.validate_request(pl, mnt)
        except ValueError as e:
            self._fail_handoff(rid, "worker_lost",
                               f"redrive does not fit {w.name}: {e}",
                               tokens=len(resume.tokens)
                               if resume else 0)
            return False
        # visible on the target's own clock immediately; rec["worker"]
        # moves so a second failure redrives from the right place
        req.arrival_step = w.server._clock
        rec["worker"] = w.name
        w.server.inject(req)
        self.flight.record("redrive", rid=rid, to=w.name,
                           carried_tokens=len(resume.tokens)
                           if resume else 0, clock=self._clock)
        return True

    def _redrive(self, rid: int):
        """Rebuild one lost stream: carried tokens from the last
        heartbeat, the rng key host-replayed from the shipped key (one
        split per observed token), and the resume path doing the rest."""
        hrec = self._handoffs.pop(rid)
        toks = [int(t)
                for t in self._progress.pop(rid, hrec["tokens0"])]
        self._redrive_t0[rid] = time.perf_counter()
        key = _replay_key(hrec["key0"], len(toks) - hrec["base_len"])
        resume = ResumeState(tokens=toks, key=key,
                             t_admit=hrec["t_admit"], redrive=True)
        rec = self._requests.get(rid)
        if rec is not None:
            kw = rec["kw"]
            eos = kw.get("eos_token_id")
            mn = kw.get("max_new_tokens", 20)
            if len(toks) >= mn or (eos is not None and toks[-1] == eos):
                # the carried history already holds every token: complete
                # locally, eos-padded to max_new like Server._harvest
                out = list(toks) + [eos] * max(0, mn - len(toks))
                self._local_results[rid] = np.concatenate(
                    [rec["prompt"],
                     np.asarray(out, np.int32)]).astype(np.int32)
                self.redrives += 1
                _M_REDRIVES.inc()
                return
        if self._reinject(rid, resume):
            self.redrives += 1
            _M_REDRIVES.inc()

    def _gc_records(self):
        """Drop failure-domain records of streams that reached a terminal
        (every 64 ticks); open streams' records are the redrive
        substrate."""
        for rid in [r for r in self._requests if self._terminal(r)]:
            self._requests.pop(rid, None)
            self._handoffs.pop(rid, None)
            self._progress.pop(rid, None)
            self._journaled_progress.pop(rid, None)
        self._journaled_terminals &= set(self._requests)

    def _settle_redrives(self):
        for rid in list(self._redrive_t0):
            if self._terminal(rid):
                self.redrive_latencies.append(
                    time.perf_counter() - self._redrive_t0.pop(rid))

    # -- results / stats ---------------------------------------------------
    @property
    def results(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        for w in self.prefill:
            out.update(w.server.results)
        for d in self.decode:
            out.update(d.server.results)
        out.update(self._local_results)
        out.update(self._failures)
        return out

    def prefix_hit_rate(self) -> float:
        """Fleet-wide prefix-cache hit rate: shared / submitted prompt
        tokens over every prefill worker (0.0 on dense fleets)."""
        pt = sum(getattr(w.engine, "prompt_tokens", 0)
                 for w in self.prefill)
        st = sum(getattr(w.engine, "shared_tokens", 0)
                 for w in self.prefill)
        return st / pt if pt else 0.0

    def stats(self) -> dict:
        res = self.results
        completed = sum(1 for v in res.values()
                        if not isinstance(v, RequestFailure))
        wire, kv = self.handoff_wire_bytes, self.handoff_kv_bytes

        def mean(xs, scale=1.0, nd=1):
            return round(float(np.mean(xs)) * scale, nd) if xs else 0.0

        def pct(xs, q):
            return round(float(np.percentile(xs, q)), 4) if xs else None

        return {
            "requests_completed": completed,
            "requests_failed": len(res) - completed,
            "handoffs": self.handoffs,
            "handoff_wire_bytes_mean": mean(wire),
            "handoff_kv_bytes_mean": mean(kv),
            "handoff_ms_mean": {p: mean(v, 1e3, 4)
                                for p, v in self.handoff_timing.items()},
            "handoff_failures": dict(self._res.failures_by_reason),
            "handoff_retries": self._res.retries,
            "breaker_open": self._res.breaker_open,
            "affinity_routes": self.router.affinity_routes,
            "spillovers": self.router.spillovers,
            "prefix_hit_rate": round(self.prefix_hit_rate(), 4),
            "prefix_fetches": self.prefix_fetches,
            "prefix_fetch_blocks": self.prefix_fetch_blocks,
            "prefix_fetch_kv_bytes_mean": mean(self.prefix_fetch_kv_bytes),
            "prefix_fetch_failures": dict(self.prefix_fetch_failures),
            "prefix_fetch_duplicates": self.prefix_fetch_duplicates,
            "prefix_evictions": self.prefix_evictions,
            "prefix_directory": self.directory.stats()
            if self.prefix_cache_enabled else None,
            "migrations": self.migrations,
            "ticks": self._clock,
            "lease_misses": self.lease_misses,
            "workers_lost": self.workers_lost,
            "redrives": self.redrives,
            "redrive_latency_p50_s": pct(self.redrive_latencies, 50),
            "redrive_latency_p95_s": pct(self.redrive_latencies, 95),
            "duplicate_adopts": sum(d.duplicate_adopts
                                    for d in self.decode),
            "worker_states": {n: h["state"]
                              for n, h in sorted(self._health.items())},
            "transport": self.transport.stats()
            if hasattr(self.transport, "stats") else None,
            "durability": None if self.durability_dir is None else {
                "dir": self.durability_dir,
                "epoch": self._dur_epoch,
                "journal_seq": self._journal.seq,
                "journal_appends": self._journal.appends,
                "journal_bytes": self._journal.bytes_written,
                "journal_append_s": self._journal.append_s,
                "recoveries": self.recoveries,
                "last_recovery": self.last_recovery,
                "spill": self._spill.stats()
                if self._spill is not None else None},
            "prefill_workers": [
                {"name": w.name, "state": self._health[w.name]["state"],
                 "queue": w.queue_depth(),
                 "tokens_emitted": w.engine.tokens_emitted,
                 "block_pressure": round(
                     w.engine.manager.block_pressure(), 4)
                 if hasattr(w.engine, "manager") else 0.0,
                 "prefill_compiles": w.engine.prefill_compile_count(),
                 "decode_compiles": w.engine.decode_compile_count()}
                for w in self.prefill],
            "decode_workers": [
                {"name": d.name, "state": self._health[d.name]["state"],
                 "free_slots": d.free_slots(),
                 "draining": d.name in self._draining_decode,
                 "tokens_emitted": d.engine.tokens_emitted,
                 "block_pressure": round(
                     d.engine.manager.block_pressure(), 4)
                 if hasattr(d.engine, "manager") else 0.0,
                 "decode_compiles": d.engine.decode_compile_count()}
                for d in self.decode],
        }

    # -- the durable control plane: checkpoint / recover -------------------
    def checkpoint(self) -> str:
        """Coordinated fleet checkpoint at a tick boundary: snapshot every
        live worker's Server (un-shipped outboxes ride it), then commit
        the fleet's registries, topology and flight ring by renaming the
        epoch's manifest into place. The rename is THE commit: only after
        it does the journal rotate to a fresh segment (the old one is
        absorbed) and older epochs get pruned. A crash anywhere before it
        recovers from the previous epoch's manifest and journal. Returns
        the manifest path; ``last_checkpoint`` holds its bytes and the
        seconds of the snapshots and of the commit."""
        if self.durability_dir is None:
            raise RuntimeError(
                "fleet has no durability directory — construct with "
                "durability=<dir> to enable checkpoints")
        d = self.durability_dir
        epoch = self._dur_epoch + 1
        t0 = time.perf_counter()
        # recorded BEFORE the ring is captured, so the recovered fleet's
        # history includes it
        self.flight.record("checkpoint", epoch=epoch, clock=self._clock)
        workers, nbytes = [], 0
        for i, w in enumerate(self.prefill):
            if w.killed or not self._alive(w.name):
                continue        # a corpse's state is unreadable by
            snap = os.path.basename(    # contract; its streams redrive
                _dur.snapshot_path(d, epoch, w.name))
            w.server.snapshot(os.path.join(d, snap))
            nbytes += os.path.getsize(os.path.join(d, snap))
            workers.append({"name": w.name, "role": "prefill",
                            "snapshot": snap,
                            "draining": i in self._draining})
        for dw in self.decode:
            if dw.killed or not self._alive(dw.name):
                continue
            snap = os.path.basename(_dur.snapshot_path(d, epoch, dw.name))
            dw.server.snapshot(os.path.join(d, snap))
            nbytes += os.path.getsize(os.path.join(d, snap))
            workers.append({"name": dw.name, "role": "decode",
                            "snapshot": snap,
                            "draining": dw.name in self._draining_decode})
        t1 = time.perf_counter()
        manifest = {
            "clock": self._clock,
            "workers": workers,
            "requests": {str(rid): {
                "prompt": [int(t) for t in rec["prompt"]],
                "worker": rec["worker"],
                "kw": {k: _plain(v) for k, v in rec["kw"].items()}}
                for rid, rec in self._requests.items()},
            "handoffs": {str(rid): {
                "dst": h["dst"],
                "key0": [int(x) for x in np.asarray(h["key0"]).reshape(-1)],
                "base_len": int(h["base_len"]),
                "tokens0": [int(t) for t in h["tokens0"]],
                "t_admit": float(h["t_admit"])}
                for rid, h in self._handoffs.items()},
            "progress": {str(rid): [int(t) for t in toks]
                         for rid, toks in self._progress.items()},
            "failures": {str(rid): {
                "reason": f.reason, "message": f.message,
                "tokens_emitted": int(f.tokens_emitted)}
                for rid, f in self._failures.items()},
            "local_results": {str(rid): [int(t) for t in
                                         np.asarray(v).reshape(-1)]
                              for rid, v in self._local_results.items()},
            "router": {"affinity_routes": self.router.affinity_routes,
                       "spillovers": self.router.spillovers},
            "handoff_seq": self._handoff_seq,
            "fetch_seq": self._fetch_seq,
            "counters": {
                "handoffs": self.handoffs,
                "migrations": self.migrations,
                "redrives": self.redrives,
                "workers_lost": self.workers_lost,
                "prefix_evictions": self.prefix_evictions,
                "prefix_fetches": self.prefix_fetches,
                "prefix_fetch_blocks": self.prefix_fetch_blocks,
                "recoveries": self.recoveries},
            "flight": self.flight.to_meta(),
        }
        path = _dur.write_manifest(d, epoch, manifest)
        nbytes += os.path.getsize(path)
        # the commit landed: rotate to the fresh segment and remember what
        # the manifest already absorbed, so nothing is journaled twice
        self._journal.close()
        self._attach_durability(d, epoch)
        self._journaled_terminals = {
            rid for rid in self._requests if self._terminal(rid)}
        self._journaled_progress = {
            rid: len(toks) for rid, toks in self._progress.items()}
        self._prune_durability(epoch)
        self.last_checkpoint = {"epoch": epoch, "bytes": nbytes,
                                "snapshot_s": t1 - t0,
                                "commit_s": time.perf_counter() - t1}
        return path

    def _prune_durability(self, keep_epoch: int):
        """Delete the manifests, journals and snapshots of epochs older
        than ``keep_epoch`` (orphans of checkpoints that crashed before
        their commit included). ``keep_epoch`` is the epoch just
        committed or just recovered from: never deleted."""
        d = self.durability_dir
        for name in os.listdir(d):
            for pfx in ("manifest-", "journal-", "ckpt-"):
                if not name.startswith(pfx):
                    continue
                stem = name[len(pfx):].split("-", 1)[0].split(".", 1)[0]
                if stem.isdigit() and int(stem) < keep_epoch:
                    try:
                        os.remove(os.path.join(d, name))
                    except OSError:
                        pass

    @classmethod
    def recover(cls, dirname: str, *, engine_factory,
                transport: Optional[Transport] = None,
                **fleet_kw) -> "Fleet":
        """Cold-start recovery of a whole killed fleet from a durability
        directory written by either package: load the newest VALID
        manifest (torn ones discarded with a warning), replay the
        journal's tail (a torn tail truncated with a warning), rebuild
        every worker through ``engine_factory(role, name)`` and
        ``Server.restore`` (which copies the state into the tensors the
        engine's graphs captured), purge the streams the journal knows
        concluded, and REDRIVE every stream that was in flight — queued,
        mid-prefill, shipped, adopted — with the host-replayed key, so the
        rows it completes equal a run that was never killed. The fleet
        goes on journaling into the same epoch's segment.
        ``last_recovery`` holds the records replayed, the streams
        redriven and the seconds of each part (manifest, replay, build,
        restore, redrive)."""
        t0 = time.perf_counter()
        epoch, manifest = _dur.load_latest_manifest(dirname)
        if manifest is None:
            epochs = _dur.list_epochs(dirname, "journal") \
                if os.path.isdir(dirname) else []
            if not epochs:
                raise FileNotFoundError(
                    f"no checkpoint manifest or journal under {dirname!r} "
                    "— nothing to recover")
            epoch = epochs[-1]
        t1 = time.perf_counter()
        records, torn = _dur.WriteAheadJournal.replay(
            _dur.journal_path(dirname, epoch))
        t2 = time.perf_counter()
        # -- topology: the manifest's workers (or the journal's genesis),
        # then the journal's scale and death records in order --
        if manifest is not None:
            spec = [dict(e) for e in manifest["workers"]]
        else:
            gen = next((r for r in records if r.get("k") == "genesis"),
                       None)
            if gen is None:
                raise RuntimeError(
                    f"journal epoch {epoch} has no genesis record and no "
                    "manifest — cannot derive the fleet topology")
            spec = [{"name": n, "role": "prefill", "snapshot": None,
                     "draining": False} for n in gen["prefill"]] \
                + [{"name": n, "role": "decode", "snapshot": None,
                    "draining": False} for n in gen["decode"]]
        for r in records:
            if r.get("k") != "scale":
                continue
            a, n = r["action"], r["worker"]
            if a == "add_decode":
                spec.append({"name": n, "role": "decode",
                             "snapshot": None, "draining": False})
            elif a in ("remove_decode", "remove_prefill", "dead"):
                spec = [e for e in spec if e["name"] != n]
            elif a in ("drain_decode", "drain_prefill"):
                for e in spec:
                    if e["name"] == n:
                        e["draining"] = True
            elif a == "undrain_decode":
                for e in spec:
                    if e["name"] == n:
                        e["draining"] = False
        pws: List[PrefillWorker] = []
        dws: List[DecodeWorker] = []
        build_s = restore_s = 0.0
        for e in spec:
            tb = time.perf_counter()
            eng = engine_factory(e["role"], e["name"])
            tr = time.perf_counter()
            build_s += tr - tb
            srv = None
            if e.get("snapshot"):
                srv = Server.restore(os.path.join(dirname, e["snapshot"]),
                                     eng)
            restore_s += time.perf_counter() - tr
            if e["role"] == "prefill":
                pws.append(PrefillWorker(eng, name=e["name"], server=srv))
            else:
                dws.append(DecodeWorker(eng, name=e["name"], server=srv))
        t3 = time.perf_counter()
        fleet = cls(pws, dws, transport=transport, **fleet_kw)
        # -- registries: the manifest's, then the journal's records in
        # order (idempotent: progress only extends, terminals first write
        # wins) --
        if manifest is not None:
            fleet._clock = int(manifest.get("clock", 0))
            now = time.perf_counter()
            for rid_s, m in manifest["requests"].items():
                fleet._requests[int(rid_s)] = {
                    "prompt": np.asarray(m["prompt"], np.int32),
                    "worker": m["worker"], "t_submit": now,
                    "kw": dict(m["kw"])}
            for rid_s, m in manifest["handoffs"].items():
                fleet._handoffs[int(rid_s)] = {
                    "dst": m["dst"],
                    "key0": np.asarray(m["key0"], np.uint32),
                    "base_len": int(m["base_len"]),
                    "tokens0": list(m["tokens0"]),
                    "t_admit": float(m["t_admit"])}
            fleet._progress = {int(r): list(t) for r, t in
                               manifest["progress"].items()}
            for rid_s, m in manifest["failures"].items():
                rid = int(rid_s)
                fleet._failures[rid] = RequestFailure(
                    request_id=rid, reason=m["reason"],
                    message=m["message"],
                    tokens_emitted=int(m["tokens_emitted"]))
            fleet._local_results = {
                int(r): np.asarray(t, np.int32)
                for r, t in manifest["local_results"].items()}
            fleet.router.affinity_routes = \
                int(manifest["router"]["affinity_routes"])
            fleet.router.spillovers = int(manifest["router"]["spillovers"])
            fleet._handoff_seq = int(manifest["handoff_seq"])
            fleet._fetch_seq = int(manifest["fetch_seq"])
            c = manifest.get("counters", {})
            fleet.handoffs = int(c.get("handoffs", 0))
            fleet.migrations = int(c.get("migrations", 0))
            fleet.redrives = int(c.get("redrives", 0))
            fleet.workers_lost = int(c.get("workers_lost", 0))
            fleet.prefix_evictions = int(c.get("prefix_evictions", 0))
            fleet.prefix_fetches = int(c.get("prefix_fetches", 0))
            fleet.prefix_fetch_blocks = int(c.get("prefix_fetch_blocks", 0))
            fleet.recoveries = int(c.get("recoveries", 0))
            # the fleet's flight ring survives the crash with continuing
            # seqs
            fleet.flight.restore_meta(manifest["flight"])
        name_to_pi = {w.name: i for i, w in enumerate(fleet.prefill)}
        for e in spec:
            if e.get("draining"):
                if e["role"] == "prefill":
                    fleet._draining.add(name_to_pi[e["name"]])
                else:
                    fleet._draining_decode.add(e["name"])
        now = time.perf_counter()
        for r in records:
            k = r.get("k")
            if k == "submit":
                fleet._requests[int(r["rid"])] = {
                    "prompt": np.asarray(r["prompt"], np.int32),
                    "worker": r["worker"], "t_submit": now,
                    "kw": dict(r["kw"])}
            elif k == "ship":
                rid = int(r["rid"])
                fleet._handoffs[rid] = {
                    "dst": r["dst"],
                    "key0": np.asarray(r["key0"], np.uint32),
                    "base_len": int(r["base_len"]),
                    "tokens0": list(r["tokens0"]),
                    "t_admit": float(r["t_admit"])}
                fleet._progress[rid] = list(r["tokens0"])
                fleet._handoff_seq = max(fleet._handoff_seq, int(r["seq"]))
            elif k == "progress":
                rid = int(r["rid"])
                cur = fleet._progress.get(rid)
                base = int(r["base"])
                if cur is None or base > len(cur):
                    continue        # its ship record fell in a torn tail:
                cand = cur[:base] + list(r["ext"])  # the redrive uses
                if len(cand) > len(cur):            # what stands
                    fleet._progress[rid] = cand
            elif k == "terminal":
                rid = int(r["rid"])
                if fleet._terminal(rid):
                    continue                # first write wins
                if "failure" in r:
                    f = r["failure"]
                    fleet._failures[rid] = RequestFailure(
                        request_id=rid, reason=f["reason"],
                        message=f["message"],
                        tokens_emitted=int(f["tokens_emitted"]))
                else:
                    fleet._local_results[rid] = np.asarray(r["tokens"],
                                                           np.int32)
        # fresh submissions never reuse a pre-crash id: every prefill
        # server's allocator moves past the ids its range is known to
        # have issued (the snapshots cover their own; ids issued after
        # the checkpoint exist only in the journal)
        known = set(fleet._requests) | set(fleet._failures) \
            | set(fleet._local_results)
        for i, w in enumerate(fleet.prefill):
            base, hi = (i + 1) * 1_000_000, (i + 2) * 1_000_000
            mx = max((rid for rid in known if base <= rid < hi),
                     default=None)
            if mx is not None and w.server._next_id <= mx:
                w.server._next_id = mx + 1
        fleet._attach_durability(dirname, epoch)
        fleet._journaled_progress = {
            rid: len(toks) for rid, toks in fleet._progress.items()}
        fleet._journaled_terminals = {
            rid for rid in fleet._requests if fleet._terminal(rid)}
        # -- purge: a stream the control plane knows concluded must not
        # decode again on a restored worker (one terminal per request
        # across the crash) --
        fleet._purge_terminal_streams()
        t4 = time.perf_counter()
        # -- redrive: everything in flight that no restored worker owns
        # is rebuilt from the records, as if its owner alone had died --
        owned = fleet._owned_rids()
        redriven = 0
        for rid in sorted(fleet._requests):
            if rid in owned or fleet._terminal(rid):
                continue
            redriven += 1
            if rid in fleet._handoffs:
                fleet._redrive(rid)
            else:
                fleet._reinject(rid, None)
        t5 = time.perf_counter()
        fleet.recoveries += 1
        fleet.last_recovery = {
            "epoch": int(epoch), "replayed": len(records),
            "torn_tail": bool(torn), "redriven": redriven,
            "workers": len(spec),
            "seconds": {"manifest": t1 - t0, "replay": t2 - t1,
                        "build": build_s, "restore": restore_s,
                        "registries": t4 - t3, "redrive": t5 - t4}}
        _dur._M_J_REPLAYS.inc(len(records))
        _dur._M_CKPT_RECOVERIES.inc()
        fleet.flight.record("recovered", epoch=int(epoch),
                            clock=fleet._clock, replayed=len(records),
                            redriven=redriven)
        return fleet

    def _owned_rids(self) -> set:
        """Every id a restored worker holds live — queued, mid-prefill,
        parked in an outbox (its run occupies the slot) or decoding.
        Owned streams finish on their own, bit for bit: the decode block
        is a pure function of the restored state."""
        owned = set()
        for worker in list(self.prefill) + list(self.decode):
            for r in worker.server.scheduler._queue:
                owned.add(r.request_id)
            for _slot, run in worker.engine.live_runs():
                owned.add(run.request.request_id)
        return owned

    def _purge_terminal_streams(self):
        done = [rid for rid in self._requests if self._terminal(rid)]
        for rid in done:
            for w in self.prefill:
                self._purge_from_worker(w, rid, prefill=True)
            for d in self.decode:
                self._purge_from_worker(d, rid, prefill=False)

    def _purge_from_worker(self, worker, rid: int, prefill: bool):
        """Remove every live trace of a concluded stream from a restored
        worker — queue entry, outbox hold, occupied slot — and the
        cancel's own result, so the server never harvests a SECOND
        terminal for the id."""
        eng = worker.engine
        worker.server.scheduler.drop_where(lambda r: r.request_id == rid)
        if prefill:
            for ph in list(eng._outbox):
                if ph.run.request.request_id == rid:
                    eng._outbox.remove(ph)
                    eng.release_handoff(ph)
        for slot, run in eng.live_runs():
            if run.request.request_id == rid:
                eng.cancel_slot(slot, "recovered_terminal")
        eng._finished = [r for r in eng._finished
                         if r.request.request_id != rid]

    # -- scale / migration -------------------------------------------------
    def add_decode_worker(self, worker: DecodeWorker):
        """Scale up the decode pool mid-stream; the least-loaded pick
        starts routing payloads to it on the next tick. Same
        compatibility contract as construction. The ``fleet.scale``
        fault site fires BEFORE any state mutates."""
        faults.fault_point("fleet.scale")
        self._check_engine_compat(worker.engine, self.prefill[0].engine)
        worker.name = worker.name or f"decode{len(self.decode)}"
        if worker.name in self._health:
            raise ValueError(f"decode worker name {worker.name!r} "
                             "already in the fleet")
        self.decode.append(worker)
        self._pending_adopt[worker.name] = deque()
        self._assigned[worker.name] = 0
        self._health[worker.name] = {"state": "live", "misses": 0}
        _M_WORKER_STATE.set(1, worker=worker.name)
        if self._journal is not None:
            self._jrec({"k": "scale", "action": "add_decode",
                        "worker": worker.name})

    def _decode_index_name(self, idx: int) -> str:
        if not 0 <= idx < len(self.decode):
            raise ValueError(f"no decode worker at index {idx}")
        return self.decode[idx].name

    def drain_decode_worker(self, idx: int):
        """Stop routing new handoffs to decode worker ``idx``; its
        in-flight streams finish in place. Idempotent; refuses to drain
        the last routable decode worker."""
        faults.fault_point("fleet.scale")
        name = self._decode_index_name(idx)
        if name in self._draining_decode:
            return
        routable = [d.name for d in self._live_decode()
                    if d.name not in self._draining_decode
                    and d.name != name]
        if not routable:
            raise ValueError("cannot drain the last routable decode "
                             "worker")
        self._draining_decode.add(name)
        self.flight.record("decode_drain", worker=name, clock=self._clock)
        if self._journal is not None:
            self._jrec({"k": "scale", "action": "drain_decode",
                        "worker": name})

    def undrain_decode_worker(self, idx: int):
        """Cancel a pending drain: the worker becomes routable again."""
        faults.fault_point("fleet.scale")
        name = self._decode_index_name(idx)
        if name in self._draining_decode:
            self._draining_decode.discard(name)
            self.flight.record("decode_undrain", worker=name,
                               clock=self._clock)
            if self._journal is not None:
                self._jrec({"k": "scale", "action": "undrain_decode",
                            "worker": name})

    def remove_decode_worker(self, idx: int) -> DecodeWorker:
        """Scale down: remove a DRAINED decode worker. Refused while the
        worker still owns streams; dead workers are not removable (their
        tombstones keep the name reserved)."""
        faults.fault_point("fleet.scale")
        self._decode_index_name(idx)
        d = self.decode[idx]
        if not self._alive(d.name):
            raise RuntimeError(
                f"decode worker {d.name!r} is dead — its streams were "
                "redriven and its tombstone stays")
        if len(self._live_decode()) < 2:
            raise ValueError("cannot remove the last live decode worker")
        if (d.busy() or self._pending_adopt[d.name]
                or self._assigned[d.name]):
            raise RuntimeError(
                f"decode worker {d.name!r} still owns streams — drain "
                "and run the fleet idle first")
        # results are fleet-durable: the worker's completed streams
        # survive its removal
        self._local_results.update(d.server.results)
        self.decode.pop(idx)
        self._draining_decode.discard(d.name)
        self._pending_adopt.pop(d.name, None)
        self._assigned.pop(d.name, None)
        self._health.pop(d.name, None)
        self.directory.drop_worker(d.name)
        self.transport.drop_endpoint(d.name)
        _M_WORKER_STATE.set(0, worker=d.name)
        self.flight.record("decode_remove", worker=d.name,
                           clock=self._clock)
        if self._journal is not None:
            self._jrec_removed_results(d)
            self._journal_terminals()
            self._jrec({"k": "scale", "action": "remove_decode",
                        "worker": d.name})
        return d

    def migrate_decode_worker(self, idx: int, engine,
                              path: str) -> DecodeWorker:
        """Live migration = Server snapshot/restore: snapshot worker
        ``idx`` at a tick boundary, restore into a freshly constructed
        engine of the same configuration (its graphs captured anew, the
        state copied into the tensors they read), and swap it in under
        the SAME name. Every in-flight stream finishes identical."""
        old = self.decode[idx]
        if old.killed or not self._alive(old.name):
            raise RuntimeError(
                "cannot migrate a dead worker — its state is unreadable "
                "by contract; its streams redrive instead")
        old.server.snapshot(path)
        srv = Server.restore(path, engine)
        new = DecodeWorker(engine, name=old.name, server=srv)
        new._adopted = set(old._adopted)     # the dedup history moves
        self.decode[idx] = new               # with the identity
        self._health[old.name] = {"state": "live", "misses": 0}
        _M_WORKER_STATE.set(1, worker=old.name)
        self.migrations += 1
        _M_MIGRATIONS.inc()
        return new

    def drain_prefill_worker(self, idx: int):
        """Stop routing new work to prefill worker ``idx``; once idle it
        can be removed. Idempotent."""
        if not 0 <= idx < len(self.prefill):
            raise ValueError(f"no prefill worker at index {idx}")
        if idx in self._draining:
            return
        if len([i for i in self._routable_prefill() if i != idx]) < 1:
            raise ValueError("cannot drain the last routable prefill "
                             "worker")
        self._draining.add(idx)
        if self._journal is not None:
            self._jrec({"k": "scale", "action": "drain_prefill",
                        "worker": self.prefill[idx].name})

    def remove_prefill_worker(self, idx: int):
        if self.prefill[idx].busy():
            raise RuntimeError("prefill worker still busy — drain and "
                               "run the fleet idle first")
        self._draining.discard(idx)
        w = self.prefill.pop(idx)
        # results are fleet-durable (requests finished at prefill)
        self._local_results.update(w.server.results)
        self._health.pop(w.name, None)
        self.directory.drop_worker(w.name)
        ep = fetch_endpoint(w.name)
        self.transport.drop_endpoint(ep)
        self._fetch_endpoints.discard(ep)
        self._draining = {i - 1 if i > idx else i
                          for i in self._draining}
        if self._journal is not None:
            self._jrec_removed_results(w)
            self._jrec({"k": "scale", "action": "remove_prefill",
                        "worker": w.name})
        return w
