"""Continuous-batching decode engine: a fixed pool of S sequence slots
whose per-slot state lives on the device.

Counterpart of ``paddle_tpu/serving/engine.py``: per-slot sampling, the
slot state, the decode block, the dense engine (``ModelStepBackend``: a
(S, max_len) KV cache per layer, prompts left-padded to a bucket and
prefilled at batch 1 into a row that admission splices into the slot)
and the host logic of ``ContinuousBatchingEngine``, which
``ContinuousBatchingEngine(..., paged=True)`` hands to the paged engine
(``serving.paging``). The JAX engine
compiles the block as one ``lax.scan`` program; here the block is a
Python loop of ``decode_block`` steps over device tensors, which each
backend captures as one CUDA graph on the card and replays
(``graphs``), and runs eagerly on the CPU. The host syncs ONCE
per block, as there. The JAX slot state is a pytree replaced by each
program; here it is one dict of tensors that every block and every
arm, cancel and reset updates in place, so the graph reads and writes
the same memory on every replay. Sampling draws from threefry keys
(``paddle_tpu_torch.random``) on the JAX key schedule, so seeded sampled
streams match the JAX package token for token.

The resilience mechanism is JAX's (``paddle_tpu/serving/engine.py``
``step_block`` to ``restore``): the captured block also emits per-row
NaN sentinel flags; a block is dispatched, then harvested, with the
``serving.poison`` and ``serving.step_block`` fault sites before the
replay and ``serving.harvest`` between the replay and the host read, so
a retried harvest reads the parked static output without replaying; a
NaN row is quarantined alone; and the whole engine state snapshots to
host arrays and restores by copying into the tensors the captured
graphs read. Preemption is JAX's mechanism too (``preempt_slot``,
``can_resume``, the resume admission that re-prefills prompt and
history); the weight-only quantized backends (``serving.quant``) and the
speculative engines (``serving.spec``) build on these classes."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as prng
from ..models.generation import decode_step_logprobs
from ..observability import metrics as _om
from ..observability.tracing import now_us as _trace_now
from ..ops.decode_layer import FusedDecode
from ..profiler import RecordEvent
from ..utils import faults
from ..utils.flags import env_bool, env_flag
from ..graphs import CapturedProgram
from .handoff import _BF16_WIRE, leaf_to_wire

# engine metric families (JAX's names; no-ops until metrics.enable() /
# PT_METRICS)
_M_STEPS = _om.counter("pt_engine_decode_steps_total",
                       "decode-block steps executed")
_M_TOKENS = _om.counter("pt_engine_tokens_emitted_total",
                        "useful tokens emitted (prefill + decode)")
_M_DECODE_TOKENS = _om.counter("pt_engine_decode_tokens_total",
                               "live-slot decode tokens emitted")
_M_COMPILES = _om.gauge("pt_engine_decode_compiles",
                        "times the decode-block program was traced "
                        "(static-shape invariant: stays 1)")
_M_PREFILLS = _om.counter("pt_engine_prefills_total",
                          "prefill dispatches (whole-prompt or chunk)")
_M_BYTES = _om.counter(
    "pt_serving_decode_bytes_read_total",
    "estimated HBM bytes read by decode steps (weights + buffers + "
    "KV pool, capacity-based — the quant-vs-fp32 A/B numerator)")
_M_W_BYTES = _om.gauge(
    "pt_serving_decode_weight_bytes",
    "weight + buffer bytes one decode step reads (codes + scales "
    "under weight-only quant)")
_M_KV_BYTES = _om.gauge(
    "pt_serving_decode_kv_bytes",
    "KV pool bytes resident per decode step (codes + scales under "
    "the int8 arena)")

__all__ = ["slot_sample_logits", "init_slot_state", "free_slot_state",
           "run_decode_block", "ModelStepBackend",
           "ContinuousBatchingEngine"]


def slot_sample_logits(logits: torch.Tensor, temperature: torch.Tensor,
                       top_k: torch.Tensor, top_p: torch.Tensor,
                       keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-slot sampling over (S, V) logits or log-probs: greedy rows
    (temperature <= 0) take argmax; every row runs ONE descending sort
    for both the top-k threshold and the top-p cutoff (the JAX
    package's filter) and draws ``jax.random.categorical`` with its own
    (S, 2) threefry key, and ``where`` keeps the greedy rows' argmax, as
    the JAX function does: the work depends on the shapes alone, not on
    which rows sample. Without ``keys`` every row is greedy. Returns
    (S,) int32."""
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None:
        return greedy_tok
    V = logits.shape[1]
    neg_inf = float("-inf")
    greedy = temperature <= 0.0
    t = torch.where(greedy, torch.ones_like(temperature), temperature)
    scaled = logits / t[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = top_k.to(torch.int64).clamp(0, V)
    use_k = (k > 0) & (k < V)
    kth = torch.gather(sorted_desc, 1, (k - 1).clamp(min=0)[:, None])
    kth = torch.where(use_k[:, None], kth, neg_inf)
    filt = torch.where(scaled < kth, neg_inf, scaled)
    # masking below-kth values inside the sorted array == re-sorting the
    # filtered row (kept prefix unchanged, dropped tail -> -inf)
    sorted_f = torch.where(sorted_desc < kth, neg_inf, sorted_desc)
    cum = torch.cumsum(torch.softmax(sorted_f, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1, keepdim=True) \
        .clamp(0, V - 1)
    cutoff = torch.gather(sorted_f, 1, cutoff_idx)
    cutoff = torch.where((top_p < 1.0)[:, None], cutoff, neg_inf)
    filt = torch.where(filt < cutoff, neg_inf, filt)
    drawn = prng.categorical(keys, filt).to(torch.int32)
    return torch.where(greedy, greedy_tok, drawn)


# name: (dtype, value of a free slot); "key" is (S, 2) uint32 words
_SLOT_FIELDS = {"tok": (torch.int32, 0), "pos": (torch.int32, 0),
                "pad": (torch.int32, 0),
                "live": (torch.bool, False), "eos": (torch.int32, -1),
                "remaining": (torch.int32, 0), "key": (torch.int64, 0),
                "temp": (torch.float32, 0.0), "topk": (torch.int32, 0),
                "topp": (torch.float32, 1.0)}


def init_slot_state(num_slots: int, device) -> Dict[str, torch.Tensor]:
    """Fresh all-slots-free state on ``device``."""
    return {name: torch.full((num_slots, 2) if name == "key"
                             else (num_slots,), fill, dtype=dtype,
                             device=device)
            for name, (dtype, fill) in _SLOT_FIELDS.items()}


def free_slot_state(state: Dict[str, torch.Tensor]):
    """Free every slot of ``state`` in place (its tensors keep their
    memory, which a captured decode block reads)."""
    for name, (_, fill) in _SLOT_FIELDS.items():
        state[name].fill_(fill)


def run_decode_block(step, state: Dict[str, torch.Tensor],
                     out: torch.Tensor):
    """The engine's decode block (``build_slot_block_fn``): ``block``
    steps of per-slot key split -> forward -> per-slot sampling ->
    eos/budget retirement, all on the device. ``step(tok, pos, aux)``
    returns (S, V) log-probs; ``aux`` is the block table when ``state``
    has one (paged) and the per-slot pad counts otherwise (dense). Dead
    slots' tables are redirected to the trash block 0, so a retired slot
    whose blocks the host has handed to another request never writes
    into them; a dead dense slot writes junk into its own row, which the
    next admission replaces whole.

    As in JAX, every step splits every slot's key and samples every row:
    the work depends on the engine's shapes alone (one captured graph
    serves any traffic), and the keys follow the JAX schedule. ``state``
    is updated in place at the block's end. ``out`` is the static
    (3 * block + 1, S) int32 output: rows [0, block) the tokens, rows
    [block, 2 * block) the start-of-step live masks (the host counts
    emissions from ``live``: an eos retirement zeroes ``remaining``),
    rows [2 * block, 3 * block) the ``ok`` flags (1 iff the row's
    log-probs held no NaN — numerically impossible from finite weights
    and cache, so a 0 means corrupted state; the sentinel the server
    quarantines a poisoned slot by), the last row the remaining
    counters after the block."""
    block = (out.shape[0] - 1) // 3
    paged = "table" in state
    st = dict(state)
    for i in range(block):
        live = st["live"]
        aux = torch.where(live[:, None], st["table"], 0) if paged \
            else st["pad"]
        logp = step(st["tok"][:, None], st["pos"], aux)
        sp = prng.split(st["key"])                         # (S, 2, 2)
        nxt = slot_sample_logits(logp, st["temp"], st["topk"], st["topp"],
                                 sp[:, 1])
        hit = live & (st["eos"] >= 0) & (nxt == st["eos"])
        rem = torch.where(live, st["remaining"] - 1, st["remaining"])
        rem = torch.where(hit, 0, rem)
        out[i].copy_(nxt)
        out[block + i].copy_(live)
        out[2 * block + i].copy_(~torch.isnan(logp).any(dim=-1))
        st = dict(st, tok=torch.where(live, nxt, st["tok"]),
                  pos=st["pos"] + live.to(torch.int32),
                  remaining=rem, key=sp[:, 0], live=live & (rem > 0))
    for name in ("tok", "pos", "remaining", "key", "live"):
        state[name].copy_(st[name])
    out[3 * block].copy_(state["remaining"])


def _cancel_fn(state: Dict[str, torch.Tensor], slot: int):
    """Kill one slot on the device: ``live`` drops and ``remaining``
    zeroes, so the next decode block treats the row as retired junk
    (and redirects its table to the trash block)."""
    state["live"][slot] = False
    state["remaining"][slot] = 0


def _arm_fn(state: Dict[str, torch.Tensor], slot: int, **values):
    """Turn a slot live whose prompt's K/V the cache already holds (the
    state half of the JAX ``_admit_fn``): write each given field of the
    slot's state, in place."""
    for name, value in values.items():
        state[name][slot] = value


def _checked_step(model, cache, fused_decode, tok, pos, **aux):
    """A decode step's log-probs (``aux``: the block table or the pad
    counts); with the megakernel requested, a step that routed no layer
    through the fused call raises."""
    logp = decode_step_logprobs(model, tok, cache, pos,
                                fused_decode=fused_decode, **aux)
    if fused_decode is not None and fused_decode.rewrites == 0:
        raise RuntimeError(
            "megakernel decode requested but no decode layer went through "
            "the fused call — the model must route its decode layers (see "
            "models/llama.py LlamaDecoderLayer._fused_decode)")
    return logp


class ModelStepBackend:
    """The dense engine's programs over a live model (the JAX
    ``ModelStepBackend``): the decode block over the (S, max_len) pool
    cache with per-slot positions and pad counts, and one batch-1
    prefill per prompt bucket, which zeroes a static (1, max_len) row,
    prefills the left-padded prompt into it at position 0 and samples
    the first token with the request's own parameters
    (``build_slot_prefill_fn``). :meth:`splice` copies the row into a
    slot of the pool. With ``megakernel`` every decode step routes each
    layer through the fused decode-layer call, which never takes the
    dense mode (as in JAX): the rewrites are counted and the unfused
    layer runs.

    The programs work on static tensors the backend owns: the pool, the
    row, the slot ``state``, the block's output and the prefill's
    inputs and output. On the card the decode block is captured once,
    here at construction while every slot is free (its warm-up writes
    junk into the free rows, which admissions replace whole), and each
    bucket's prefill once, at its first admission, like JAX's
    per-bucket prefill jits; each call replays the graph. The prefill
    programs share one memory pool (each leaves its results in the row
    and the static token), so an engine without buckets, which captures
    one per prompt length, holds the pool of its longest prefill, not
    one pool per length. On the CPU each call runs the same function
    eagerly. With ``decode=False`` (the fleet's prefill-only engine,
    ``serving.fleet``) no decode program is built."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, megakernel: bool = False, quant=None,
                 decode: bool = True):
        self.device = dev = model.device
        self.quant_cfg = quant
        self.model, self.weight_bound = self._serving_copy(model, quant)
        self.num_slots, self.max_len = num_slots, max_len
        self.block_size = decode_block
        self.cache = self.model.init_kv_cache(num_slots, max_len)
        self.row = self.model.init_kv_cache(1, max_len)
        self.fused_decode = FusedDecode() if megakernel else None
        self.state = init_slot_state(num_slots, dev)
        self._block_out = torch.zeros((3 * decode_block + 1, num_slots),
                                      dtype=torch.int32, device=dev)
        # the prefill's inputs besides the ids, filled by one copy:
        # (pad, top-k), then (temperature, top-p) as fp32 bits; the key
        # and the first token
        self._prefill_args = torch.zeros(4, dtype=torch.int32, device=dev)
        self._prefill_key = torch.zeros(2, dtype=torch.int64, device=dev)
        self._prefill_tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self._prefills = {}        # bucket length -> (ids, program)
        self._prefill_pool = torch.cuda.graph_pool_handle() \
            if dev.type == "cuda" else None
        self.decode_program = _decode_program(self._decode_fn(), dev,
                                              decode)
        self.decode_program.capture()
        self.reset_state()

    def _serving_copy(self, model, quant):
        """(the model the programs run, the weight error bound): see
        :func:`_serving_model` (the tensor-parallel backends return
        their sharded model, ``serving.tp``)."""
        return _serving_model(model, quant)

    @property
    def pool_specs(self):
        """``((shape, dtype name), ...)`` of the pool's tensors in the
        JAX cache order (the JAX backend's ``pool_specs``, dtypes by
        name): the layout a snapshot or a fleet handoff must match."""
        return _pool_specs(self.caches())

    def _decode_fn(self):
        """The function the decode program captures: the decode block
        (the speculative backends capture their verify step instead)."""
        return self._run_block

    def reset_state(self):
        """Free every slot and zero the pool, in place (the JAX engine
        starts from a fresh zero pool); returns the state dict the
        decode block reads."""
        free_slot_state(self.state)
        for layer in self.cache:
            for t in layer:
                t.zero_()
        return self.state

    def prefill_programs(self) -> Dict[int, CapturedProgram]:
        """The prefill program of each bucket admitted so far."""
        return {n: prog for n, (_, prog) in self._prefills.items()}

    def _step(self, tok, pos, pad):
        return _checked_step(self.model, self.cache, self.fused_decode, tok,
                             pos, pad=pad)

    def _run_block(self):
        run_decode_block(self._step, self.state, self._block_out)

    def decode_block(self) -> torch.Tensor:
        """Run one decode block over ``state`` (in place); returns the
        static (3 * block + 1, S) int32 output of
        :func:`run_decode_block`, valid until the next block."""
        self.decode_program()
        return self._block_out

    def caches(self) -> List[torch.Tensor]:
        """The pool's tensors in the JAX cache order (each layer's k,
        then v): what the decode graph reads and snapshots save."""
        return [t for layer in self.cache for t in layer]

    def _run_prefill(self, ids):
        for layer in self.row:
            for t in layer:
                t.zero_()
        args = self._prefill_args
        pad, topk = args[0:2].split(1)
        temp, topp = args[2:4].view(torch.float32).split(1)
        logp = decode_step_logprobs(self.model, ids, self.row, 0, pad=pad)
        self._prefill_tok.copy_(slot_sample_logits(
            logp, temp, topk, topp, self._prefill_key[None]))

    def prefill(self, ids: np.ndarray, pad: int, key: torch.Tensor,
                temperature: float, top_k: int,
                top_p: float) -> torch.Tensor:
        """Prefill one left-padded (1, bucket) prompt with ``pad`` filler
        columns into the zeroed row and sample its first token with
        ``key`` (2,) and the request's parameters; returns the static
        (1,) int32 token on the device, valid until the next prefill."""
        Lb = ids.shape[1]
        host = np.empty(4, np.int32)
        host[:2] = (pad, top_k)
        host[2:] = np.array([temperature, top_p], np.float32).view(np.int32)
        self._prefill_args.copy_(torch.from_numpy(host))
        self._prefill_key.copy_(key)
        entry = self._prefills.get(Lb)
        if entry is None:
            buf = torch.zeros((1, Lb), dtype=torch.int32, device=self.device)
            prog = CapturedProgram(lambda: self._run_prefill(buf),
                                   self.device, self._prefill_pool)
            entry = self._prefills[Lb] = (buf, prog)
            buf.copy_(torch.from_numpy(ids))
            prog.capture()
        entry[0].copy_(torch.from_numpy(ids))
        entry[1]()
        return self._prefill_tok

    def splice(self, slot: int):
        """Copy the prefilled row into ``slot`` of the pool (the cache
        half of the JAX ``_admit_fn``); the other rows are untouched."""
        for (pk, pv), (rk, rv) in zip(self.cache, self.row):
            pk[slot].copy_(rk[0])
            pv[slot].copy_(rv[0])


class _NoDecodeProgram:
    """The decode program of a prefill-only backend (the fleet's prefill
    engines, ``serving.fleet``): nothing is captured, so no graph pool
    holds memory, and a call raises — such an engine arms no slot, and a
    decode block run eagerly on the card would be a quiet fallback."""
    captures = 0
    capture_s = 0.0
    graph_bytes = 0

    def capture(self):
        pass

    def __call__(self):
        raise RuntimeError("this backend was built without a decode "
                           "program (a prefill-only engine decodes "
                           "nothing)")


def _decode_program(fn, device, decode: bool):
    return CapturedProgram(fn, device) if decode else _NoDecodeProgram()


def _pool_specs(caches) -> tuple:
    return tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                 for t in caches)


def _serving_model(model, quant):
    """(the model the backend's programs run, the weight error bound):
    the caller's model, or with a ``QuantConfig`` the backend's copy
    whose serving linears hold codes (``serving.quant``)."""
    if quant is None:
        return model, 0.0
    from .quant import quantize_backend_model
    return quantize_backend_model(model, quant)


@dataclass
class _SlotRun:
    """Host bookkeeping for one in-flight request. ``t_admit`` is when
    the first token existed (prefill completion) — the TTFT timestamp.
    ``block_ids``: the arena blocks to release at retirement."""
    request: object
    tokens: List[int] = field(default_factory=list)
    t_admit: float = 0.0
    t_done: float = 0.0
    block_ids: Optional[List[int]] = None
    failure: Optional[str] = None


def _resolve_tp(tp, megakernel):
    """The engine's ``tp`` argument (``serving.tp.resolve_tp_config``);
    ``megakernel=True`` beside it is refused, as in JAX (the env knob is
    not read under ``tp=``: the sharded backends never fuse)."""
    from .tp import resolve_tp_config
    cfg = resolve_tp_config(tp)
    if cfg is not None and megakernel:
        raise NotImplementedError(
            "megakernel decode is not yet composed with tensor-parallel "
            "serving (the sharded programs run the unfused layers) — "
            "drop megakernel= or tp= (ROADMAP follow-up)")
    return cfg


def _refuse_spec_outside_factory(engine, spec):
    """Only the factory (``ContinuousBatchingEngine(...)``) routes
    ``spec=`` to the speculative engines: a direct constructor of a
    plain engine silently ignoring it would be a misconfiguration."""
    if spec and not hasattr(engine, "spec_k"):
        raise ValueError(
            "spec= is only honored through the ContinuousBatchingEngine "
            "factory (or construct serving.spec.SpecEngine/"
            "SpecPagedEngine directly)")


class ContinuousBatchingEngine:
    """Slot-pool decode engine over a step backend. The host syncs with
    the device once per ``decode_block`` tokens: it reads the (block, S)
    token matrix and the post-block ``remaining`` counters, harvests
    retired requests and hands freed slots to new ones.

    Built from a model, it is the dense engine: a ``ModelStepBackend``
    with an (S, max_len) KV cache per layer; :meth:`admit` prefills a
    prompt left-padded to its bucket (``prompt_buckets``, else its own
    length) at batch 1 and splices the row into a free slot, so a slot's
    greedy stream equals a batch-1 ``generate()`` of its prompt. On the
    card the decode block is one CUDA graph for the engine's life
    (:meth:`decode_compile_count` 1) and each bucket's prefill one graph
    (:meth:`prefill_compile_count`: the buckets admitted); on the CPU
    both run eagerly and count 0.

    ``paged=True`` (or ``PT_SERVING_PAGED=1`` when no backend is given)
    constructs the block-paged engine (``serving.paging.PagedEngine``)
    instead, and ``spec=`` (or ``PT_SERVING_SPEC=<k>``) the speculative
    one (``serving.spec.SpecEngine`` / ``SpecPagedEngine``); an explicit
    ``backend`` must be a ``ModelStepBackend`` (a speculative one routes
    to ``SpecEngine``). ``quant=`` (or ``PT_SERVING_QUANT_WEIGHTS``)
    serves int8/int4 weight-only quantized weights through the
    weight-only product kernel (``serving.quant``); it is refused beside
    an explicit backend, into which it is baked. ``megakernel=True`` (or
    ``PT_SERVING_MEGAKERNEL=1``) routes every decode layer through the
    fused decode-layer call, which the dense mode never launches:
    :meth:`megakernel_rewrites` is the layer count and
    :meth:`megakernel_kernel_calls` 0, as in JAX. ``tp=TPConfig(...)``
    (or ``PT_SERVING_TP=1`` without a backend) shards the programs over
    a mesh (``serving.tp.ShardedModelStepBackend``; refused beside
    ``megakernel=``, and with ``quant=`` in psum mode, as in JAX). A
    preempted request (``resume`` state, ``serving.server``) re-admits
    through :meth:`admit`, which re-prefills its prompt and history.
    ``device`` must match the model's (default the GPU)."""

    # whether the engine's backend builds a decode program (the fleet's
    # prefill-only engines build none)
    _decodes = True

    def __new__(cls, *args, **kw):
        if cls is ContinuousBatchingEngine:
            paged = kw.get("paged")
            backend = kw.get("backend") if len(args) < 6 else args[5]
            if paged is None and backend is None:
                paged = env_flag("PT_SERVING_PAGED")
            from .spec import spec_requested
            spec = spec_requested(kw.get("spec"), backend)
            if paged:
                from .paging import PagedEngine
                from .spec import SpecPagedEngine
                return object.__new__(SpecPagedEngine if spec
                                      else PagedEngine)
            if spec:
                from .spec import SpecEngine
                return object.__new__(SpecEngine)
        return object.__new__(cls)

    def __init__(self, model=None, num_slots: int = 4, max_len: int = 256,
                 decode_block: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 backend=None, *, paged: Optional[bool] = None, spec=None,
                 tp=None, quant=None, megakernel: Optional[bool] = None,
                 device=None):
        _refuse_spec_outside_factory(self, spec)
        if backend is None:
            if model is None:
                raise ValueError("pass a model or a step backend")
            from ..device import resolve_device
            from .quant import resolve_quant_config
            dev = resolve_device(device)
            if model.device != dev:
                raise ValueError(f"model is on {model.device}, engine "
                                 f"asked for {dev}")
            tp_cfg = _resolve_tp(tp, megakernel)
            if tp_cfg is not None:
                from .tp import ShardedModelStepBackend
                backend = ShardedModelStepBackend(
                    model, num_slots, max_len, decode_block, tp_cfg,
                    resolve_quant_config(quant), decode=self._decodes)
            else:
                if megakernel is None:
                    megakernel = env_bool("PT_SERVING_MEGAKERNEL")
                backend = self._build_backend(
                    model, num_slots, max_len, decode_block,
                    bool(megakernel), resolve_quant_config(quant))
        elif not isinstance(backend, ModelStepBackend):
            raise ValueError(
                f"the dense engine runs a ModelStepBackend, not "
                f"{type(backend).__name__}; build the paged engine from "
                f"the model with paged=True")
        elif megakernel is not None:
            raise ValueError(
                "megakernel= cannot be set alongside an explicit "
                "backend — the fused decode program is baked into the "
                "backend at construction")
        elif quant is not None:
            # baked into the backend at construction; the env knob never
            # reroutes an explicit backend either (it is read above only)
            raise ValueError(
                "quant= cannot be set alongside an explicit backend — "
                "weight-only quantization is baked into the backend at "
                "construction")
        self.prompt_buckets = tuple(sorted(prompt_buckets)) \
            if prompt_buckets else None
        self._init_engine(backend)

    def _build_backend(self, model, num_slots, max_len, decode_block,
                       megakernel, quant):
        return ModelStepBackend(model, num_slots, max_len, decode_block,
                                megakernel, quant)

    def _init_engine(self, backend):
        self.backend = backend
        self.num_slots = backend.num_slots
        self.max_len = backend.max_len
        self.decode_block = backend.block_size
        # the host gate on the block's NaN flags (the flags are always
        # computed: the same captured graph either way)
        self.nan_sentinel = True
        # set by the Server iff request tracing is armed (None keeps the
        # hot paths at one `is None` check)
        self.tracer = None
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Free every slot (the state tensors in place) and zero the
        counters."""
        self._state = self.backend.reset_state()
        self._slots: List[Optional[_SlotRun]] = [None] * self.num_slots
        self._prefill_slots: set = set()
        self._remaining_host = np.zeros((self.num_slots,), np.int64)
        self._finished: List[_SlotRun] = []
        self._pending_block = None    # dispatched, not yet harvested
        self._bytes_step = None       # decode_bytes_per_step memo
        self.steps = 0                # engine decode steps executed
        self.tokens_emitted = 0       # useful tokens (prefill's included)
        self.decode_tokens = 0        # live-slot decode tokens only
        self.slot_steps = 0           # S * steps (occupancy denominator)
        self.decode_s = 0.0           # host wall in step_block, sync incl.
        self.prefills = 0             # dense: batch-1 prefills dispatched
        self.prefill_s = 0.0          # host wall in prefills, sync incl.

    # -- introspection -----------------------------------------------------
    def free_slot_count(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def has_live(self) -> bool:
        return any(s is not None for s in self._slots)

    def has_decoding(self) -> bool:
        """Any slot past prefill (worth running a decode block for)."""
        return any(s is not None and i not in self._prefill_slots
                   for i, s in enumerate(self._slots))

    def occupancy(self) -> float:
        return self.decode_tokens / self.slot_steps if self.slot_steps \
            else 0.0

    def megakernel(self) -> bool:
        """Whether decode steps route their layers through the fused
        decode-layer call (``megakernel=`` / ``PT_SERVING_MEGAKERNEL``)."""
        return getattr(self.backend, "fused_decode", None) is not None

    def megakernel_rewrites(self) -> int:
        """Decode layers routed through the fused call in the last decode
        step the Python code ran (the layer count; 0 before the first
        step or with the megakernel off). On the card that step is the
        decode graph's capture, and every replay repeats its routing:
        the replays' own launches are in ``ops.launch_counts()``."""
        fused = getattr(self.backend, "fused_decode", None)
        return fused.rewrites if fused is not None else 0

    def megakernel_kernel_calls(self) -> int:
        """Of those, the layers that launched the megakernel: all of
        them on the card for a shape its kernel takes (the captured
        step's, as above), 0 on the CPU (as the JAX engine gives 0 off
        the TPU)."""
        fused = getattr(self.backend, "fused_decode", None)
        return fused.kernel_calls if fused is not None else 0

    def live_runs(self):
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    def tp_degree(self) -> int:
        """Devices the programs are sharded over (1 = TP off)."""
        return getattr(self.backend, "tp_degree", 1)

    def tp_int8_error_bound(self) -> float:
        """Runtime worst-case elementwise error of the tensor-parallel
        int8 hidden-state all-reduce, probed against the LIVE cache and
        slot state (0.0 unless a psum-mode TP backend with the int8 hop
        is armed — see ``serving.tp``)."""
        fn = getattr(self.backend, "tp_int8_error_bound", None)
        return 0.0 if fn is None else fn()

    def bucket_len(self, prompt_len: int) -> int:
        """The prompt bucket a prompt is left-padded to: the smallest of
        ``prompt_buckets`` that holds it, or its own length without
        buckets."""
        if self.prompt_buckets is None:
            return prompt_len
        for b in self.prompt_buckets:
            if b >= prompt_len:
                return b
        raise ValueError(
            f"prompt length {prompt_len} exceeds the largest bucket "
            f"{self.prompt_buckets[-1]}")

    def validate_request(self, prompt_len: int, max_new_tokens: int):
        """Raise ValueError if the request can never fit a slot — run at
        submit so a bad request is rejected at the door."""
        if prompt_len <= 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens}; must be >= 1")
        lb = self.bucket_len(prompt_len)
        if lb + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt bucket ({lb}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot capacity "
                f"({self.max_len}); raise max_len or shorten the request")

    def kv_error_bound(self) -> float:
        """Worst-case |dequant - fp32| over the KV cache: 0.0 on the dense
        engine (fp32 rows); the paged engine's int8 arena overrides it."""
        return 0.0

    def weight_error_bound(self) -> float:
        """Build-time worst-case elementwise |dequant - fp32| over the
        weight-only quantized serving weights (half the largest
        quantization step; 0.0 with quant off)."""
        return float(self.backend.weight_bound)

    def quant_error_bound(self) -> dict:
        """``{"kv": ..., "weights": ...}``, each 0.0 where that half is
        off; refreshes the ``pt_serving_{kv,weight}_error_bound``
        gauges."""
        kv, w = self.kv_error_bound(), self.weight_error_bound()
        if _om.enabled():
            from .quant import _M_KV_BOUND, _M_W_BOUND
            _M_KV_BOUND.set(kv)
            _M_W_BOUND.set(w)
        return {"kv": kv, "weights": w}

    def decode_compile_count(self) -> int:
        """Captures of the decode block program: 1 on the card over any
        stream (one CUDA graph per engine shape), 0 on the CPU, where the
        block runs eagerly (the JAX engine's trace count)."""
        return self.backend.decode_program.captures

    def prefill_compile_count(self) -> int:
        """Captures of prefill programs: on the card one per prompt
        bucket admitted so far (JAX's per-bucket prefill jits), 0 on the
        CPU."""
        return sum(p.captures
                   for p in self.backend.prefill_programs().values())

    def decode_bytes_per_step(self) -> dict:
        """Estimated device bytes ONE decode step reads:
        ``{"weights": ..., "kv": ..., "total": ...}`` — every weight and
        buffer byte of the model the backend runs (codes and scales
        under weight-only quant) plus the KV pool's resident bytes
        (codes and scales under the int8 arena). Capacity-based, as in
        JAX: the paged read touches only live blocks, so the kv term is
        an upper bound."""
        if self._bytes_step is None:
            m = self.backend.model
            w = sum(t.numel() * t.element_size()
                    for t in list(m.parameters()) + list(m.buffers()))
            kv = sum(t.numel() * t.element_size()
                     for t in self.backend.caches())
            self._bytes_step = {"weights": w, "kv": kv, "total": w + kv}
        return self._bytes_step

    def _note_decode_bytes(self, steps: int):
        """Metrics hook on the decode dispatch path (one enabled-check
        when metrics are off)."""
        if not _om.enabled():
            return
        b = self.decode_bytes_per_step()
        _M_BYTES.inc(b["total"] * steps)
        _M_W_BYTES.set(b["weights"])
        _M_KV_BYTES.set(b["kv"])

    # -- admission ---------------------------------------------------------
    def admit(self, request) -> bool:
        """Prefill the request's prompt (batch 1, left-padded to its
        bucket) and splice the row into a free slot. Returns True if the
        request already finished at admission (max_new_tokens == 1 or
        eos as its first token): it then never occupies a slot. A
        request carrying preemption ``resume`` state re-prefills its
        generated history instead (:meth:`_admit_resume`)."""
        resume = getattr(request, "resume", None)
        if resume is not None and resume.tokens:
            return self._admit_resume(request, resume)
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        self.validate_request(L, request.max_new_tokens)
        Lb = self.bucket_len(L)
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError("no free slot (scheduler bug)")
        tr = self.tracer
        if tr is not None:
            tr.span_end(request.request_id, "queue_wait")
            t_prefill = _trace_now()
        t0 = time.perf_counter()
        ids = np.zeros((1, Lb), np.int32)
        ids[0, Lb - L:] = prompt
        pad0 = Lb - L
        # generate()'s key schedule: PRNGKey(seed) split into the slot's
        # key and the first token's sub-key
        key, sub = prng.split(prng.prng_key(request.seed)) \
            .to(self.backend.device)
        with RecordEvent("serving.prefill"):
            tok0 = int(self.backend.prefill(ids, pad0, sub,
                                            request.temperature,
                                            request.top_k, request.top_p))
        if tr is not None:
            tr.span_at(request.request_id, "prefill", t_prefill, tokens=L,
                       bucket=Lb)
        _M_PREFILLS.inc()
        _M_TOKENS.inc()
        self.prefills += 1
        self.prefill_s += time.perf_counter() - t0
        run = _SlotRun(request, tokens=[tok0], t_admit=time.perf_counter())
        self.tokens_emitted += 1
        eos = request.eos_token_id
        rem0 = request.max_new_tokens - 1
        if eos is not None and tok0 == eos:
            rem0 = 0
        if rem0 <= 0:
            run.t_done = time.perf_counter()
            self._finished.append(run)
            return True
        with RecordEvent("serving.admit"):
            self.backend.splice(slot)
            _arm_fn(self._state, slot, tok=tok0, pos=Lb, pad=pad0,
                    live=True, eos=-1 if eos is None else eos,
                    remaining=rem0, temp=request.temperature,
                    topk=request.top_k, topp=request.top_p, key=key)
        if tr is not None:
            tr.span_begin(request.request_id, "decode", slot=slot)
        self._slots[slot] = run
        self._remaining_host[slot] = rem0
        return False

    def _admit_resume(self, request, resume) -> bool:
        """Re-admit a preempted request: re-prefill prompt + generated
        history (the K/V the eviction dropped) into the row, splice it,
        and arm the slot with the CARRIED stream state: ``tokens[-1]``
        as the next token, the saved key, the remaining budget. The
        prefill's own sample is discarded (the stream owns its next
        token and its key must not advance), so resumed greedy and
        seeded sampled streams equal an uninterrupted run: RoPE
        positions are pad-corrected and masked columns contribute exact
        zeros, as for any bucket-padded prompt."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        toks = list(resume.tokens)
        full = np.concatenate([prompt, np.asarray(toks[:-1], np.int32)])
        pl = int(full.shape[0])
        rem0 = request.max_new_tokens - len(toks)
        self.validate_request(pl, rem0 + 1)
        Lb = self.bucket_len(pl)
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError("no free slot (scheduler bug)")
        tr = self.tracer
        if tr is not None:
            tr.span_end(request.request_id, "queue_wait", resumed=True)
            t_prefill = _trace_now()
        t0 = time.perf_counter()
        ids = np.zeros((1, Lb), np.int32)
        ids[0, Lb - pl:] = full
        pad0 = Lb - pl
        with RecordEvent("serving.prefill"):
            self.backend.prefill(ids, pad0, prng.prng_key(0).to(
                self.backend.device), 0.0, 0, 1.0)
        if tr is not None:
            tr.span_at(request.request_id, "prefill", t_prefill,
                       tokens=pl, bucket=Lb, resumed=True)
        _M_PREFILLS.inc()
        self.prefills += 1
        self.prefill_s += time.perf_counter() - t0
        # t_admit carries over: TTFT keeps measuring the first admission
        run = _SlotRun(request, tokens=toks, t_admit=resume.t_admit)
        eos = request.eos_token_id
        with RecordEvent("serving.admit"):
            self.backend.splice(slot)
            _arm_fn(self._state, slot, tok=toks[-1], pos=Lb, pad=pad0,
                    live=True, eos=-1 if eos is None else eos,
                    remaining=rem0, temp=request.temperature,
                    topk=request.top_k, topp=request.top_p,
                    key=_key_tensor(resume.key, self.backend.device))
        if tr is not None:
            tr.instant(request.request_id, "resume", slot=slot,
                       reused_tokens=len(toks))
            tr.span_begin(request.request_id, "decode", slot=slot)
        self._slots[slot] = run
        self._remaining_host[slot] = rem0
        request.resume = None     # consumed; a later preemption rebuilds it
        return False

    def try_admit(self, request) -> bool:
        """Admit if resources allow; False means "retry later" (the
        paged engine's block pool can run out with a slot free — the
        dense engine always admits into a free slot)."""
        self.admit(request)
        return True

    # -- preemption --------------------------------------------------------
    def can_resume(self, run: _SlotRun) -> bool:
        """Whether a preempted ``run`` could be re-admitted: its prompt +
        generated history must still fit the engine (dense: a prompt
        bucket; paged: the block pool). The preemption policy asks
        before evicting: a victim that could never come back would be a
        silent kill, not a preemption."""
        if not run.tokens:
            return True          # mid-prefill: requeues as submitted
        req = run.request
        pl = int(np.asarray(req.prompt).reshape(-1).shape[0]) \
            + len(run.tokens) - 1
        try:
            self.validate_request(pl, req.max_new_tokens
                                  - len(run.tokens) + 1)
        except ValueError:
            return False
        return True

    def preempt_slot(self, slot: int):
        """Evict the request in ``slot`` mid-flight WITHOUT failing it:
        the slot is killed on the device as a deadline kills it, its
        resources release (paged blocks at exact refcounts, the prefix
        index kept, so the re-prefill is mostly cache hits), and the run
        comes back with the slot's key so that the request can requeue
        carrying ``ResumeState``. Returns ``(run, key)``: ``key`` (2,)
        uint32, or None for a mid-prefill victim (nothing armed: it
        requeues as submitted). Only at a tick boundary, like
        snapshots."""
        run = self._slots[slot]
        if run is None:
            raise RuntimeError(f"slot {slot} is empty")
        if self._pending_block is not None:
            raise RuntimeError(
                "preempt only at a tick boundary — a dispatched decode "
                "block is awaiting harvest (call step_block first)")
        key = None
        if slot in self._prefill_slots:
            self._prefill_slots.discard(slot)
            self._abort_prefill(slot)
        else:
            key = self._state["key"][slot].cpu().numpy().astype(np.uint32)
            _cancel_fn(self._state, slot)
        if self.tracer is not None:
            rid = run.request.request_id
            self.tracer.span_end(rid, "decode", preempted=True)
            self.tracer.instant(rid, "preempt", slot=slot,
                                tokens=len(run.tokens))
        self._slots[slot] = None
        self._remaining_host[slot] = 0
        self._release_slot_resources(run)
        return run, key

    def _release_slot_resources(self, run: _SlotRun):
        """Free what a preempted run held besides its slot: nothing on
        the dense engine (its row belongs to the pool; the paged engine
        releases the run's arena blocks)."""

    # -- decode ------------------------------------------------------------
    def has_pending_harvest(self) -> bool:
        """A decode block was dispatched but its host read failed: the
        next :meth:`step_block` retries just the harvest."""
        return self._pending_block is not None

    def step_block(self):
        """Run one decode block over the pool (one replay of its graph),
        then sync ONCE: pull the block's static output (tokens, live
        masks, NaN flags, remaining counters), credit each live slot its
        emitted tokens, retire finished slots.

        Failure semantics (JAX's): ``serving.poison`` and
        ``serving.step_block`` fire BEFORE the replay (state untouched —
        a retry replays the identical block), and ``serving.harvest``
        between the replay and the host read; the replayed block's
        output stays parked in its static tensor (``_pending_block``),
        so a retry reads it without replaying (no token is decoded twice
        or dropped). A slot whose log-probs went NaN is quarantined
        alone via :meth:`cancel_slot`."""
        B, S = self.decode_block, self.num_slots
        if self._pending_block is None:
            if not self.has_decoding():
                return
            if faults.should_fire("serving.poison"):
                self._poison_live_slot()
            faults.fault_point("serving.step_block")
            t0 = time.perf_counter()
            with RecordEvent("serving.decode_block"):
                self._pending_block = self.backend.decode_block()
            self.decode_s += time.perf_counter() - t0
            self.steps += B
            self.slot_steps += B * S
            _M_STEPS.inc(B)
            _M_COMPILES.set(self.decode_compile_count())
            self._note_decode_bytes(B)
        faults.fault_point("serving.harvest")
        t0 = time.perf_counter()
        packed = self._pending_block.cpu().numpy()   # ONE host sync/block
        self.decode_s += time.perf_counter() - t0
        self._pending_block = None
        toks_np = packed[:B]
        lives_np = packed[B:2 * B].astype(bool)
        oks_np = packed[2 * B:3 * B].astype(bool)
        rem_np = packed[3 * B]
        emitted = int(lives_np.sum())
        self.decode_tokens += emitted
        self.tokens_emitted += emitted
        _M_DECODE_TOKENS.inc(emitted)
        _M_TOKENS.inc(emitted)
        now = time.perf_counter()
        for slot, run in enumerate(self._slots):
            if run is None or slot in self._prefill_slots:
                continue     # mid-prefill slots are not decoding yet
            # live is monotone within a block (True rows are a prefix)
            n = int(lives_np[:, slot].sum())
            if n > 0:
                run.tokens.extend(int(t) for t in toks_np[:n, slot])
            if self.nan_sentinel and n > 0 \
                    and not bool(oks_np[:n, slot].all()):
                self.cancel_slot(slot, "poisoned")
                continue
            self._remaining_host[slot] = rem_np[slot]
            if rem_np[slot] == 0:
                self._retire(slot, run, now)

    # -- cancellation / quarantine -----------------------------------------
    def cancel_slot(self, slot: int, reason: str) -> bool:
        """Cancel the request in ``slot`` mid-flight: kill the slot on
        the device, release its resources (paged: arena blocks at
        correct refcounts, pending prefill job dropped), and surface the
        run through ``drain_finished`` with ``failure=reason``."""
        run = self._slots[slot]
        if run is None:
            return False
        run.failure = reason
        if slot in self._prefill_slots:
            self._prefill_slots.discard(slot)
            self._abort_prefill(slot)
        else:
            _cancel_fn(self._state, slot)
        self._retire(slot, run, time.perf_counter())
        self._remaining_host[slot] = 0
        return True

    def _abort_prefill(self, slot):
        """Dense admission is synchronous — nothing to abort."""

    def _poison_live_slot(self):
        """Fault action of the ``serving.poison`` site: write NaN into
        the FIRST decoding slot's row of every floating pool tensor, in
        place (the decode graph reads these tensors), so its next
        log-probs trip the sentinel. Only that slot's row is touched."""
        for slot, run in enumerate(self._slots):
            if run is not None and slot not in self._prefill_slots:
                for t in self.backend.caches():
                    if t.is_floating_point():
                        t[slot].fill_(float("nan"))
                return slot
        return None

    def _retire(self, slot, run, now):
        """Move a finished slot to the harvest list (the paged engine
        also releases the slot's arena blocks here)."""
        run.t_done = now
        if self.tracer is not None:
            self.tracer.span_end(run.request.request_id, "decode",
                                 tokens=len(run.tokens))
        self._finished.append(run)
        self._slots[slot] = None

    def drain_finished(self) -> List[_SlotRun]:
        done, self._finished = self._finished, []
        return done

    # -- crash-safe snapshot / restore -------------------------------------
    def _run_meta(self, run: _SlotRun) -> dict:
        from .resilience import request_to_meta
        return {"request": request_to_meta(run.request),
                "tokens": [int(t) for t in run.tokens],
                "t_admit": run.t_admit, "t_done": run.t_done,
                "failure": run.failure,
                "block_ids": None if run.block_ids is None
                else [int(b) for b in run.block_ids]}

    def _run_from_meta(self, meta: dict, prompt) -> _SlotRun:
        from .resilience import request_from_meta
        return _SlotRun(request=request_from_meta(meta["request"], prompt),
                        tokens=list(meta["tokens"]),
                        t_admit=meta["t_admit"], t_done=meta["t_done"],
                        failure=meta["failure"],
                        block_ids=None if meta["block_ids"] is None
                        else list(meta["block_ids"]))

    def _pool_specs(self):
        return [[list(s), d] for s, d in self.backend.pool_specs]

    def snapshot_state(self):
        """(meta dict, host-array dict) capturing everything needed to
        resume every in-flight stream: the KV pool, the slot state
        (positions, rng keys, sampling parameters — and the paged block
        tables riding it), copied to the host, and the host
        bookkeeping. Taken at a tick boundary. The meta schema, the array
        names and the dtypes are JAX's (slot keys as uint32 words, a bf16
        pool as npz ``|V2`` words), so either package restores the file;
        the port's own counters ride along as extra keys."""
        if self._pending_block is not None:
            raise RuntimeError(
                "snapshot only at a tick boundary — a dispatched decode "
                "block is awaiting harvest (call step_block first)")
        arrays = {}
        for i, t in enumerate(self.backend.caches()):
            arrays[f"cache_{i}"] = _to_host(t)
        for k, v in self._state.items():
            arrays[f"state_{k}"] = _to_host(v, words=k == "key")
        slots_meta = []
        for i, run in enumerate(self._slots):
            if run is None:
                slots_meta.append(None)
                continue
            arrays[f"slot{i}_prompt"] = np.asarray(
                run.request.prompt, np.int32).reshape(-1)
            slots_meta.append(self._run_meta(run))
        fin_meta = []
        for j, run in enumerate(self._finished):
            arrays[f"fin{j}_prompt"] = np.asarray(
                run.request.prompt, np.int32).reshape(-1)
            fin_meta.append(self._run_meta(run))
        meta = {
            "engine_class": type(self).__name__,
            # JAX's AOT-artifact fingerprint; a model-backed engine has none
            "backend_artifact": None,
            "num_slots": self.num_slots, "max_len": self.max_len,
            "decode_block": self.decode_block,
            "pool_specs": self._pool_specs(),
            "remaining": [int(r) for r in self._remaining_host],
            "prefill_slots": sorted(self._prefill_slots),
            "slots": slots_meta, "finished": fin_meta,
            "counters": {"steps": self.steps,
                         "tokens_emitted": self.tokens_emitted,
                         "decode_tokens": self.decode_tokens,
                         "slot_steps": self.slot_steps,
                         "decode_s": self.decode_s,
                         "prefills": self.prefills,
                         "prefill_s": self.prefill_s},
        }
        return meta, arrays

    def restore_state(self, meta: dict, arrays: dict):
        """Inverse of :meth:`snapshot_state`, into a freshly constructed
        engine of the SAME configuration, from a file of either package.
        Every array is validated (shape, and a dtype that holds the
        tensor's values exactly: :func:`_host_array`) before any state is
        touched, and then copied INTO the tensor it came from — the pool,
        the slot state, the block tables — never rebound: the captured
        graphs read those tensors, and a replay would never see a
        rebound one."""
        want = self._pool_specs()
        if meta["pool_specs"] != want:
            raise ValueError(
                "snapshot pool_specs do not match this engine — restore "
                "needs the same model config / slots / max_len / paging "
                f"layout (saved {meta['pool_specs'][:2]}..., engine "
                f"{want[:2]}...)")
        if meta["engine_class"] != type(self).__name__:
            raise ValueError(
                f"snapshot was taken by {meta['engine_class']}, this "
                f"engine is {type(self).__name__} (dense/paged mismatch)")
        pairs = [(f"cache_{i}", t)
                 for i, t in enumerate(self.backend.caches())]
        pairs += [(f"state_{k}", v) for k, v in self._state.items()]
        host = []
        for name, t in pairs:
            a = arrays[name]
            h = _host_array(t, a)
            if tuple(a.shape) != tuple(t.shape) or h is None:
                raise ValueError(
                    f"snapshot array {name} is {a.dtype}{list(a.shape)}, "
                    f"this engine holds {t.dtype}{list(t.shape)} (a "
                    "snapshot restores into the engine configuration that "
                    "wrote it)")
            host.append(h)
        self.reset()
        for (_, t), h in zip(pairs, host):
            _from_host(t, h)
        self._slots = [
            None if m is None
            else self._run_from_meta(m, arrays[f"slot{i}_prompt"])
            for i, m in enumerate(meta["slots"])]
        self._finished = [
            self._run_from_meta(m, arrays[f"fin{j}_prompt"])
            for j, m in enumerate(meta["finished"])]
        self._prefill_slots = set(meta["prefill_slots"])
        self._remaining_host = np.asarray(meta["remaining"], np.int64)
        c = meta["counters"]
        self.steps = c["steps"]
        self.tokens_emitted = c["tokens_emitted"]
        self.decode_tokens = c["decode_tokens"]
        self.slot_steps = c["slot_steps"]
        # the port's own counters: a JAX file has none of them
        self.decode_s = c.get("decode_s", 0.0)
        self.prefills = c.get("prefills", 0)
        self.prefill_s = c.get("prefill_s", 0.0)

    def snapshot(self, path: str):
        """Write a crash-safe engine snapshot (one npz file, atomic
        tmp+rename)."""
        from .resilience import save_snapshot
        meta, arrays = self.snapshot_state()
        save_snapshot(path, {"engine": meta}, arrays)

    def restore(self, path: str):
        from .resilience import load_snapshot
        meta, arrays = load_snapshot(path)
        self.restore_state(meta["engine"], arrays)


def _key_tensor(key, device) -> torch.Tensor:
    """A (2,) uint32 key (numpy, as ``ResumeState`` carries it) as the
    slot state's (2,) int64 words on ``device``."""
    return torch.from_numpy(np.asarray(key, np.uint32).astype(np.int64)) \
        .to(device)


def _to_host(t: torch.Tensor, words: bool = False) -> np.ndarray:
    """A tensor as its snapshot array in the JAX package's dtypes: bf16
    as npz ``|V2`` words (:func:`handoff.leaf_to_wire`) and, with
    ``words``, int64 key words as the uint32 words a JAX key holds."""
    if words:
        return t.detach().cpu().numpy().astype(np.uint32)
    return leaf_to_wire(t.detach())


def _host_array(t: torch.Tensor, a: np.ndarray) -> Optional[np.ndarray]:
    """Snapshot array ``a`` in ``t``'s host dtype (bf16 as its int16
    bits), converted exactly, or None when ``a``'s dtype does not hold
    ``t``'s values. Taken: the JAX package's dtypes (uint32 words for the
    int64 key words, npz ``|V2`` words for bf16) and the port's older
    files' (int64 keys, int16 bf16 words); nothing else."""
    if t.dtype == torch.bfloat16:
        return a.view(np.int16) if a.dtype in (_BF16_WIRE, np.int16) \
            else None
    if a.dtype == torch.empty(0, dtype=t.dtype).numpy().dtype:
        return a
    if t.dtype == torch.int64 and a.dtype == np.uint32:
        return a.astype(np.int64)
    return None


def _from_host(t: torch.Tensor, a: np.ndarray):
    """Copy a host array of ``t``'s host dtype (:func:`_host_array`) into
    ``t`` in place."""
    dst = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))
