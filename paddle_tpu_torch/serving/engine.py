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
streams match the JAX package token for token."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as prng
from ..models.generation import decode_step_logprobs
from ..ops.decode_layer import FusedDecode
from ..utils.flags import env_bool, env_flag
from ..graphs import CapturedProgram

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
    (2 * block + 1, S) int32 output: rows [0, block) the tokens, rows
    [block, 2 * block) the start-of-step live masks (the host counts
    emissions from ``live``: an eos retirement zeroes ``remaining``),
    the last row the remaining counters after the block."""
    block = (out.shape[0] - 1) // 2
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
        st = dict(st, tok=torch.where(live, nxt, st["tok"]),
                  pos=st["pos"] + live.to(torch.int32),
                  remaining=rem, key=sp[:, 0], live=live & (rem > 0))
    for name in ("tok", "pos", "remaining", "key", "live"):
        state[name].copy_(st[name])
    out[2 * block].copy_(state["remaining"])


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
    eagerly."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, megakernel: bool = False):
        self.model = model
        self.device = dev = model.device
        self.num_slots, self.max_len = num_slots, max_len
        self.block_size = decode_block
        self.cache = model.init_kv_cache(num_slots, max_len)
        self.row = model.init_kv_cache(1, max_len)
        self.fused_decode = FusedDecode() if megakernel else None
        self.state = init_slot_state(num_slots, dev)
        self._block_out = torch.zeros((2 * decode_block + 1, num_slots),
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
        self.decode_program = CapturedProgram(self._run_block, dev)
        self.decode_program.capture()
        self.reset_state()

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
        static (2 * block + 1, S) int32 output of
        :func:`run_decode_block`, valid until the next block."""
        self.decode_program()
        return self._block_out

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


def _refuse_unported(spec=None, tp=None, quant=None):
    """The engine arguments of the JAX API whose modules are not ported
    yet raise, naming their ROADMAP queue item."""
    for name, value, item in (("spec", spec, "A.4"), ("quant", quant, "A.4"),
                              ("tp", tp, "A.6")):
        if value not in (None, False):
            raise NotImplementedError(
                f"{name}= is not ported yet (ROADMAP {item})")


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
    instead; an explicit ``backend`` must be a ``ModelStepBackend``.
    ``megakernel=True`` (or ``PT_SERVING_MEGAKERNEL=1``) routes every
    decode layer through the fused decode-layer call, which the
    dense mode never launches: :meth:`megakernel_rewrites` is the layer
    count and :meth:`megakernel_kernel_calls` 0, as in JAX. ``spec``,
    ``tp`` and ``quant`` are not ported yet and raise. ``device`` must
    match the model's (default the GPU)."""

    def __new__(cls, *args, **kw):
        if cls is ContinuousBatchingEngine:
            paged = kw.get("paged")
            backend = kw.get("backend") if len(args) < 6 else args[5]
            if paged is None and backend is None:
                paged = env_flag("PT_SERVING_PAGED")
            if paged:
                from .paging import PagedEngine
                return object.__new__(PagedEngine)
        return object.__new__(cls)

    def __init__(self, model=None, num_slots: int = 4, max_len: int = 256,
                 decode_block: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 backend=None, *, paged: Optional[bool] = None, spec=None,
                 tp=None, quant=None, megakernel: Optional[bool] = None,
                 device=None):
        _refuse_unported(spec, tp, quant)
        if backend is None:
            if model is None:
                raise ValueError("pass a model or a step backend")
            from ..device import resolve_device
            dev = resolve_device(device)
            if model.device != dev:
                raise ValueError(f"model is on {model.device}, engine "
                                 f"asked for {dev}")
            if megakernel is None:
                megakernel = env_bool("PT_SERVING_MEGAKERNEL")
            backend = ModelStepBackend(model, num_slots, max_len,
                                       decode_block, bool(megakernel))
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
        self.prompt_buckets = tuple(sorted(prompt_buckets)) \
            if prompt_buckets else None
        self._init_engine(backend)

    def _init_engine(self, backend):
        self.backend = backend
        self.num_slots = backend.num_slots
        self.max_len = backend.max_len
        self.decode_block = backend.block_size
        self.reset()

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Free every slot (the state tensors in place) and zero the
        counters."""
        self._state = self.backend.reset_state()
        self._slots: List[Optional[_SlotRun]] = [None] * self.num_slots
        self._prefill_slots: set = set()
        self._finished: List[_SlotRun] = []
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

    # -- admission ---------------------------------------------------------
    def admit(self, request) -> bool:
        """Prefill the request's prompt (batch 1, left-padded to its
        bucket) and splice the row into a free slot. Returns True if the
        request already finished at admission (max_new_tokens == 1 or
        eos as its first token): it then never occupies a slot."""
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        self.validate_request(L, request.max_new_tokens)
        Lb = self.bucket_len(L)
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError("no free slot (scheduler bug)")
        t0 = time.perf_counter()
        ids = np.zeros((1, Lb), np.int32)
        ids[0, Lb - L:] = prompt
        pad0 = Lb - L
        # generate()'s key schedule: PRNGKey(seed) split into the slot's
        # key and the first token's sub-key
        key, sub = prng.split(prng.prng_key(request.seed)) \
            .to(self.backend.device)
        tok0 = int(self.backend.prefill(ids, pad0, sub, request.temperature,
                                        request.top_k, request.top_p))
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
        self.backend.splice(slot)
        _arm_fn(self._state, slot, tok=tok0, pos=Lb, pad=pad0, live=True,
                eos=-1 if eos is None else eos, remaining=rem0,
                temp=request.temperature, topk=request.top_k,
                topp=request.top_p, key=key)
        self._slots[slot] = run
        return False

    def try_admit(self, request) -> bool:
        """Admit if resources allow; False means "retry later" (the
        paged engine's block pool can run out with a slot free — the
        dense engine always admits into a free slot)."""
        self.admit(request)
        return True

    # -- decode ------------------------------------------------------------
    def step_block(self):
        """Run one decode block over the pool, then sync ONCE: pull the
        block's static output (token matrix, live masks, remaining
        counters), credit each live slot its emitted tokens, retire
        finished slots."""
        if not self.has_decoding():
            return
        t0 = time.perf_counter()
        packed = self.backend.decode_block().cpu().numpy()
        B, S = self.decode_block, self.num_slots
        toks_np = packed[:B]
        lives_np = packed[B:2 * B].astype(bool)
        rem_np = packed[2 * B]
        self.decode_s += time.perf_counter() - t0
        self.steps += B
        self.slot_steps += B * S
        emitted = int(lives_np.sum())
        self.decode_tokens += emitted
        self.tokens_emitted += emitted
        now = time.perf_counter()
        for slot, run in enumerate(self._slots):
            if run is None or slot in self._prefill_slots:
                continue
            # live is monotone within a block (True rows are a prefix)
            n = int(lives_np[:, slot].sum())
            run.tokens.extend(int(t) for t in toks_np[:n, slot])
            if rem_np[slot] == 0:
                self._retire(slot, run, now)

    # -- cancellation ------------------------------------------------------
    def cancel_slot(self, slot: int, reason: str) -> bool:
        """Cancel the request in ``slot`` mid-flight: kill the slot on
        the device, release its resources, and surface the run through
        ``drain_finished`` with ``failure=reason``."""
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
        return True

    def _abort_prefill(self, slot):
        """Drop a pending prefill (the paged engine's chunk jobs)."""

    def _retire(self, slot, run, now):
        run.t_done = now
        self._finished.append(run)
        self._slots[slot] = None

    def drain_finished(self) -> List[_SlotRun]:
        done, self._finished = self._finished, []
        return done
