"""Continuous-batching decode engine: a fixed pool of S sequence slots
whose per-slot state lives on the device.

Counterpart of ``paddle_tpu/serving/engine.py``: per-slot sampling, the
slot state, the decode block and the host logic of
``ContinuousBatchingEngine`` that the paged engine uses. The JAX engine
compiles the block as one ``lax.scan`` program; here the block is a
Python loop of ``decode_block`` steps over device tensors, which the
paged backend captures as one CUDA graph on the card and replays
(``serving.graphs``), and runs eagerly on the CPU. The host syncs ONCE
per block, as there. The JAX slot state is a pytree replaced by each
program; here it is one dict of tensors that every block and every
arm, cancel and reset updates in place, so the graph reads and writes
the same memory on every replay. Sampling draws from threefry keys
(``paddle_tpu_torch.random``) on the JAX key schedule, so seeded sampled
streams match the JAX package token for token."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from .. import random as prng

__all__ = ["slot_sample_logits", "init_slot_state", "free_slot_state",
           "run_decode_block", "ContinuousBatchingEngine"]


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
    eos/budget retirement, all on the device. ``step(tok, pos, table)``
    returns (S, V) log-probs. Dead slots' tables are redirected to the
    trash block 0, so a retired slot whose blocks the host has handed to
    another request never writes into them.

    As in JAX, every step splits every slot's key and samples every row:
    the work depends on the engine's shapes alone (one captured graph
    serves any traffic), and the keys follow the JAX schedule. ``state``
    is updated in place at the block's end. ``out`` is the static
    (2 * block + 1, S) int32 output: rows [0, block) the tokens, rows
    [block, 2 * block) the start-of-step live masks (the host counts
    emissions from ``live``: an eos retirement zeroes ``remaining``),
    the last row the remaining counters after the block."""
    block = (out.shape[0] - 1) // 2
    st = dict(state)
    for i in range(block):
        live = st["live"]
        tbl = torch.where(live[:, None], st["table"], 0)
        logp = step(st["tok"][:, None], st["pos"], tbl)
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


class ContinuousBatchingEngine:
    """Slot-pool host logic over a step backend: the host reads the
    (block, S) token matrix once per ``decode_block`` tokens, harvests
    retired requests and hands freed slots to new ones. Subclasses
    (``serving.paging.PagedEngine``) supply admission."""

    def __init__(self, backend):
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

    def validate_request(self, prompt_len: int, max_new_tokens: int):
        """Raise ValueError if the request can never fit a slot — run at
        submit so a bad request is rejected at the door."""
        if prompt_len <= 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens}; must be >= 1")
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot capacity "
                f"({self.max_len}); raise max_len or shorten the request")

    def decode_compile_count(self) -> int:
        """Captures of the decode block program: 1 on the card over any
        stream (one CUDA graph per engine shape), 0 on the CPU, where the
        block runs eagerly (the JAX engine's trace count)."""
        return self.backend.decode_program.captures

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
