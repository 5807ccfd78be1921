"""Speculative multi-token decoding on the slot pool: a host n-gram
drafter and one verify step over (S, k + 1) positions.

Counterpart of ``paddle_tpu/serving/spec.py``. A decode step reads every
weight and KV byte to emit one token a slot; the verify step scores the
slot's token and up to ``k`` drafted tokens in one forward, at the same
weight read. The drafter (:func:`ngram_propose`, prompt lookup over the
slot's own history, no second model) runs on the host; the verify step
runs on the device:

- the window ``[tok, d_1 .. d_k]`` is written at per-row positions
  ``pos .. pos + k`` (dense: the masked per-row write of
  ``models.generation``, columns past the cache dropped; paged: through
  the slot's block table, positions past it to the trash block) and
  read causally, so row i attends its prefix plus the drafts before it;
- greedy acceptance keeps the longest draft prefix equal to the model's
  own argmax (a ``cumprod``) plus one bonus token, so greedy streams
  equal plain decoding token for token; a sampled slot never accepts a
  draft: its position 0 goes through the same key split and
  ``slot_sample_logits`` as the plain block, keeping ``generate(seed)``'s
  key schedule;
- each slot advances by its own count (an eos inside the span cuts it),
  and the NaN sentinel's ``ok`` flag covers the slot's whole window.

Junk K/V left at rejected positions is never read: the next window
starts at the new ``pos`` and rewrites them before attention reaches
them.

On the card the verify step is ONE CUDA graph for the engine's life
(``graphs.CapturedProgram``, in place of the plain decode block): the
(S, k) draft and the (S,) draft counts are static inputs filled by one
copy a step, and the step's one static output — target tokens, counts,
``ok`` flags and remaining budgets — is read by one host sync. The
paged variant points dead rows' tables at the trash block, as the plain
block does. ``spec=`` composes with ``paged=`` and ``quant=``; beside
``tp=`` it is refused, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as prng
from ..models.generation import decode_step_logprobs
from ..observability import metrics as _om
from ..profiler import RecordEvent
from ..utils import faults
from ..utils.flags import env_int
from .engine import (_M_COMPILES, _M_DECODE_TOKENS, _M_STEPS, _M_TOKENS,
                     ContinuousBatchingEngine, ModelStepBackend,
                     slot_sample_logits)
from .paging import PagedEngine, PagedModelStepBackend

__all__ = ["SpecConfig", "resolve_spec_config", "spec_requested",
           "ngram_propose", "run_spec_verify", "SpecModelStepBackend",
           "SpecPagedStepBackend", "SpecEngine", "SpecPagedEngine"]

# speculative-decode metric families (JAX's names; registered at
# import, no-ops until metrics.enable() / PT_METRICS)
_M_SPEC_STEPS = _om.counter("pt_serving_spec_verify_steps_total",
                            "speculative verify steps dispatched")
_M_SPEC_DRAFTED = _om.counter("pt_serving_spec_draft_tokens_total",
                              "draft tokens proposed to the verify block")
_M_SPEC_ACCEPTED = _om.counter(
    "pt_serving_spec_accepted_tokens_total",
    "draft tokens the target model's argmax confirmed")
_M_SPEC_EMITTED = _om.counter(
    "pt_serving_spec_emitted_tokens_total",
    "tokens emitted by verify steps (accepted drafts + bonus tokens)")
_M_SPEC_RATE = _om.gauge(
    "pt_serving_spec_acceptance_rate",
    "lifetime accepted/proposed draft-token ratio of the engine")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """How to speculate. ``k``: the most draft tokens a slot a verify
    step (the window is ``k + 1`` wide; ``k = 0`` is plain one-token
    decoding through the same program). ``ngram_max`` / ``ngram_min``:
    the drafter matches the longest trailing n-gram in this range
    against the slot's own history."""
    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 1

    def __post_init__(self):
        if self.k < 0:
            raise ValueError(f"SpecConfig.k={self.k}; must be >= 0")
        if self.ngram_min < 1:
            raise ValueError(
                f"SpecConfig.ngram_min={self.ngram_min}; must be >= 1")
        if self.ngram_max < self.ngram_min:
            raise ValueError(
                f"SpecConfig.ngram_max={self.ngram_max} < ngram_min="
                f"{self.ngram_min}")


def resolve_spec_config(spec) -> Optional[SpecConfig]:
    """The engine's ``spec`` argument: a SpecConfig passes through,
    ``True`` is the defaults, ``False`` off, ``None`` reads
    ``PT_SERVING_SPEC`` (an integer k; 0 or unset: off) and
    ``PT_SERVING_SPEC_NGRAM``."""
    if isinstance(spec, SpecConfig):
        return spec
    if spec is True:
        return SpecConfig()
    if spec is False:
        return None
    if spec is not None:
        raise ValueError(f"spec={spec!r}: pass a SpecConfig, "
                         "True/False, or None (env-controlled)")
    k = env_int("PT_SERVING_SPEC", 0)
    if k <= 0:
        return None
    return SpecConfig(k=k, ngram_max=env_int("PT_SERVING_SPEC_NGRAM", 3))


def spec_requested(spec, backend) -> bool:
    """The factory's routing decision: an explicit spec backend IS the
    decision; otherwise the argument or the env knob (an explicit
    non-spec backend is never rerouted by the env knob)."""
    if backend is not None:
        return getattr(backend, "spec_k", None) is not None
    return resolve_spec_config(spec) is not None


# ---------------------------------------------------------------------------
# host-side drafter: n-gram / prompt lookup
# ---------------------------------------------------------------------------

def _lookup_once(h: np.ndarray, k: int, ngram_max: int,
                 ngram_min: int) -> np.ndarray:
    """One prompt-lookup round: the continuation after the most recent
    earlier occurrence of the longest trailing n-gram of ``h``."""
    L = int(h.size)
    empty = np.zeros((0,), np.int32)
    if L < 2:
        return empty
    for n in range(min(ngram_max, L - 1), ngram_min - 1, -1):
        pat = h[L - n:]
        # windows over h[:-1]: every match has at least one continuation
        # token (which may overlap the pattern itself: cycles)
        win = np.lib.stride_tricks.sliding_window_view(h[:L - 1], n)
        hits = np.flatnonzero((win == pat[None, :]).all(axis=1))
        if hits.size:
            s = int(hits[-1])
            out = h[s + n:s + n + k]
            if out.size:
                return out.astype(np.int32)
    return empty


def ngram_propose(history, k: int, ngram_max: int = 3,
                  ngram_min: int = 1) -> np.ndarray:
    """Prompt-lookup drafting: the tokens that followed the most recent
    earlier occurrence of the LONGEST trailing n-gram (``ngram_max``
    down to ``ngram_min``) of ``history``. Self-extending: while fewer
    than ``k`` are drafted, the draft so far joins the history and the
    lookup repeats, so a period-2 cycle fills a k = 8 window. Returns
    (<= k,) int32 (empty: no draft)."""
    h = np.asarray(history, np.int32).reshape(-1)
    empty = np.zeros((0,), np.int32)
    if k <= 0 or h.size < 2:
        return empty
    out = empty
    while out.size < k:
        prop = _lookup_once(np.concatenate([h, out]) if out.size else h,
                            k - int(out.size), ngram_max, ngram_min)
        if prop.size == 0:
            break
        out = np.concatenate([out, prop])
    return out


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------

def run_spec_verify(step, state, spec_in: torch.Tensor,
                    out: torch.Tensor):
    """One draft-verify step over the slot pool (``build_spec_block_fn``),
    in place on the device. ``step(tokens (S, W), pos, aux)`` returns the
    (S, W, V) log-probs of every column (``aux``: the trash-redirected
    block table, paged, or the pad counts, dense); ``spec_in`` is the
    static (S, k + 1) int32 input, the drafts then their count;
    ``out`` the static (S, k + 4) int32 output: the W = k + 1 target
    tokens, the count each slot emits, its ``ok`` flag (no NaN in its
    window) and its remaining budget after the step. ``state`` advances
    in place by each slot's own count."""
    k = spec_in.shape[1] - 1
    W = k + 1
    draft, n_draft = spec_in[:, :k], spec_in[:, k]
    st = state
    live = st["live"]
    aux = torch.where(live[:, None], st["table"], 0) if "table" in st \
        else st["pad"]
    sp = prng.split(st["key"])                               # (S, 2, 2)
    logp = step(torch.cat([st["tok"][:, None], draft], dim=1), st["pos"],
                aux)                                         # (S, W, V)
    ok = ~torch.isnan(logp).flatten(1).any(dim=1)
    t = torch.argmax(logp, dim=-1).to(torch.int32)           # (S, W)
    # position 0 through the sampling path: greedy rows get the same
    # argmax, sampled rows the plain block's key schedule
    first = slot_sample_logits(logp[:, 0], st["temp"], st["topk"],
                               st["topp"], sp[:, 1])
    t = torch.cat([first[:, None], t[:, 1:]], dim=1)
    # sampled rows never accept drafts, whatever the host proposed
    n_eff = torch.where(st["temp"] <= 0.0, n_draft, 0)
    if k > 0:
        idx = torch.arange(k, device=t.device)
        acc = (idx[None, :] < n_eff[:, None]) & (draft == t[:, :k])
        a = acc.to(torch.int32).cumprod(dim=1).sum(dim=1).to(torch.int32)
    else:
        a = torch.zeros_like(st["pos"])
    n_emit = torch.where(live, torch.minimum(a + 1, st["remaining"]), 0)
    cols = torch.arange(W, device=t.device, dtype=torch.int32)[None, :]
    eos = st["eos"][:, None]
    is_eos = (eos >= 0) & (t == eos) & (cols < n_emit[:, None])
    eos_pos = torch.where(is_eos, cols, W).amin(dim=1)
    hit = eos_pos < W                    # an eos inside the emitted span
    n_emit = torch.where(hit, eos_pos + 1, n_emit)
    rem = torch.where(live, st["remaining"] - n_emit, st["remaining"])
    rem = torch.where(hit, 0, rem)
    last = torch.gather(t, 1, (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
    st["tok"].copy_(torch.where(n_emit > 0, last, st["tok"]))
    st["pos"].copy_(st["pos"] + n_emit)
    st["remaining"].copy_(rem)
    st["key"].copy_(sp[:, 0])
    st["live"].copy_(live & (rem > 0))
    out[:, :W].copy_(t)
    out[:, W].copy_(n_emit)
    out[:, W + 1].copy_(ok)
    out[:, W + 2].copy_(rem)


class _SpecBackendMixin:
    """Adds the verify step to a model step backend: it is the program
    the backend captures as its decode program (``_decode_fn``), so
    ``decode_compile_count`` counts it; the plain decode block is never
    captured. The decode block size is 1 (drafts are host inputs, one
    verify step a host round trip)."""

    def _setup_spec(self, spec: SpecConfig, num_slots: int, device):
        self.spec = spec
        self.spec_k = spec.k
        self._spec_in = torch.zeros((num_slots, spec.k + 1),
                                    dtype=torch.int32, device=device)
        self._spec_out = torch.zeros((num_slots, spec.k + 4),
                                     dtype=torch.int32, device=device)

    def _decode_fn(self):
        return self._run_verify

    def _run_verify(self):
        run_spec_verify(self._verify_step, self.state, self._spec_in,
                        self._spec_out)

    def spec_verify(self, draft: np.ndarray, n_draft: np.ndarray
                    ) -> torch.Tensor:
        """Copy the (S, k) drafts and (S,) counts in (one copy), run the
        verify step (one replay on the card); returns the static output
        of :func:`run_spec_verify`, valid until the next step."""
        host = np.concatenate([draft, n_draft[:, None]], axis=1)
        self._spec_in.copy_(torch.from_numpy(
            np.ascontiguousarray(host, np.int32)))
        self.decode_program()
        return self._spec_out


class SpecModelStepBackend(_SpecBackendMixin, ModelStepBackend):
    """The dense backend with the (S, k + 1) verify step."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, spec: SpecConfig,
                 megakernel: bool = False, quant=None):
        self._setup_spec(spec, num_slots, model.device)
        super().__init__(model, num_slots, max_len, decode_block,
                         megakernel, quant)
        self.block_size = 1

    def _verify_step(self, toks, pos, pad):
        return decode_step_logprobs(self.model, toks, self.cache, pos,
                                    pad=pad, all_positions=True)


class SpecPagedStepBackend(_SpecBackendMixin, PagedModelStepBackend):
    """The paged backend with the (S, k + 1) verify step (the prefill
    chunk is the plain backend's)."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, block_size: int, num_blocks: int,
                 prefill_chunk: int, kv_int8: bool, megakernel: bool,
                 quant, spec: SpecConfig):
        self._setup_spec(spec, num_slots, model.device)
        super().__init__(model, num_slots, max_len, decode_block,
                         block_size, num_blocks, prefill_chunk, kv_int8,
                         megakernel, quant)
        self.block_size = 1

    def _verify_step(self, toks, pos, table):
        return decode_step_logprobs(self.model, toks, self.cache, pos,
                                    block_table=table, all_positions=True)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

class _SpecEngineMixin:
    """The draft-verify step loop and the acceptance accounting of both
    speculative engines: :meth:`step_block` is the verify dispatch;
    admission, cancellation, deadlines, the NaN quarantine, preemption
    and snapshots are the base engine's."""

    def _init_spec(self, spec, tp=None):
        from .tp import resolve_tp_config
        if resolve_tp_config(tp) is not None:
            raise NotImplementedError(
                "speculative decoding is not yet composed with "
                "tensor-parallel serving — drop spec= or tp= (ROADMAP "
                "follow-up)")
        self.spec = resolve_spec_config(spec) or SpecConfig()
        self.spec_k = self.spec.k

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        super().reset()
        self.verify_steps = 0
        self.draft_proposed = 0        # draft tokens handed to verify
        self.draft_accepted = 0        # drafts the target confirmed

    # -- introspection -----------------------------------------------------
    def acceptance_rate(self) -> float:
        """Lifetime accepted / proposed draft tokens."""
        return self.draft_accepted / self.draft_proposed \
            if self.draft_proposed else 0.0

    def mean_accepted_per_step(self) -> float:
        """Mean accepted draft tokens a verify step (tokens emitted a
        step are this plus the bonus token)."""
        return self.draft_accepted / self.verify_steps \
            if self.verify_steps else 0.0

    # -- drafting ----------------------------------------------------------
    @staticmethod
    def _history(run) -> np.ndarray:
        """The slot's prompt + generated history as int32, cached on the
        run and extended as it grows (restored runs rebuild it)."""
        done = len(run.tokens)
        cached = getattr(run, "_spec_hist", None)
        if cached is not None and cached[0] == done:
            return cached[1]
        if cached is not None and cached[0] < done:
            hist = np.concatenate([
                cached[1], np.asarray(run.tokens[cached[0]:], np.int32)])
        else:
            hist = np.concatenate([
                np.asarray(run.request.prompt, np.int32).reshape(-1),
                np.asarray(run.tokens, np.int32)])
        run._spec_hist = (done, hist)
        return hist

    def _propose(self) -> Tuple[np.ndarray, np.ndarray]:
        """(S, k) drafts and (S,) counts for this step: greedy decoding
        slots only (sampled ones keep k = 0), at most remaining - 1 so
        a draft never outruns the slot's budget."""
        S, k = self.num_slots, self.spec_k
        draft = np.zeros((S, k), np.int32)
        n = np.zeros((S,), np.int32)
        if k == 0:
            return draft, n
        cfg = self.spec
        for slot, run in enumerate(self._slots):
            if run is None or slot in self._prefill_slots:
                continue
            if run.request.temperature > 0:
                continue
            cap = min(k, int(self._remaining_host[slot]) - 1)
            if cap <= 0:
                continue
            prop = ngram_propose(self._history(run), cap, cfg.ngram_max,
                                 cfg.ngram_min)
            if prop.size:
                draft[slot, :prop.size] = prop
                n[slot] = prop.size
        return draft, n

    # -- decode ------------------------------------------------------------
    def step_block(self):
        """One draft-verify round over the pool, then ONE host sync:
        credit each slot its 0..k+1 emitted tokens, retire finished
        slots. Failure semantics are the plain block's:
        ``serving.poison`` and ``serving.step_block`` fire before the
        drafting (a retry drafts the same proposal: drafting is a pure
        function of host state), ``serving.harvest`` between the replay
        and the read (a retry reads the parked static output), and a
        NaN slot is quarantined alone."""
        W = self.spec_k + 1
        if self._pending_block is None:
            if not self.has_decoding():
                return
            if faults.should_fire("serving.poison"):
                self._poison_live_slot()
            faults.fault_point("serving.step_block")
            draft, n_draft = self._propose()
            t0 = time.perf_counter()
            with RecordEvent("serving.spec_verify"):
                self._pending_block = self.backend.spec_verify(draft,
                                                               n_draft)
            self.decode_s += time.perf_counter() - t0
            self.steps += 1
            self.verify_steps += 1
            proposed = int(n_draft.sum())
            self.draft_proposed += proposed
            # the verify lattice is S slots x (k + 1) positions a step
            self.slot_steps += self.num_slots * W
            _M_STEPS.inc()
            _M_COMPILES.set(self.decode_compile_count())
            self._note_decode_bytes(1)
            _M_SPEC_STEPS.inc()
            _M_SPEC_DRAFTED.inc(proposed)
        faults.fault_point("serving.harvest")
        t0 = time.perf_counter()
        packed = self._pending_block.cpu().numpy()    # ONE host sync/step
        self.decode_s += time.perf_counter() - t0
        self._pending_block = None
        toks_np, counts_np = packed[:, :W], packed[:, W]
        oks_np, rem_np = packed[:, W + 1].astype(bool), packed[:, W + 2]
        emitted = int(counts_np.sum())
        accepted = int(np.maximum(counts_np - 1, 0).sum())
        self.decode_tokens += emitted
        self.tokens_emitted += emitted
        self.draft_accepted += accepted
        _M_DECODE_TOKENS.inc(emitted)
        _M_TOKENS.inc(emitted)
        _M_SPEC_EMITTED.inc(emitted)
        _M_SPEC_ACCEPTED.inc(accepted)
        _M_SPEC_RATE.set(self.acceptance_rate())
        now = time.perf_counter()
        for slot, run in enumerate(self._slots):
            if run is None or slot in self._prefill_slots:
                continue
            n = int(counts_np[slot])
            if n > 0:
                run.tokens.extend(int(t) for t in toks_np[slot, :n])
            if self.nan_sentinel and n > 0 and not bool(oks_np[slot]):
                self.cancel_slot(slot, "poisoned")
                continue
            self._remaining_host[slot] = rem_np[slot]
            if rem_np[slot] == 0:
                self._retire(slot, run, now)

    # -- snapshot / restore ------------------------------------------------
    def snapshot_state(self):
        meta, arrays = super().snapshot_state()
        meta["spec"] = {"k": self.spec.k,
                        "ngram_max": self.spec.ngram_max,
                        "ngram_min": self.spec.ngram_min,
                        "verify_steps": self.verify_steps,
                        "draft_proposed": self.draft_proposed,
                        "draft_accepted": self.draft_accepted}
        return meta, arrays

    def restore_state(self, meta, arrays):
        sm = meta.get("spec")
        if sm is not None and sm["k"] != self.spec.k:
            raise ValueError(
                f"snapshot was taken at spec k={sm['k']}, this engine "
                f"runs k={self.spec.k} — the verify program shape (and "
                "the paged write window) must match to resume")
        super().restore_state(meta, arrays)
        if sm is not None:
            self.verify_steps = sm["verify_steps"]
            self.draft_proposed = sm["draft_proposed"]
            self.draft_accepted = sm["draft_accepted"]


class SpecEngine(_SpecEngineMixin, ContinuousBatchingEngine):
    """The dense engine with draft-verify decoding:
    ``ContinuousBatchingEngine(..., spec=SpecConfig(k=...))`` (or
    ``PT_SERVING_SPEC=<k>``), or this constructor."""

    def __init__(self, model=None, num_slots: int = 4, max_len: int = 256,
                 decode_block: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 backend=None, *, paged: Optional[bool] = None, spec=None,
                 tp=None, quant=None, megakernel: Optional[bool] = None,
                 device=None):
        if paged:
            raise ValueError(
                "SpecEngine is the dense speculative engine — use the "
                "ContinuousBatchingEngine factory (paged=True, spec=...) "
                "or SpecPagedEngine for the paged one")
        if backend is not None:
            if getattr(backend, "spec", None) is None:
                raise ValueError(
                    "speculative engines need a spec backend "
                    "(SpecModelStepBackend); got "
                    f"{type(backend).__name__}")
            spec = backend.spec
        self._init_spec(spec, tp)
        super().__init__(model, num_slots, max_len, decode_block,
                         prompt_buckets, backend, paged=False, spec=spec,
                         quant=quant, megakernel=megakernel, device=device)

    def _build_backend(self, model, num_slots, max_len, decode_block,
                       megakernel, quant):
        return SpecModelStepBackend(model, num_slots, max_len,
                                    decode_block, self.spec, megakernel,
                                    quant)


class SpecPagedEngine(_SpecEngineMixin, PagedEngine):
    """The paged engine with draft-verify decoding (chunked prefill,
    prefix reuse and the block manager unchanged: a window's writes past
    the slot's table land in the trash block, and accepted positions lie
    in the blocks the request allocated up front)."""

    def __init__(self, model=None, num_slots: int = 4, max_len: int = 256,
                 decode_block: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 backend=None, *, paged: bool = True, spec=None, tp=None,
                 quant=None, block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_int8: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 megakernel: Optional[bool] = None, device=None):
        if paged is not None and not paged:
            raise ValueError(
                "SpecPagedEngine is the paged speculative engine — use "
                "the ContinuousBatchingEngine factory (spec=...) or "
                "SpecEngine for the dense one")
        self._init_spec(spec, tp)
        super().__init__(model, num_slots, max_len, decode_block,
                         prompt_buckets, backend, paged=True, spec=spec,
                         quant=quant, block_size=block_size,
                         num_blocks=num_blocks, kv_int8=kv_int8,
                         prefill_chunk=prefill_chunk, megakernel=megakernel,
                         device=device)

    def _build_paged_backend(self, model, num_slots, max_len, decode_block,
                             block_size, num_blocks, prefill_chunk, kv_int8,
                             megakernel, quant):
        return SpecPagedStepBackend(model, num_slots, max_len, decode_block,
                                    block_size, num_blocks, prefill_chunk,
                                    kv_int8, megakernel, quant, self.spec)
