"""Block-paged KV cache for the continuous-batching engine: shared
arena + per-slot block tables, ref-counted prefix reuse, chunked
prefill.

Counterpart of ``paddle_tpu/serving/paging.py``. ``BlockManager`` is the
same host logic (free list, refcounts, SHA1-chained prefix index with
LRU retention of released registered blocks; block 0 is the trash
block). ``PagedModelStepBackend`` owns the per-layer
``(num_blocks, block_size, kvh, d)`` arenas on the device — or, with
``kv_int8``, int8 code arenas plus ``(num_blocks, block_size, kvh)``
fp32 per-vector absmax scales (the EQuARX wire format; about 3.9x less
KV memory at head_dim 128) — and runs the two programs of the paged
engine: the decode block and the ``(1, prefill_chunk)`` prefill chunk.
``PagedEngine`` admits requests (reserving blocks, reusing prefixes),
streams prompts in chunks paced by the scheduler's token budget, arms
slots and releases blocks at retirement."""
from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as prng
from ..models.generation import decode_step_logprobs
from ..ops.decode_layer import FusedDecode
from ..ops.paged_attention import kv_int8_error_bound
from ..utils.flags import env_bool, env_flag, env_int
from .engine import (ContinuousBatchingEngine, _SlotRun, init_slot_state,
                     run_decode_block, slot_sample_logits)

__all__ = ["BlockManager", "PagedModelStepBackend", "PagedEngine"]

TRASH_BLOCK = 0


def _sha1_chain(parent_digest: bytes, tokens: Tuple[int, ...]) -> bytes:
    """Rolling block hash: H(parent_digest || token bytes). Chaining
    makes the key position-dependent — block j only matches block j of
    an identical prefix, never a same-content block elsewhere."""
    h = hashlib.sha1(parent_digest)
    h.update(np.asarray(tokens, np.int32).tobytes())
    return h.digest()


class BlockManager:
    """Host-side arena bookkeeping: free list, per-block refcounts,
    rolling-hash prefix index with LRU retention of released registered
    blocks. Pure python — it runs once per admission/retirement."""

    def __init__(self, num_blocks: int, block_size: int, hash_fn=None):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need at least "
                             "the trash block plus one usable block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.hash_fn = hash_fn or _sha1_chain
        self.reset()

    def reset(self):
        self._free: List[int] = list(range(1, self.num_blocks))
        self._ref: Dict[int, int] = {}          # allocated -> refcount
        self._index: Dict[bytes, Tuple[int, Tuple[int, ...]]] = {}
        self._digest_of: Dict[int, bytes] = {}  # registered blocks
        self._depth: Dict[bytes, int] = {}      # digest -> chain blocks
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # block id -> prefix-index hits observed (eviction cost signal)
        self._hits: Dict[int, int] = {}
        self.lookups = 0
        self.hit_blocks = 0
        self.evictions = 0

    # -- capacity ----------------------------------------------------------
    def available(self) -> int:
        return len(self._free) + len(self._cached)

    def usable_blocks(self) -> int:
        """Pool capacity excluding the trash block — a request needing
        more than this can never be admitted."""
        return self.num_blocks - 1

    def _evict_victim(self) -> int:
        """Pick and unregister the next cached block to evict: least
        observed prefix-index reuse first, ties broken by LRU age."""
        best, best_score = None, None
        for pos, b in enumerate(self._cached):
            score = (self._hits.get(b, 0), pos)
            if best_score is None or score < best_score:
                best, best_score = b, score
        del self._cached[best]
        digest = self._digest_of.pop(best)
        del self._index[digest]
        self._depth.pop(digest, None)
        self._hits.pop(best, None)
        self.evictions += 1
        return best

    def allocate(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, evicting cached prefix blocks if
        the free list runs short; None if the pool can't cover the
        request (the caller re-queues)."""
        if self.available() < n:
            return None
        out = []
        for _ in range(n):
            b = self._free.pop() if self._free else self._evict_victim()
            self._ref[b] = 1
            out.append(b)
        return out

    # -- prefix sharing ----------------------------------------------------
    def _shareable_blocks(self, prompt) -> int:
        # whole blocks only, and never the one holding the LAST prompt
        # token — at least one token must prefill so the first-token
        # logits exist
        return (len(prompt) - 1) // self.block_size

    def match_prefix(self, prompt) -> List[int]:
        """Longest chain of indexed blocks matching the prompt's full
        prefix blocks; each match is ref-acquired for the caller. A
        digest hit whose stored tokens differ (hash collision) stops the
        chain — the caller recomputes from there."""
        bs = self.block_size
        self.lookups += 1
        blocks: List[int] = []
        parent = b""
        for j in range(self._shareable_blocks(prompt)):
            chunk = tuple(int(t) for t in prompt[j * bs:(j + 1) * bs])
            digest = self.hash_fn(parent, chunk)
            entry = self._index.get(digest)
            if entry is None or entry[1] != chunk:
                break
            blocks.append(entry[0])
            parent = digest
        for b in blocks:
            self._acquire(b)
            self._hits[b] = self._hits.get(b, 0) + 1
        self.hit_blocks += len(blocks)
        return blocks

    def _acquire(self, block_id: int):
        r = self._ref.get(block_id, 0)
        if r == 0:                    # resurrect from the LRU cache
            del self._cached[block_id]
        self._ref[block_id] = r + 1

    def register_prefix(self, prompt, block_ids: Sequence[int],
                        n_blocks: Optional[int] = None):
        """Index the prompt's full prefix blocks (now filled) so later
        requests can share them; re-registering matched blocks derives
        the same digests (no-ops). ``n_blocks`` overrides the default
        shareable count (decode-time sharing passes the fully written
        block count of the completed sequence)."""
        bs = self.block_size
        if n_blocks is None:
            n_blocks = self._shareable_blocks(prompt)
        parent = b""
        for j in range(n_blocks):
            chunk = tuple(int(t) for t in prompt[j * bs:(j + 1) * bs])
            digest = self.hash_fn(parent, chunk)
            bid = block_ids[j]
            if digest not in self._index and bid not in self._digest_of:
                self._index[digest] = (bid, chunk)
                self._digest_of[bid] = digest
            self._depth[digest] = j + 1
            parent = digest

    def release(self, block_ids: Sequence[int]):
        """Drop one reference per block. At refcount 0 a registered
        block parks in the LRU cache (still matchable); an unregistered
        one returns to the free list. Releasing an unheld block is a
        hard error — the double-free guard."""
        for bid in block_ids:
            r = self._ref.get(bid)
            if not r:
                raise RuntimeError(f"double free of arena block {bid}")
            if r > 1:
                self._ref[bid] = r - 1
            else:
                del self._ref[bid]
                if bid in self._digest_of:
                    self._cached[bid] = None
                else:
                    self._free.append(bid)

    # -- invariants --------------------------------------------------------
    def assert_consistent(self):
        """Hard-check the arena accounting invariants: free + referenced
        + LRU-retained partition the usable pool exactly; every refcount
        >= 1; the prefix index and the registered-block map are mutual
        inverses; retained blocks are registered; no free block is
        registered."""
        free, ref = set(self._free), set(self._ref)
        cached, reg = set(self._cached), set(self._digest_of)
        assert len(self._free) == len(free), \
            f"duplicate ids in free list: {sorted(self._free)}"
        assert not (free & ref), f"free AND referenced: {free & ref}"
        assert not (free & cached), f"free AND retained: {free & cached}"
        assert not (ref & cached), \
            f"referenced AND retained: {ref & cached}"
        universe = free | ref | cached
        assert TRASH_BLOCK not in universe, "trash block was allocated"
        want = set(range(1, self.num_blocks))
        assert universe == want, (
            f"block accounting leak: missing {sorted(want - universe)}, "
            f"unknown {sorted(universe - want)}")
        bad_refs = {b: r for b, r in self._ref.items() if r < 1}
        assert not bad_refs, f"non-positive refcounts: {bad_refs}"
        assert cached <= reg, f"retained but unregistered: {cached - reg}"
        assert not (free & reg), f"free but still registered: {free & reg}"
        assert len(self._index) == len(reg), \
            "prefix index and registered-block map out of sync"
        for digest, (bid, _) in self._index.items():
            assert self._digest_of.get(bid) == digest, \
                f"index entry for block {bid} disagrees with digest map"
        stale_depth = set(self._depth) - set(self._index)
        assert not stale_depth, \
            "chain-depth entries for unregistered digests: " \
            f"{sorted(d.hex() for d in stale_depth)}"
        stale_hits = set(self._hits) - reg
        assert not stale_hits, \
            f"reuse tallies for unregistered blocks: {sorted(stale_hits)}"


class PagedModelStepBackend:
    """The paged engine's two device programs over a live model: the
    decode block threads the per-slot block tables through the forward,
    and prefill is ONE fixed-shape ``(1, prefill_chunk)`` chunk. Owns
    the per-layer arenas, which the forward updates in place: (k, v)
    pairs, or (k codes, v codes, k scales, v scales) with ``kv_int8``.
    With ``megakernel`` every decode step routes each decode layer
    through the fused decode-layer call (``fused_decode``, which owns
    the megakernel's scratch)."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, block_size: int, num_blocks: int,
                 prefill_chunk: int, kv_int8: bool = False,
                 megakernel: bool = False):
        if max_len % block_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"block_size={block_size}")
        self.model = model
        self.device = model.device
        self.num_slots, self.max_len = num_slots, max_len
        self.block_size = decode_block
        self.kv_block_size = block_size
        self.num_kv_blocks = num_blocks
        self.max_blocks = max_len // block_size
        self.prefill_chunk_len = prefill_chunk
        self.kv_int8 = bool(kv_int8)
        self.cache = model.init_paged_kv_cache(num_blocks, block_size,
                                               kv_int8=self.kv_int8)
        self.fused_decode = FusedDecode() if megakernel else None

    def init_state(self):
        state = init_slot_state(self.num_slots, self.device)
        state["table"] = torch.zeros((self.num_slots, self.max_blocks),
                                     dtype=torch.int32,
                                     device=self.device)   # all-trash
        return state

    def kv_bytes_per_slot(self) -> int:
        """Device bytes of KV arena per slot (codes and scales under
        the int8 arena): the shared arena over the slot count."""
        total = sum(t.numel() * t.element_size()
                    for layer in self.cache for t in layer)
        return total // self.num_slots

    def _step(self, tok, pos, table):
        logp = decode_step_logprobs(self.model, tok, self.cache, pos, table,
                                    fused_decode=self.fused_decode)
        if self.fused_decode is not None and self.fused_decode.rewrites == 0:
            raise RuntimeError(
                "megakernel decode requested but no decode layer went "
                "through the fused call — the model must route its decode "
                "layers (see models/llama.py LlamaDecoderLayer."
                "_fused_decode)")
        return logp

    def decode_block(self, state, sampled_rows):
        return run_decode_block(self._step, state, self.block_size,
                                sampled_rows)

    def prefill_chunk(self, ids: np.ndarray, table_row: np.ndarray,
                      start_pos: int, n_valid: int) -> torch.Tensor:
        """One right-padded (1, prefill_chunk) token window written into
        the arena through the request's table row; returns the (1, V)
        log-probs at the last real column. Pad columns carry junk K/V
        that decode overwrites before it can be attended; writes past
        the table width land in the trash block."""
        dev = self.device
        return decode_step_logprobs(
            self.model, torch.as_tensor(ids, device=dev), self.cache,
            torch.tensor([start_pos], dtype=torch.int32, device=dev),
            torch.as_tensor(table_row[None], device=dev),
            last_index=n_valid - 1)


def _arm_fn(state, slot, table_row, tok0, pos0, rem0, eos0, temp0, topk0,
            topp0, key0):
    """Turn a slot live after its chunked prefill finished: the arena
    already holds the prompt's K/V, so arming is a state update in
    place."""
    state["tok"][slot] = tok0
    state["pos"][slot] = pos0
    state["live"][slot] = rem0 > 0
    state["eos"][slot] = eos0
    state["remaining"][slot] = rem0
    state["temp"][slot] = temp0
    state["topk"][slot] = topk0
    state["topp"][slot] = topp0
    state["key"][slot] = key0
    state["table"][slot] = torch.as_tensor(table_row,
                                           device=state["table"].device)


@dataclass
class _PrefillJob:
    """One admitted request still streaming its prompt into the arena
    (``done`` counts tokens already resident, the shared prefix it
    skipped included)."""
    run: _SlotRun
    slot: int
    prompt: np.ndarray
    done: int
    table_row: np.ndarray          # (max_blocks,) int32
    key: torch.Tensor              # (2,) the slot's key once armed
    sub: torch.Tensor              # (2,) the first token's sampling key


class PagedEngine(ContinuousBatchingEngine):
    """Paged-KV continuous batching over a ``LlamaForCausalLM``.

    - ``try_admit()`` reserves blocks (reusing indexed prefix blocks)
      and queues a prefill job; it returns False when the block pool is
      exhausted and the Server re-queues.
    - :meth:`prefill_tick` streams prompts into the arena in
      ``(1, prefill_chunk)`` chunks; the slot arms when its last chunk
      lands, with the first token sampled from that chunk.
    - prompts are unpadded: position 0 is token 0, which is what makes
      whole prefix blocks shareable across requests.
    - ``kv_int8=True`` (or ``PT_SERVING_KV_INT8=1``) stores the arena as
      int8 codes plus per-(position, kv head) fp32 absmax scales; the s=1
      read dequantizes inside the int8 paged-decode kernel, and
      :meth:`kv_error_bound` gives the worst-case dequantization error.
    - ``megakernel=True`` (or ``PT_SERVING_MEGAKERNEL=1``) runs each
      decode layer of a decode step as one launch of the decode-layer
      megakernel (``ops/decode_layer.py``) where the card's kernel takes
      it; :meth:`megakernel_rewrites` and
      :meth:`megakernel_kernel_calls` report the last step's routing.

    ``block_size`` and ``prefill_chunk`` resolve as in the JAX engine:
    the argument, else ``PT_SERVING_BLOCK_SIZE`` /
    ``PT_SERVING_PREFILL_CHUNK``, else 16 / twice the block size (there
    is no autotune table). ``device`` must match the model's (default
    the GPU)."""

    def __init__(self, model, num_slots: int = 4, max_len: int = 256,
                 decode_block: int = 8, *, block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_int8: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 megakernel: Optional[bool] = None, device=None):
        from ..device import resolve_device
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, engine asked "
                             f"for {dev}")
        if block_size is None:
            block_size = env_int("PT_SERVING_BLOCK_SIZE", 0)
            if block_size <= 0:
                block_size = 16
        if num_blocks is None:
            # full dense capacity + trash by default
            num_blocks = 1 + num_slots * (max_len // block_size)
        if kv_int8 is None:
            kv_int8 = env_flag("PT_SERVING_KV_INT8")
        if prefill_chunk is None:
            prefill_chunk = env_int("PT_SERVING_PREFILL_CHUNK",
                                    2 * block_size)
        if megakernel is None:
            megakernel = env_bool("PT_SERVING_MEGAKERNEL")
        backend = PagedModelStepBackend(model, num_slots, max_len,
                                        decode_block, block_size,
                                        num_blocks, prefill_chunk,
                                        bool(kv_int8), bool(megakernel))
        self.kv_int8 = backend.kv_int8
        self.kv_block_size = block_size
        self.num_kv_blocks = num_blocks
        self.max_blocks = backend.max_blocks
        self.prefill_chunk_len = prefill_chunk
        self.manager = BlockManager(num_blocks, block_size)
        super().__init__(backend)

    # -- lifecycle ---------------------------------------------------------
    def reset(self):
        """Free every slot and block and zero the arena in place (the
        JAX engine starts from a fresh zero arena), so
        :meth:`kv_error_bound` sees only what was written since."""
        super().reset()
        for layer in self.backend.cache:
            for t in layer:
                t.zero_()
        self.manager.reset()
        self._jobs: List[_PrefillJob] = []
        self.prompt_tokens = 0         # all prompt tokens admitted
        self.shared_tokens = 0         # skipped via prefix reuse
        self.prefilled_tokens = 0      # actually computed
        self.prefill_chunks = 0        # chunk programs dispatched
        self.prefill_s = 0.0           # host wall in prefill_tick

    # -- introspection -----------------------------------------------------
    def prefix_cache_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from shared prefix
        blocks instead of recomputed."""
        return self.shared_tokens / self.prompt_tokens \
            if self.prompt_tokens else 0.0

    def kv_error_bound(self) -> float:
        """Runtime worst-case |dequantized - fp32| over the int8 arena
        (0.0 for an fp32/bf16 arena): the single-quantization bound from
        the largest absmax scale the arena holds."""
        if not self.kv_int8:
            return 0.0
        worst = max(float(s.max()) for layer in self.backend.cache
                    for s in layer[2:])
        return float(kv_int8_error_bound(worst))

    def blocks_needed(self, prompt_len: int, max_new_tokens: int) -> int:
        # positions written: prompt [0, L) plus generated tokens at
        # [L, L+max_new-1) — the final sampled token is never written
        return -(-(prompt_len + max(max_new_tokens - 1, 0))
                 // self.kv_block_size)

    def validate_request(self, prompt_len: int, max_new_tokens: int):
        super().validate_request(prompt_len, max_new_tokens)
        need = self.blocks_needed(prompt_len, max_new_tokens)
        pool = self.manager.usable_blocks()
        if need > pool:
            raise ValueError(
                f"request needs {need} KV blocks but the arena only "
                f"has {pool}; raise num_blocks or shorten the request")

    # -- admission ---------------------------------------------------------
    def try_admit(self, request) -> bool:
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        L = int(prompt.shape[0])
        self.validate_request(L, request.max_new_tokens)
        slot = next((i for i, s in enumerate(self._slots) if s is None),
                    None)
        if slot is None:
            raise RuntimeError("no free slot (scheduler bug)")
        shared = self.manager.match_prefix(prompt)
        total = self.blocks_needed(L, request.max_new_tokens)
        fresh = self.manager.allocate(total - len(shared))
        if fresh is None:            # pool exhausted: retry later
            self.manager.release(shared)
            return False
        block_ids = shared + fresh
        table_row = np.zeros((self.max_blocks,), np.int32)
        table_row[:len(block_ids)] = block_ids
        # the JAX key schedule (generate()'s): PRNGKey(seed), split into
        # the slot's key and the first token's sub-key. Two words on the
        # host, then one copy to the device.
        key, sub = prng.split(prng.prng_key(request.seed)) \
            .to(self.backend.device)
        run = _SlotRun(request, block_ids=block_ids)
        self._slots[slot] = run
        self._prefill_slots.add(slot)
        n_shared = len(shared) * self.kv_block_size
        self.prompt_tokens += L
        self.shared_tokens += n_shared
        self._jobs.append(_PrefillJob(run=run, slot=slot, prompt=prompt,
                                      done=n_shared, table_row=table_row,
                                      key=key, sub=sub))
        return True

    # -- chunked prefill ---------------------------------------------------
    def prefill_tick(self, token_budget: Optional[int] = None) -> int:
        """Advance pending prefill jobs by up to ``token_budget`` prompt
        tokens (always at least one chunk when work is pending). Jobs
        run FIFO; a finished job arms its slot, or retires at once on
        eos / max_new_tokens == 1."""
        t0 = time.perf_counter()
        spent = 0
        C = self.prefill_chunk_len
        while self._jobs and (token_budget is None or spent == 0
                              or spent < token_budget):
            job = self._jobs[0]
            L = len(job.prompt)
            n = min(C, L - job.done)
            ids = np.zeros((1, C), np.int32)
            ids[0, :n] = job.prompt[job.done:job.done + n]
            logp = self.backend.prefill_chunk(ids, job.table_row,
                                              job.done, n)
            job.done += n
            spent += n
            self.prefill_chunks += 1
            self.prefilled_tokens += n
            if job.done >= L:
                self._jobs.pop(0)
                self._finish_prefill(job, logp)
        self.prefill_s += time.perf_counter() - t0
        return spent

    def _finish_prefill(self, job: _PrefillJob, logp: torch.Tensor):
        req = job.run.request
        dev = self.backend.device
        tok0 = int(slot_sample_logits(
            logp, torch.tensor([req.temperature], device=dev),
            torch.tensor([req.top_k], device=dev),
            torch.tensor([req.top_p], device=dev),
            job.sub[None] if req.temperature > 0.0 else None)[0])
        now = time.perf_counter()
        job.run.tokens = [tok0]
        job.run.t_admit = now               # TTFT timestamp
        self.tokens_emitted += 1
        eos = req.eos_token_id
        rem0 = req.max_new_tokens - 1
        if eos is not None and tok0 == eos:
            rem0 = 0
        # the prompt's full blocks are resident now — index them so the
        # NEXT request with this prefix skips the compute
        self.manager.register_prefix(job.prompt, job.run.block_ids)
        self._prefill_slots.discard(job.slot)
        if rem0 <= 0:                # finished at admission
            self._retire(job.slot, job.run, now)
            return
        _arm_fn(self._state, job.slot, job.table_row, tok0, len(job.prompt),
                rem0, -1 if eos is None else eos, req.temperature,
                req.top_k, req.top_p, job.key)

    def _retire(self, slot, run, now):
        super()._retire(slot, run, now)
        if run.block_ids is not None:
            if run.failure is None and run.tokens:
                # decode-time block sharing: every position the stream
                # WROTE is resident — prompt plus generated history minus
                # the final sampled token. Failed runs register nothing.
                seq = np.concatenate([
                    np.asarray(run.request.prompt, np.int32).reshape(-1),
                    np.asarray(run.tokens[:-1], np.int32)])
                self.manager.register_prefix(
                    seq, run.block_ids,
                    n_blocks=len(seq) // self.kv_block_size)
            self.manager.release(run.block_ids)
            run.block_ids = None     # the no-double-free invariant

    def _abort_prefill(self, slot):
        self._jobs = [j for j in self._jobs if j.slot != slot]
