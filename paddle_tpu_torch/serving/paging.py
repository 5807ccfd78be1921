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
engine: the decode block and the ``(1, prefill_chunk)`` prefill chunk,
each captured once as a CUDA graph on the card (``graphs``).
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
from .engine import (ContinuousBatchingEngine, _arm_fn, _checked_step,
                     _refuse_unported, _SlotRun, free_slot_state,
                     init_slot_state, run_decode_block, slot_sample_logits)
from ..graphs import CapturedProgram

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
    and prefill is ONE fixed-shape ``(1, prefill_chunk)`` chunk that also
    samples the request's candidate first token. Owns the per-layer
    arenas, which the forward updates in place: (k, v) pairs, or (k
    codes, v codes, k scales, v scales) with ``kv_int8``. With
    ``megakernel`` every decode step routes each decode layer through
    the fused decode-layer call (``fused_decode``, which owns the
    megakernel's scratch).

    Both programs work on static tensors the backend owns: the slot
    ``state``, the block's output and the chunk's inputs and output.
    On the card each is captured once, here at construction while every
    slot is free, so the warm-up's arena writes land in the trash block
    0 (``decode_program``, ``prefill_program``); on the CPU each call
    runs the same function eagerly. The prefill chunk stays unfused
    under ``megakernel``, as in JAX
    (``paddle_tpu/serving/paging.py:452-454``)."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, block_size: int, num_blocks: int,
                 prefill_chunk: int, kv_int8: bool = False,
                 megakernel: bool = False):
        if max_len % block_size != 0:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"block_size={block_size}")
        self.model = model
        self.device = dev = model.device
        self.num_slots, self.max_len = num_slots, max_len
        self.block_size = decode_block
        self.kv_block_size = block_size
        self.num_kv_blocks = num_blocks
        self.max_blocks = mb = max_len // block_size
        self.prefill_chunk_len = prefill_chunk
        self.kv_int8 = bool(kv_int8)
        self.cache = model.init_paged_kv_cache(num_blocks, block_size,
                                               kv_int8=self.kv_int8)
        self.fused_decode = FusedDecode() if megakernel else None
        self.state = init_slot_state(num_slots, dev)
        self.state["table"] = torch.zeros((num_slots, mb), dtype=torch.int32,
                                          device=dev)       # all-trash
        self._block_out = torch.zeros((2 * decode_block + 1, num_slots),
                                      dtype=torch.int32, device=dev)
        # the chunk's inputs in one int32 buffer, filled by one copy, as
        # named slices: ids, the table row, (start position, last real
        # column, top-k), then (temperature, top-p) as fp32 bits; the
        # sampling key (a device tensor already) and the candidate token
        C = prefill_chunk
        self._chunk_fields = dict(
            ids=slice(0, C), table=slice(C, C + mb),
            ints=slice(C + mb, C + mb + 3),
            floats=slice(C + mb + 3, C + mb + 5))
        self._chunk_args = torch.zeros(C + mb + 5, dtype=torch.int32,
                                       device=dev)
        self._chunk_key = torch.zeros(2, dtype=torch.int64, device=dev)
        self._chunk_tok = torch.zeros(1, dtype=torch.int32, device=dev)
        self.decode_program = CapturedProgram(self._run_block, dev)
        self.prefill_program = CapturedProgram(self._run_chunk, dev)
        self.decode_program.capture()
        self.prefill_program.capture()
        self.reset_state()

    def reset_state(self):
        """Free every slot in place (all-trash tables); returns the
        state dict the decode block reads."""
        free_slot_state(self.state)
        self.state["table"].zero_()
        return self.state

    def kv_bytes_per_slot(self) -> int:
        """Device bytes of KV arena per slot (codes and scales under
        the int8 arena): the shared arena over the slot count."""
        total = sum(t.numel() * t.element_size()
                    for layer in self.cache for t in layer)
        return total // self.num_slots

    def _step(self, tok, pos, table):
        return _checked_step(self.model, self.cache, self.fused_decode, tok,
                             pos, block_table=table)

    def _run_block(self):
        run_decode_block(self._step, self.state, self._block_out)

    def decode_block(self) -> torch.Tensor:
        """Run one decode block over ``state`` (in place); returns the
        static (2 * block + 1, S) int32 output of
        :func:`~.engine.run_decode_block`, valid until the next block."""
        self.decode_program()
        return self._block_out

    def _run_chunk(self):
        args, f = self._chunk_args, self._chunk_fields
        start, last, topk = args[f["ints"]].split(1)
        temp, topp = args[f["floats"]].view(torch.float32).split(1)
        logp = decode_step_logprobs(self.model, args[f["ids"]].view(1, -1),
                                    self.cache, start,
                                    args[f["table"]].view(1, -1),
                                    last_index=last)
        self._chunk_tok.copy_(slot_sample_logits(
            logp, temp, topk, topp, self._chunk_key[None]))

    def prefill_chunk(self, ids: np.ndarray, table_row: np.ndarray,
                      start_pos: int, n_valid: int, key: torch.Tensor,
                      temperature: float, top_k: int,
                      top_p: float) -> torch.Tensor:
        """One right-padded (1, prefill_chunk) token window written into
        the arena through the request's table row, and the candidate
        first token sampled from its last real column with the request's
        ``key`` (2,), temperature, top-k and top-p (``chunk_fn``). Pad
        columns carry junk K/V that decode overwrites before it can be
        attended; writes past the table width land in the trash block.
        Returns the static (1,) int32 token on the device, valid until
        the next chunk."""
        f = self._chunk_fields
        host = np.empty(self._chunk_args.numel(), np.int32)
        host[f["ids"]] = ids.reshape(-1)
        host[f["table"]] = table_row
        host[f["ints"]] = (start_pos, n_valid - 1, top_k)
        host[f["floats"]] = np.array([temperature, top_p],
                                     np.float32).view(np.int32)
        self._chunk_args.copy_(torch.from_numpy(host))
        self._chunk_key.copy_(key)
        self.prefill_program()
        return self._chunk_tok


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
      :meth:`megakernel_kernel_calls` report the routing of the last
      step the Python code ran (on the card, the captured one).
    - on the card the decode block and the prefill chunk are each ONE
      CUDA graph, captured when the engine is built and replayed from
      then on (:meth:`decode_compile_count` and
      :meth:`prefill_compile_count` give 1 over any stream); on the CPU
      the same functions run eagerly and both counts are 0.

    ``block_size`` and ``prefill_chunk`` resolve as in the JAX engine:
    the argument, else ``PT_SERVING_BLOCK_SIZE`` /
    ``PT_SERVING_PREFILL_CHUNK``, else 16 / twice the block size (there
    is no autotune table). ``device`` must match the model's (default
    the GPU). It is also what ``ContinuousBatchingEngine(..., paged=True)``
    builds, so it takes that signature: ``prompt_buckets`` is refused
    (paged prompts are unpadded), and so are an explicit ``backend`` (the
    engine builds its own from the model) and ``paged=False``."""

    def __init__(self, model=None, num_slots: int = 4, max_len: int = 256,
                 decode_block: int = 8,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 backend=None, *, paged: bool = True, spec=None, tp=None,
                 quant=None, block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 kv_int8: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 megakernel: Optional[bool] = None, device=None):
        from ..device import resolve_device
        _refuse_unported(spec, tp, quant)
        if not paged:
            raise ValueError("PagedEngine is the paged engine; build the "
                             "dense one with ContinuousBatchingEngine("
                             "model, paged=False)")
        if prompt_buckets is not None:
            raise ValueError(
                "paged mode takes no prompt_buckets: prompts are "
                "unpadded and prefilled in fixed-size chunks")
        if backend is not None:
            raise ValueError("PagedEngine builds its own backend from the "
                             "model; pass the model")
        if model is None:
            raise ValueError("pass a model")
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
        self.prompt_buckets = None
        self._init_engine(backend)

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
    def prefill_compile_count(self) -> int:
        """Captures of the prefill chunk program: 1 on the card over any
        stream, 0 on the CPU (the JAX engine's trace count)."""
        return self.backend.prefill_program.captures

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
            req = job.run.request
            tok0 = self.backend.prefill_chunk(
                ids, job.table_row, job.done, n, job.sub, req.temperature,
                req.top_k, req.top_p)
            job.done += n
            spent += n
            self.prefill_chunks += 1
            self.prefilled_tokens += n
            if job.done >= L:
                self._jobs.pop(0)
                # the one host read of a prefill, on its last chunk
                self._finish_prefill(job, int(tok0))
        self.prefill_s += time.perf_counter() - t0
        return spent

    def _finish_prefill(self, job: _PrefillJob, tok0: int):
        req = job.run.request
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
        # the arena already holds the prompt's K/V: arming is a state
        # update in place
        _arm_fn(self._state, job.slot, tok=tok0, pos=len(job.prompt),
                live=True, eos=-1 if eos is None else eos, remaining=rem0,
                temp=req.temperature, topk=req.top_k, topp=req.top_p,
                key=job.key, table=torch.as_tensor(
                    job.table_row, device=self.backend.device))

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
