"""KV-cache attention, sampling and ``generate()``.

Counterpart of ``paddle_tpu/models/generation.py``:

- ``cached_attention`` with all of its branches: a dense cache written
  at one position for the whole batch (``generate()``; RoPE through the
  fused kernel, or per row with left padding), a dense cache written at
  per-row positions (the dense engine's slot pool), and the paged arena
  (the paged engine), each read through the causal, pad and
  sliding-window mask;
- ``sample_logits``, the pure step of ``build_decode_step`` (sampled or
  log-prob head, with ``last_index`` for right-padded prefill chunks,
  and the all-positions head of the speculative verify step);
- ``GenerationMixin.generate`` with greedy, sampled and beam decoding
  and left-padded ragged prompts.

The JAX step is a pure function that returns a new cache; here every
cache is updated in place (no copy of a multi-GB cache per step), and
everything else is the same sequence. JAX compiles ``generate()``'s
decode step once per sampling configuration and caches it on the model;
here the s = 1 step is one CUDA graph per (batch, cache length, cache
dtype, padding, sampling configuration), captured at the first call and
cached on the model (``_decode_fn_cache``), and run eagerly on the CPU.
The step owns its cache, so the model keeps only the last one built.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import random as prng
from ..ops.fused import fused_rope
from ..ops.paged_attention import (dense_attention, dequantize_kv,
                                   paged_attention_decode,
                                   paged_attention_decode_int8,
                                   paged_gather, write_paged_kv)
from ..utils.enforce import OutOfRangeError

__all__ = ["cached_attention", "decode_step", "decode_step_logprobs",
           "sample_logits", "GenerationMixin"]


def sample_logits(logits: torch.Tensor, key: torch.Tensor,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Token ids from (b, V) fp32 logits with ONE (2,) threefry ``key``
    for the whole batch (the JAX ``sample_logits``: one Gumbel draw of
    shape (b, V)); temperature <= 0 is greedy. The sampling parameters
    are host values that pick the branch, as in JAX: top-k alone takes
    the k-th largest value, top-p (with or without top-k) one
    descending sort. Returns (b,) int64."""
    if temperature is None or temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    # a true fp32 division by a device scalar (a host scalar would let
    # the CUDA kernel multiply by its reciprocal); made on the device,
    # so a captured graph holds no host copy
    logits = logits / torch.full((), float(np.float32(temperature)),
                                 dtype=logits.dtype, device=logits.device)
    v = logits.shape[-1]
    neg_inf = float("-inf")
    want_k = bool(top_k) and 0 < top_k < v
    if want_k and top_p >= 1.0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    elif top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if want_k:
            kth = sorted_desc[..., top_k - 1:top_k]
            logits = torch.where(logits < kth, neg_inf, logits)
            sorted_desc = torch.where(sorted_desc < kth, neg_inf,
                                      sorted_desc)
        cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
        # an index of v (every cumulative share below top_p) gathers
        # NaN in JAX and masks nothing; the last column's value masks
        # nothing either
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=v - 1)
        cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return torch.argmax(prng.gumbel(key, logits.shape) + logits, dim=-1)


def _rope_rows(x, c, sn):
    """Neox rotate-half with per-row (b, s, d) cos/sin."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return x * c[:, :, None, :] + rot * sn[:, :, None, :]


def _per_row(pos) -> bool:
    """(b,) positions (the slot pools) against one position for the
    batch (an int or a 0-dim tensor: ``generate()``)."""
    return isinstance(pos, torch.Tensor) and pos.dim() == 1


def _rotate(q, k, cos, sin, pos, pad):
    """RoPE of the cache path (JAX ``cached_attention:110-131``): one
    position for an unpadded batch goes through the fused kernel, on
    the table rows pos .. pos + s - 1 (a device position takes the
    kernel's device start); otherwise each row rotates at
    ``clip(pos + i - pad, 0)``."""
    s, T = q.shape[1], cos.shape[0]
    if pad is None:
        c, sn = cos.to(q.dtype), sin.to(q.dtype)
        if isinstance(pos, torch.Tensor):
            return fused_rope(q, k, c, sn,
                              start=pos.to(torch.int32).reshape(1))
        p0 = min(max(int(pos), 0), T - s)
        return fused_rope(q, k, c[p0:p0 + s], sn[p0:p0 + s])
    steps = torch.arange(s, device=q.device, dtype=torch.int32)
    p2 = pos.to(torch.int32)[:, None] if _per_row(pos) else pos
    positions = (p2 + steps[None, :] - pad.to(torch.int32)[:, None]) \
        .clamp(0, T - 1).long()
    c = cos[positions].to(q.dtype)                            # (b, s, d)
    sn = sin[positions].to(q.dtype)
    return _rope_rows(q, c, sn), _rope_rows(k, c, sn)


def _write_dense(cache, k, v, pos):
    """k/v (b, s, kvh, d) into the dense (b, T, kvh, d) cache, in place:
    per row at ``pos`` (b,) — for s = 1 its start clamped into the cache
    as ``dynamic_update_slice`` clamps it; for s > 1 (the speculative
    verify window) at ``pos .. pos + s - 1`` with the columns past the
    cache dropped, as JAX's scatter drops them (a clamp would move them
    back over valid entries) — or at one position for the batch,
    clamped to [0, T - s]."""
    kc, vc = cache
    b, s = k.shape[:2]
    T = kc.shape[1]
    if _per_row(pos) and s > 1:
        rows = torch.arange(b, device=kc.device)[:, None]
        tpos = pos.long()[:, None] + torch.arange(s, device=kc.device)
        keep = tpos < T
        # a dropped column repeats column 0's write (its index and
        # value): the scatter stays in range, takes no data-dependent
        # shape and changes no other entry
        idx = torch.where(keep, tpos, tpos[:, :1].clamp(max=T - 1))
        keep = keep[..., None, None]
        kc[rows, idx] = torch.where(keep, k, k[:, :1]).to(kc.dtype)
        vc[rows, idx] = torch.where(keep, v, v[:, :1]).to(vc.dtype)
    elif _per_row(pos):
        rows = torch.arange(b, device=kc.device)
        idx = pos.long().clamp(0, T - 1)
        kc[rows, idx] = k[:, 0].to(kc.dtype)
        vc[rows, idx] = v[:, 0].to(vc.dtype)
    elif isinstance(pos, torch.Tensor):
        idx = pos.long().clamp(0, T - s) \
            + torch.arange(s, device=kc.device)
        kc.index_copy_(1, idx, k.to(kc.dtype))
        vc.index_copy_(1, idx, v.to(vc.dtype))
    else:
        p0 = min(max(int(pos), 0), T - s)
        kc[:, p0:p0 + s] = k.to(kc.dtype)
        vc[:, p0:p0 + s] = v.to(vc.dtype)


def cached_attention(q, k, v, k_cache, v_cache, pos, *, scale, cos, sin,
                     block_table=None, kv_scales=None, window=None,
                     pad=None):
    """One KV-cache attention step, shared by prefill (s > 1) and decode
    (s = 1): RoPE, the cache write, the masked read. q (b, s, h, d),
    k/v (b, s, kvh, d); returns the (b, s, h, d) output and updates the
    cache in place.

    ``pos``: one write position for the batch (an int, or a 0-dim int
    tensor on the device, which a captured step reads there), or (b,)
    per-row positions (the slot pools). ``pad`` (b,): left-padding
    counts; a row's RoPE positions shift back by its pad and its keys
    below the pad are never attended. ``window``: the sliding window.

    Dense mode (no ``block_table``): the caches are (b, T, kvh, d) and
    the read is the dense einsum sequence over all T positions. Paged
    mode: the caches are (num_blocks, block_size, kvh, d) arenas, row
    r's position t lives at block ``block_table[r, t // bs]``, offset
    ``t % bs`` (positions past the table width go to the trash block
    0), and ``pad`` is ignored (paged prompts are unpadded). An s = 1
    paged step without a window reads through the paged-decode kernel;
    a chunk, or a windowed step, gathers the table and runs the dense
    sequence. With ``kv_scales=(k_scales, v_scales)`` the arenas hold
    int8 codes and the scales (num_blocks, block_size, kvh) fp32
    absmaxes: k/v are quantized per (position, kv head) vector, s = 1
    reads through the int8 decode kernel, a chunk dequantizes the
    gathered table (the JAX package's ``generation.py:145-166``)."""
    b, s = q.shape[:2]
    dev = q.device
    if block_table is not None:
        if not _per_row(pos):         # paged timelines are always per row
            pos = torch.as_tensor(pos, dtype=torch.int32,
                                  device=dev).reshape(1).expand(b)
        pad = None
        steps = torch.arange(s, device=dev, dtype=torch.int32)
        tpos = pos.to(torch.int32)[:, None] + steps[None, :]     # (b, s)
        positions = tpos.clamp(0, cos.shape[0] - 1).long()
        c = cos[positions].to(q.dtype)                           # (b, s, d)
        sn = sin[positions].to(q.dtype)
        q, k = _rope_rows(q, c, sn), _rope_rows(k, c, sn)
        cache = (k_cache, v_cache) + tuple(kv_scales or ())
        write_paged_kv(cache, k, v, tpos, block_table)
        lengths = pos.to(torch.int32) + s
        decode = s == 1 and window is None
        if kv_scales is not None:                      # int8 arenas
            k_scales, v_scales = kv_scales
            if decode:
                out = paged_attention_decode_int8(
                    q[:, 0].contiguous(), k_cache, v_cache, k_scales,
                    v_scales, block_table, lengths, scale=scale)
                return out[:, None].to(q.dtype)
            k_read = dequantize_kv(paged_gather(k_cache, block_table),
                                   paged_gather(k_scales, block_table))
            v_read = dequantize_kv(paged_gather(v_cache, block_table),
                                   paged_gather(v_scales, block_table))
        else:
            if decode:
                out = paged_attention_decode(
                    q[:, 0].contiguous(), k_cache, v_cache, block_table,
                    lengths, scale=scale)
                return out[:, None].to(q.dtype)
            k_read = paged_gather(k_cache, block_table)
            v_read = paged_gather(v_cache, block_table)
        return dense_attention(q, k_read, v_read, lengths, scale=scale,
                               window=window)
    if _per_row(pos) and pad is None:
        pad = torch.zeros(b, dtype=torch.int32, device=dev)
    if cos is not None:
        q, k = _rotate(q, k, cos, sin, pos, pad)
    _write_dense((k_cache, v_cache), k, v, pos)
    if _per_row(pos):
        lengths = pos.to(torch.int32) + s
    elif isinstance(pos, torch.Tensor):
        lengths = (pos.to(torch.int32) + s).reshape(1).expand(b)
    else:
        lengths = torch.full((b,), int(pos) + s, dtype=torch.int32,
                             device=dev)
    return dense_attention(q, k_cache, v_cache, lengths, scale=scale,
                           window=window, pad=pad)


@torch.inference_mode()
def decode_step(model, ids, cache, pos, *, block_table=None, pad=None,
                last_index=None, key=None, sample_kwargs=None,
                fused_decode=None, all_positions=False) -> torch.Tensor:
    """The shared step of ``build_decode_step``: forward the (b, s)
    token block at ``pos`` (see :func:`cached_attention`) through the
    cache (updated in place) and take the last column's logits (or the
    column at ``last_index``, the last real token of a right-padded
    chunk: an int, or a (b,) integer tensor on the device, taken by a
    gather so that a CUDA graph can capture it) in fp32. With
    ``sample_kwargs`` (temperature, top_k, top_p) returns the (b,)
    int32 tokens drawn with ``key`` (:func:`sample_logits`); without,
    the (b, V) log-softmax (the beam and serving head), or with
    ``all_positions`` the (b, s, V) log-softmax of every column (the
    speculative verify head). With ``fused_decode``
    (``ops.decode_layer.FusedDecode``) each decode layer goes through
    the fused decode-layer call; its counts are those of this step."""
    if all_positions and sample_kwargs is not None:
        raise ValueError("all_positions=True returns raw log-probs; "
                         "pass sample_kwargs=None")
    if fused_decode is not None:
        fused_decode.begin()
    logits = model(ids, cache=cache, pos=pos, pad=pad,
                   block_table=block_table, fused_decode=fused_decode)
    if all_positions:
        return torch.log_softmax(logits.float(), dim=-1)
    if last_index is None:
        lv = logits[:, -1]
    else:
        b, _, v = logits.shape
        idx = torch.as_tensor(last_index, device=logits.device).long()
        lv = logits.gather(1, idx.view(-1, 1, 1).expand(b, 1, v))[:, 0]
    lv = lv.float()
    if sample_kwargs is None:
        return torch.log_softmax(lv, dim=-1)
    return sample_logits(lv, key, **sample_kwargs).to(torch.int32)


def decode_step_logprobs(model, ids, cache, pos, block_table=None,
                         last_index=None, fused_decode=None,
                         pad=None, all_positions=False) -> torch.Tensor:
    """:func:`decode_step`'s log-prob head, the serving engines' step:
    the fp32 (b, V) log-softmax at the last column (or ``last_index``),
    or (b, s, V) at every column with ``all_positions``."""
    return decode_step(model, ids, cache, pos, block_table=block_table,
                       pad=pad, last_index=last_index,
                       fused_decode=fused_decode,
                       all_positions=all_positions)


class _GenerateStep:
    """``generate()``'s s = 1 decode step over static tensors (the JAX
    ``_decode_fn``): the cache, the input token (b, 1), the position (a
    0-dim int32 on the device), the key (2,), the left-pad counts (b,)
    of a ragged batch, and the step's output token (b,). One call
    splits the key (``key, sub = split(key)``), runs the step with
    ``sub``, writes the token and advances the position by one.

    On the card it is one CUDA graph (``graphs.CapturedProgram``),
    captured when the step is built and replayed per token, and the
    fused RoPE kernel reads the position on the device; on the CPU the
    same function runs eagerly. The graph, its memory pool and the cache
    belong to this object, which the model keeps in
    ``model._decode_fn_cache`` until a call with another key replaces it
    or ``GenerationMixin.release_decode_programs()`` drops it. Its tensors
    are inference tensors (``generate()`` runs under
    ``torch.inference_mode``); every method updates them in that mode."""

    def __init__(self, model, batch: int, total: int, dtype,
                 sample_kwargs: dict, ragged: bool):
        from ..graphs import CapturedProgram
        dev = model.device
        self.model = model
        self.sample_kwargs = dict(sample_kwargs)
        self.cache = model.init_kv_cache(batch, total, dtype)
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.key = torch.zeros(2, dtype=torch.int64, device=dev)
        self.pad = torch.zeros(batch, dtype=torch.int32, device=dev) \
            if ragged else None
        self.out = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.program = CapturedProgram(self._run, dev)
        self.program.capture()

    @torch.inference_mode()
    def _run(self):
        key, sub = prng.split(self.key)
        nt = decode_step(self.model, self.tok, self.cache, self.pos,
                         pad=self.pad, key=sub,
                         sample_kwargs=self.sample_kwargs)
        self.key.copy_(key)
        self.out.copy_(nt)
        self.tok.copy_(nt[:, None])
        self.pos.add_(1)

    @torch.inference_mode()
    def start(self, pad):
        """Zero the cache (``init_kv_cache`` of a fresh call) and set
        the pad counts."""
        for layer in self.cache:
            for t in layer:
                t.zero_()
        if self.pad is not None:
            self.pad.copy_(pad)

    @torch.inference_mode()
    def arm(self, tok, pos: int, key):
        """The state after the prefill: its tokens, the next position
        and the loop's key."""
        self.tok.copy_(tok.view(-1, 1))
        self.pos.fill_(pos)
        self.key.copy_(key)

    def __call__(self) -> torch.Tensor:
        self.program()
        return self.out


class GenerationMixin:
    """Adds ``generate()`` to a causal LM whose forward takes
    ``forward(ids, cache=, pos=, pad=)`` -> logits (updating the cache
    in place) and which implements ``init_kv_cache(batch, max_len,
    dtype)``."""

    def _decode_step_program(self, batch, total, dtype, sample_kwargs,
                             ragged) -> _GenerateStep:
        """The captured decode step for (batch, cache length, cache
        dtype, padding, sampling configuration), cached on the model as
        JAX caches its jits (``__dict__["_decode_fn_cache"]``). Unlike a
        jit, a step owns its cache (8.6 GB for Llama-2-7B fp32 at batch
        4 and 2048 positions), so the model keeps one step: a call with
        another key frees the last one before it builds its own, and
        generate() holds one call's cache at a time, as in JAX, where
        each call allocates its own."""
        cache = self.__dict__.setdefault("_decode_fn_cache", {})
        key = (batch, total, str(dtype), bool(ragged),
               tuple(sorted(sample_kwargs.items())))
        if key not in cache:
            cache.clear()
            cache[key] = _GenerateStep(self, batch, total, dtype,
                                       sample_kwargs, ragged)
        return cache[key]

    def release_decode_programs(self):
        """Drop the cached decode step: its CUDA graph, the graph's
        memory pool and its cache go with it."""
        self.__dict__.pop("_decode_fn_cache", None)

    def _beam_search(self, ids, max_new, total, num_beams, eos_token_id,
                     length_penalty, pad=None):
        """Beam search over the cached step's log-prob head (the JAX
        ``_beam_search``): prefill once at batch b, replicate the cache
        K times, then per token pick the K best (beam, token) pairs of
        each row and reorder the histories and the cache rows by their
        source beam. Runs eagerly: the reordering is a host decision per
        token in JAX too."""
        b, s = ids.shape
        K = num_beams
        cache = self.init_kv_cache(b, total)
        lp = decode_step(self, ids, cache, 0, pad=pad)
        cache = [tuple(torch.repeat_interleave(t, K, dim=0) for t in layer)
                 for layer in cache]
        pad_rep = None if pad is None \
            else torch.repeat_interleave(pad, K, dim=0)
        V = lp.shape[-1]
        beam_scores, first = torch.topk(lp, K, dim=-1)           # (b, K)
        sequences = first.reshape(b, K, 1)
        finished = torch.zeros((b, K), dtype=torch.bool, device=ids.device)
        if eos_token_id is not None:
            finished = first == eos_token_id
            eos_only = torch.full((V,), -1e9, device=ids.device)
            eos_only[eos_token_id] = 0.0
        beam_lens = torch.ones((b, K), dtype=torch.float32,
                               device=ids.device)
        tok = first.reshape(b * K)
        rows = torch.arange(b, device=ids.device)[:, None] * K
        for i in range(1, max_new):
            lp = decode_step(self, tok[:, None].to(torch.int32), cache,
                             s + i - 1, pad=pad_rep).reshape(b, K, V)
            if eos_token_id is not None:
                lp = torch.where(finished[..., None], eos_only, lp)
            cand = (beam_scores[..., None] + lp).reshape(b, K * V)
            beam_scores, idx = torch.topk(cand, K, dim=-1)
            src_beam = torch.div(idx, V, rounding_mode="floor")
            new_tok = idx % V
            gather = (rows + src_beam).reshape(-1)
            sequences = torch.cat(
                [torch.gather(sequences, 1, src_beam[..., None].expand(
                    -1, -1, sequences.shape[2])), new_tok[..., None]], dim=2)
            cache = [tuple(t[gather] for t in layer) for layer in cache]
            finished = torch.gather(finished, 1, src_beam)
            beam_lens = torch.gather(beam_lens, 1, src_beam)
            beam_lens = torch.where(finished, beam_lens, float(i + 1))
            if eos_token_id is not None:
                finished = finished | (new_tok == eos_token_id)
            tok = new_tok.reshape(b * K)
            if eos_token_id is not None and bool(finished.all()):
                break
        norm = torch.pow(beam_lens, length_penalty) if length_penalty \
            else 1.0
        best = torch.argmax(beam_scores / norm, dim=1)             # (b,)
        best_seq = torch.gather(sequences, 1, best[:, None, None].expand(
            -1, 1, sequences.shape[2]))[:, 0]
        return torch.cat([ids, best_seq.to(torch.int32)], dim=1)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 20,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, do_sample: bool = False,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 max_length: Optional[int] = None, num_beams: int = 1,
                 length_penalty: float = 0.0, attention_mask=None,
                 use_scan_decode: Optional[bool] = None,
                 eos_check_every: int = 8) -> torch.Tensor:
        """Greedy (``do_sample=False``), sampled (``do_sample=True``; a
        temperature <= 0 then means 1) or beam (``num_beams > 1``)
        decoding over a preallocated KV cache, as the JAX ``generate()``
        (same checks, same errors, same key schedule:
        ``key, sub = split(PRNGKey(seed))`` before the prefill and again
        before each step).

        ``input_ids`` (b, s): a tensor, numpy array or nested list.
        ``attention_mask`` (b, s) of 0/1: LEFT-padded ragged prompts.
        ``eos_token_id``: finished rows are padded with eos; whether
        every row finished is read on the host only every
        ``eos_check_every`` steps, and an early exit pads the remaining
        columns. ``use_scan_decode`` (default: on without an eos id):
        the decode tail runs with no host read at all (the JAX scan
        program); it cannot stop early, so it refuses an eos id.

        The prefill (one (b, s) call) runs eagerly; each decode step is
        one replay of the captured step (:class:`_GenerateStep`) on the
        card. Returns the (b, s + new) int32 tensor of prompt and
        generated ids on the model's device."""
        dev = self.device
        ids = torch.as_tensor(np.asarray(input_ids) if not isinstance(
            input_ids, torch.Tensor) else input_ids).to(
                device=dev, dtype=torch.int32)
        if ids.dim() != 2:
            raise ValueError(f"input_ids must be (batch, length), got "
                             f"shape {tuple(ids.shape)}")
        b, s = ids.shape
        pad = None
        if attention_mask is not None:
            am = attention_mask.cpu().numpy() if isinstance(
                attention_mask, torch.Tensor) else np.asarray(attention_mask)
            if am.shape != (b, s):
                raise ValueError(f"attention_mask shape {am.shape} != "
                                 f"prompt shape {(b, s)}")
            if not (np.sort(am, axis=1) == am).all():
                raise ValueError(
                    "attention_mask must be LEFT-padded (all zeros "
                    "before ones in every row)")
            pad_np = (s - am.sum(axis=1)).astype(np.int32)
            if not (pad_np < s).all():
                raise ValueError("attention_mask has an all-pad row")
            pad = torch.from_numpy(pad_np).to(dev)
        total = max_length or (s + max_new_tokens)
        max_new = total - s
        if max_new <= 0:
            return ids
        if do_sample and (temperature is None or temperature <= 0.0):
            temperature = 1.0   # PaddleNLP parity: do_sample defaults hot
        limit = getattr(getattr(self, "config", None),
                        "max_position_embeddings", None)
        if limit is not None and total > limit:
            raise OutOfRangeError(
                f"prompt ({s}) + new tokens ({max_new}) = {total} exceeds "
                f"max_position_embeddings={limit}",
                "positions past the RoPE/position table would silently "
                "clamp; raise max_position_embeddings or shorten the "
                "request")
        if use_scan_decode and eos_token_id is not None:
            raise ValueError("use_scan_decode=True cannot early-exit on "
                             "eos_token_id; drop one of the two")
        if num_beams > 1:
            if do_sample:
                raise ValueError("num_beams>1 with do_sample=True is not "
                                 "supported (beam sampling); use one or "
                                 "the other")
            if use_scan_decode:
                raise ValueError("use_scan_decode=True with num_beams>1 "
                                 "is not supported (beam reordering is "
                                 "a per-token host decision)")
            return self._beam_search(ids, max_new, total, num_beams,
                                     eos_token_id, length_penalty, pad=pad)
        if not do_sample:
            temperature = 0.0
        sample_kwargs = dict(temperature=temperature, top_k=top_k,
                             top_p=top_p)
        step = self._decode_step_program(b, total, self.head_weight.dtype,
                                         sample_kwargs, pad is not None)
        step.start(pad)
        key, sub = prng.split(prng.prng_key(seed)).to(dev)
        # prefill: the same step function with the (b, s) block at 0
        tok = decode_step(self, ids, step.cache, 0, pad=pad, key=sub,
                          sample_kwargs=sample_kwargs)
        if use_scan_decode is None:
            use_scan_decode = eos_token_id is None
        out_tokens = [tok]
        step.arm(tok, s, key)
        if use_scan_decode:
            # the scan program's tail: every step, no host read
            for _ in range(1, max_new):
                out_tokens.append(step().clone())
            return torch.cat([ids, torch.stack(out_tokens, dim=1)], dim=1)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
        for i in range(1, max_new):
            tok = step()
            if eos_token_id is not None:
                tok = torch.where(finished, eos_token_id, tok)
                finished = finished | (tok == eos_token_id)
                step.tok.copy_(tok[:, None])      # eos feeds the next step
            out_tokens.append(tok.clone())
            # a host read: only every eos_check_every steps
            if eos_token_id is not None and \
                    i % max(1, eos_check_every) == 0 and \
                    bool(finished.all()):
                break
        gen = torch.stack(out_tokens, dim=1)
        if gen.shape[1] < max_new:
            gen = torch.cat([gen, torch.full(
                (b, max_new - gen.shape[1]), eos_token_id,
                dtype=gen.dtype, device=dev)], dim=1)
        return torch.cat([ids, gen], dim=1)
