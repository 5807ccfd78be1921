"""KV-cache attention over the paged arena and the log-prob decode step.

Counterpart of ``paddle_tpu/models/generation.py``: ``cached_attention``
limited to its paged branch with per-row RoPE, and the log-prob head of
``build_decode_step`` (``sample_kwargs=None``, with ``last_index`` for
right-padded prefill chunks). The JAX step is a pure function that
returns a new cache; here the arena is updated in place (no copy of a
multi-GB arena per step), and everything else is the same sequence."""
from __future__ import annotations

import torch

from ..ops.paged_attention import (dense_attention, dequantize_kv,
                                   paged_attention_decode,
                                   paged_attention_decode_int8,
                                   paged_gather, write_paged_kv)

__all__ = ["cached_attention", "decode_step_logprobs"]


def _rope_rows(x, c, sn):
    """Neox rotate-half with per-row (b, s, d) cos/sin."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    rot = torch.cat([-x2, x1], dim=-1)
    return x * c[:, :, None, :] + rot * sn[:, :, None, :]


def cached_attention(q, k, v, k_arena, v_arena, pos, *, scale, cos, sin,
                     block_table, kv_scales=None):
    """One paged-KV attention step, shared by prefill chunks (s > 1)
    and decode (s = 1).

    q (b, s, h, d), k/v (b, s, kvh, d); ``pos`` (b,) int32 per-row
    write offsets; arenas (num_blocks, block_size, kvh, d); block_table
    (b, max_blocks) int32. RoPE rotates q and k at each row's positions;
    k/v are written into the arena at ``block_table[r, t // bs]``,
    offset ``t % bs`` — positions past the table width go to the trash
    block 0 — and the read runs the paged-attention decode kernel for
    s = 1 or the gathered-dense sequence for a chunk. Returns the
    (b, s, h, d) attention output; the arenas are updated in place.

    With ``kv_scales=(k_scales, v_scales)`` the arenas hold int8 codes
    and the scales (num_blocks, block_size, kvh) fp32 absmaxes: k/v are
    quantized per (position, kv head) vector and codes and scales are
    written at the same (block, offset); s = 1 reads through the int8
    decode kernel (dequant inside the read), a chunk dequantizes the
    gathered table and runs the dense sequence (the JAX package's
    ``generation.py:145-166``)."""
    b, s, h, d = q.shape
    dev = q.device
    steps = torch.arange(s, device=dev, dtype=torch.int32)
    tpos = pos.to(torch.int32)[:, None] + steps[None, :]         # (b, s)
    positions = tpos.clamp(0, cos.shape[0] - 1).long()
    c = cos[positions].to(q.dtype)                               # (b, s, d)
    sn = sin[positions].to(q.dtype)
    q, k = _rope_rows(q, c, sn), _rope_rows(k, c, sn)

    cache = (k_arena, v_arena) + tuple(kv_scales or ())
    write_paged_kv(cache, k, v, tpos, block_table)
    lengths = pos.to(torch.int32) + s
    if kv_scales is not None:                          # int8 arenas
        k_scales, v_scales = kv_scales
        if s == 1:
            out = paged_attention_decode_int8(
                q[:, 0].contiguous(), k_arena, v_arena, k_scales, v_scales,
                block_table, lengths, scale=scale)
            return out[:, None].to(q.dtype)
        kd = dequantize_kv(paged_gather(k_arena, block_table),
                           paged_gather(k_scales, block_table))
        vd = dequantize_kv(paged_gather(v_arena, block_table),
                           paged_gather(v_scales, block_table))
        return dense_attention(q, kd, vd, lengths, scale=scale)
    if s == 1:
        out = paged_attention_decode(q[:, 0].contiguous(), k_arena, v_arena,
                                     block_table, lengths, scale=scale)
        return out[:, None].to(q.dtype)
    return dense_attention(q, paged_gather(k_arena, block_table),
                           paged_gather(v_arena, block_table), lengths,
                           scale=scale)


@torch.inference_mode()
def decode_step_logprobs(model, ids, cache, pos, block_table,
                         last_index=None,
                         fused_decode=None) -> torch.Tensor:
    """The decode step's log-prob head: forward the (b, s) token block
    at per-row positions ``pos`` through the paged cache and return the
    fp32 log-softmax of the logits at the last column (or at
    ``last_index``, the last real token of a right-padded chunk: an int,
    or a (b,) integer tensor on the device, taken by a gather; a device
    index keeps host values out of the step, so a CUDA graph can capture
    it). With
    ``fused_decode`` (``ops.decode_layer.FusedDecode``) each decode
    layer goes through the fused decode-layer call; its counts are
    those of this step."""
    if fused_decode is not None:
        fused_decode.begin()
    logits = model(ids, cache=cache, pos=pos, block_table=block_table,
                   fused_decode=fused_decode)
    if last_index is None:
        lv = logits[:, -1]
    else:
        b, _, v = logits.shape
        idx = torch.as_tensor(last_index, device=logits.device).long()
        lv = logits.gather(1, idx.view(-1, 1, 1).expand(b, 1, v))[:, 0]
    return torch.log_softmax(lv.float(), dim=-1)
