"""Paged-attention decode over a block-paged KV arena: the hand-written
CUDA kernel ``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``: the
fp32/bf16 arenas and the int8 arena with its wire format (int8 codes
per (position, kv head) vector against the vector's fp32 absmax, the
EQuARX recipe of ``paddle_tpu/distributed/collectives/quantized.py``).
Layouts match the JAX package: arenas
``(num_blocks, block_size, kv_heads, head_dim)``, int8 scales
``(num_blocks, block_size, kv_heads)``, q ``(b, h, d)`` for decode and
``(b, s, h, d)`` otherwise, block tables ``(b, max_blocks)`` int32,
lengths ``(b,)`` int32. Block 0 is the trash block that dead slots
point at."""
from __future__ import annotations

import ctypes

import torch

from . import build, plain_active

__all__ = ["paged_gather", "write_paged_kv", "paged_attention_reference",
           "paged_attention_decode", "dense_attention", "quantize_kv",
           "dequantize_kv", "kv_int8_error_bound",
           "paged_attention_int8_reference", "paged_attention_decode_int8",
           "split_plan", "walk_plan", "heads_per_item"]

NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_QMAX = 127.0
# fl32(1/127): XLA compiles _dequantize's ``s / 127`` as ``s * (1/127)``
# with the fp32 reciprocal; the port and its kernel do the same
_INV127 = float(torch.tensor(1.0) / 127)
_fn = None
_fn_int8 = None
# the split table walk: at least KV_WARPS table entries a chunk (one per
# warp of a work unit)
KV_WARPS = 4
# per device: the zeroed per-item tickets of the split walk's merge (the
# merging unit leaves its ticket zero, so the buffer stays zero between
# launches; launches on one device share it, in stream order). A CUDA
# graph captured on a buffer holds it (ticket_buffers), so a larger call
# may replace it here.
_tickets = {}
# per (device, q dtype, arena, g, d): the CTAs of the kernel instance
# that fit on the card at once
_slots = {}


# ---------------------------------------------------------------------------
# int8 KV wire format
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor):
    """(..., d) -> ((..., d) int8 codes, (...,) fp32 absmax scales): one
    bucket per (position, kv head) vector. ``_quantize`` of
    ``quantized.py:48-61`` as XLA compiles it: the scale is the raw
    absmax, the code ``clip(round(x / denom * 127), -127, 127)`` with a
    true division by the row's denominator (absmax, or 1 for a zero
    row) and round-half-to-even — bit-identical to the JAX package on
    the CPU."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1)
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xf / denom[..., None] * _QMAX).clamp_(-_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, fp32 out: ``_dequantize`` of
    ``quantized.py:64-72`` as XLA compiles it — the +-127 codes give
    +-absmax bit-exactly (constant vectors round-trip), any other code
    ``q * (s * fl(1/127))``."""
    qf = codes.float()
    s = scales[..., None]
    return torch.where(qf.abs() == _QMAX, torch.sign(qf) * s,
                       qf * (s * _INV127))


def kv_int8_error_bound(absmax):
    """Worst-case elementwise |dequant - x| of the int8 KV arena: one
    quantization, half a step, ``absmax / 127 / 2`` in fp32 (the JAX
    ``kv_int8_error_bound``: ``int8_error_bound`` with one contributor
    and no second phase)."""
    return torch.as_tensor(absmax, dtype=torch.float32) / _QMAX / 2


def write_paged_kv(cache, k, v, tpos, block_table):
    """Write k/v (b, s, kvh, d) at the (b, s) int32 timeline positions
    ``tpos`` into the arena, in place: row r's position t goes to block
    ``block_table[r, t // bs]`` at offset ``t % bs``; positions past the
    table width (chunk pad columns, dead slots) go to the trash block 0
    at offset 0, never out of bounds or into another slot's blocks.
    ``cache`` is (k, v) arenas, written in their dtype, or int8 (k
    codes, v codes, k scales, v scales), written with
    :func:`quantize_kv`'s codes and absmax scales."""
    bs, mb = cache[0].shape[1], block_table.shape[1]
    blk_idx = torch.div(tpos, bs, rounding_mode="floor")
    oob = blk_idx >= mb
    blk = torch.where(oob, 0, torch.gather(block_table, 1,
                                           blk_idx.clamp(0, mb - 1).long()))
    off = torch.where(oob, 0, tpos % bs)
    blk, off = blk.long(), off.long()
    if len(cache) == 4:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache[0][blk, off] = kq
        cache[1][blk, off] = vq
        cache[2][blk, off] = ks
        cache[3][blk, off] = vs
    else:
        cache[0][blk, off] = k.to(cache[0].dtype)
        cache[1][blk, off] = v.to(cache[1].dtype)


def paged_gather(arena: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """(nb, bs, kvh, d) arena + (b, max_blocks) table -> the slot-dense
    (b, max_blocks*bs, kvh, d) view ordered by timeline position."""
    b, mb = block_table.shape
    g = arena[block_table.long()]                # (b, mb, bs, kvh, d)
    return g.reshape(b, mb * g.shape[2], *g.shape[3:])


def dense_attention(q, kd, vd, lengths, *, scale, window=None, pad=None):
    """The dense einsum/mask/softmax sequence of the JAX package
    (``cached_attention``'s read, ``generation.py:204-228``) over
    (b, T, kvh, d) k/v, a dense cache or a gathered table: fp32 scores,
    the -1e30 mask, fp32 softmax, probabilities cast to v's dtype.
    ``q`` is (b, s, h, d) and row i of it sits at position
    lengths - s + i (``lengths`` (b,)). The mask is causal; with
    ``window`` a key at t is seen only from positions < t + window (the
    sliding window); with ``pad`` (b,) a row's keys below its pad count
    are never seen (left-padded prompts)."""
    b, s, h, d = q.shape
    kvh = kd.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, kd.float()) * scale
    t_idx = torch.arange(kd.shape[1], device=q.device)
    q_idx = (lengths.long() - s)[:, None] \
        + torch.arange(s, device=q.device)[None, :]            # (b, s)
    mask = t_idx[None, None, :] <= q_idx[:, :, None]           # (b, s, T)
    if window is not None:
        mask = mask & (t_idx[None, None, :] > q_idx[:, :, None]
                       - int(window))
    if pad is not None:
        mask = mask & (t_idx[None, None, :] >= pad.long()[:, None, None])
    scores = scores.masked_fill(~mask[:, None, None], NEG)
    probs = torch.softmax(scores, dim=-1).to(vd.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vd)
    return out.reshape(b, s, h, d).to(q.dtype)


def paged_attention_reference(q, k_arena, v_arena, block_table, lengths,
                              *, scale):
    """Gathered-dense oracle: gather the whole table, then
    :func:`dense_attention`. ``q`` is (b, s, h, d)."""
    return dense_attention(q, paged_gather(k_arena, block_table),
                           paged_gather(v_arena, block_table), lengths,
                           scale=scale)


def paged_attention_int8_reference(q, k_codes, v_codes, k_scales,
                                   v_scales, block_table, lengths, *,
                                   scale):
    """Dequant-then-dense oracle of the int8 arena: gather the whole
    table, dequantize it, then :func:`dense_attention`. ``q`` is
    (b, s, h, d)."""
    kd = dequantize_kv(paged_gather(k_codes, block_table),
                       paged_gather(k_scales, block_table))
    vd = dequantize_kv(paged_gather(v_codes, block_table),
                       paged_gather(v_scales, block_table))
    return dense_attention(q, kd, vd, lengths, scale=scale)


def _int8_decode_plain(q, k_codes, v_codes, k_scales, v_scales,
                       block_table, lengths, *, scale):
    """The plain version of the int8 decode kernel, the JAX package's
    ``_int8_decode_fallback``: a loop over the table entries that
    gathers and dequantizes ONE (b, bs, kvh, d) block at a time into the
    online softmax (entries past a slot's length are masked, -1e30), so
    no fp32 copy of the whole table ever exists."""
    b, h, d = q.shape
    _, bs, kvh, _ = k_codes.shape
    mb = block_table.shape[1]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d).float()
    tbl, lens = block_table.long(), lengths.long()
    pos = torch.arange(bs, device=q.device)
    m = torch.full((b, kvh, g, 1), NEG, device=q.device)
    den = torch.zeros((b, kvh, g, 1), device=q.device)
    acc = torch.zeros((b, kvh, g, d), device=q.device)
    for j in range(mb):
        blk = tbl[:, j]
        k = dequantize_kv(k_codes[blk], k_scales[blk])     # (b, bs, kvh, d)
        v = dequantize_kv(v_codes[blk], v_scales[blk])
        s = torch.einsum("bkgd,btkd->bkgt", qg, k) * scale
        valid = (j * bs + pos)[None, :] < lens[:, None]       # (b, bs)
        s = s.masked_fill(~valid[:, None, None, :], NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkgt,btkd->bkgd", p, v)
        m = m_new
    return (acc / den).reshape(b, h, d).to(q.dtype)


def split_plan(items: int, mb: int, target: int):
    """(ce, nc): the split of every work item's table walk into ``nc``
    chunks of ``ce`` entries of a table ``mb`` entries wide, as many
    chunks as bring ``items`` items up to ``target`` work units, at most
    one per :data:`KV_WARPS` entries. A function of the shapes alone:
    nothing reads the lengths, so the launch needs no host sync. Chunk
    c covers entries ``[c * ce, min((c + 1) * ce, mb))``; a chunk at or
    past a row's ``ceil(length / block_size)`` entries exits at once."""
    n = -(-target // items) if items > 0 else 1
    n = max(1, min(n, -(-mb // KV_WARPS)))
    ce = max(1, -(-mb // n))
    return ce, max(1, -(-mb // ce))


def heads_per_item(g: int) -> int:
    """Query heads of one GQA group that one work item computes: the
    kernel's instances take 1, 2 or 4."""
    return g if g in (1, 2) else 4


def _resident_ctas(q, int8, g, d):
    """CTAs of the kernel instance for this call that fit on the card at
    once (occupancy x SMs), cached."""
    dev = q.device
    key = (dev.index, q.dtype, int8, g, d)
    if key not in _slots:
        fn = build.load("paged_attention").pt_paged_attention_occupancy
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = fn(_DTYPE_CODE[q.dtype], int(int8), g, d,
                    ctypes.byref(per_sm))
        if rc != 0:
            raise RuntimeError(f"paged decode kernel: occupancy query "
                               f"failed: CUDA error {rc}")
        _slots[key] = per_sm.value * torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _slots[key]


def walk_plan(items: int, mb: int, slots: int):
    """(ce, nc) of a standalone launch of ``items`` work items on a card
    that holds ``slots`` of its CTAs at once: one chunk when the items
    already fill half of the slots (a split would only queue units
    behind each other), else :func:`split_plan` up to the slots."""
    if 2 * items >= slots:
        return max(mb, 1), 1
    return split_plan(items, mb, slots)


def _split_args(q, int8, b, h, kvh, d, mb):
    """(ce, nc, part, tickets) of a standalone launch (:func:`walk_plan`);
    with more than one chunk, the partial states ``(items, nc, heads,
    d + 2)`` fp32, fresh per call (stream-ordered), and the device's
    zeroed tickets, one per item (else None, None)."""
    g = h // kvh
    heads = heads_per_item(g)
    items = b * kvh * -(-g // heads)
    ce, nc = walk_plan(items, mb, _resident_ctas(q, int8, g, d))
    if nc == 1:
        return ce, nc, None, None
    part = torch.empty(items * nc * heads * (d + 2), dtype=torch.float32,
                       device=q.device)
    key = (q.device.type, q.device.index)
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < items:
        tickets = torch.zeros(max(items, 4096), dtype=torch.int32,
                              device=q.device)
        # a buffer made during a CUDA graph capture lives in the graph's
        # pool: the graph zeroes it on each replay, and it is not kept
        if not torch.cuda.is_current_stream_capturing():
            _tickets[key] = tickets
    return ce, nc, part, tickets


def ticket_buffers() -> tuple:
    """The shared ticket buffers as they stand: a captured graph keeps
    them alive for as long as it may launch on them."""
    return tuple(_tickets.values())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel():
    global _fn
    if _fn is None:
        fn = build.load("paged_attention").pt_paged_attention_decode
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(name, q, k, v, block_table, lengths, scales=()):
    """What the kernel needs, or raise: q (b, h, d) fp32/bf16; (nb, bs,
    kvh, d) arenas in q's dtype, or int8 codes with fp32 ``scales`` (k,
    v) of (nb, bs, kvh); int32 table (b, mb) and lengths (b,); all
    contiguous on q's device. One lane loads 16 bytes of a (position,
    kv head) row, so a row must be a power of two of at most 32 lanes,
    and the arenas 16-byte aligned."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32/bfloat16 q, got "
                        f"{q.dtype}")
    arena_dtype = torch.int8 if scales else q.dtype
    if k.dtype != arena_dtype or v.dtype != arena_dtype:
        raise TypeError(f"{name} kernel needs {arena_dtype} arenas for "
                        f"{q.dtype} q, got {k.dtype}/{v.dtype}")
    if any(sc.dtype != torch.float32 for sc in scales):
        raise TypeError(f"{name} kernel needs float32 scales, got "
                        f"{[sc.dtype for sc in scales]}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    named = dict(zip(("k_scales", "v_scales"), scales), q=q, k=k, v=v,
                 block_table=block_table, lengths=lengths)
    for tname, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{tname} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {tname}")
    b, h, d = q.shape
    nb, bs, kvh, d2 = k.shape
    if tuple(v.shape) != tuple(k.shape) or d2 != d:
        raise ValueError(f"arenas {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if any(tuple(sc.shape) != (nb, bs, kvh) for sc in scales):
        raise ValueError(f"scales {[tuple(sc.shape) for sc in scales]} do "
                         f"not fit the code arenas {tuple(k.shape)}")
    if h % kvh:
        raise ValueError(f"h={h} is not a multiple of kv_heads={kvh}")
    if block_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"block_table {tuple(block_table.shape)} / "
                         f"lengths {tuple(lengths.shape)} do not fit b={b}")
    vec = 16 // k.element_size()
    lanes = d // vec
    if d % vec or lanes > 32 or lanes & (lanes - 1) \
            or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name} kernel needs head_dim = {vec} x a power "
                         f"of two up to 32 and 16-byte aligned arenas, got "
                         f"head_dim {d}")


def paged_attention_decode(q, k_arena, v_arena, block_table, lengths, *,
                           scale):
    """One decode step (s = 1): q (b, h, d) against the arena through
    the block table; lengths (b,) = valid positions per slot, the
    just-written current token included. A CPU tensor takes the plain
    version (the gathered-dense reference); a CUDA tensor launches
    ``csrc/paged_attention.cu`` once or raises. When the work items fill
    less than half of the card (:func:`walk_plan`), the launch splits
    each item's table walk into chunks and merges them in chunk order
    in the same launch."""
    if q.device.type == "cpu" or plain_active():
        return paged_attention_reference(q[:, None], k_arena, v_arena,
                                         block_table, lengths,
                                         scale=scale)[:, 0]
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention_decode: no kernel for device "
                           f"{q.device}")
    _check("paged_attention_decode", q, k_arena, v_arena,
           block_table, lengths)
    b, h, d = q.shape
    _, bs, kvh, _ = k_arena.shape
    mb = block_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    ce, nc, part, tickets = _split_args(q, False, b, h, kvh, d, mb)
    rc = _kernel()(_DTYPE_CODE[q.dtype], q.data_ptr(), k_arena.data_ptr(),
                   v_arena.data_ptr(), block_table.data_ptr(),
                   lengths.data_ptr(), out.data_ptr(), b, h, kvh, d, bs,
                   mb, float(scale), ce, nc, _ptr(part), _ptr(tickets),
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention_decode kernel launch failed: CUDA error {rc}")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def _kernel_int8():
    global _fn_int8
    if _fn_int8 is None:
        fn = build.load("paged_attention").pt_paged_attention_decode_int8
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        _fn_int8 = fn
    return _fn_int8


def paged_attention_decode_int8(q, k_codes, v_codes, k_scales, v_scales,
                                block_table, lengths, *, scale):
    """One decode step (s = 1) against the int8 arena, the dequant
    INSIDE the read: q (b, h, d) fp32/bf16, codes (nb, bs, kvh, d) int8,
    scales (nb, bs, kvh) fp32, lengths (b,) = valid positions per slot.
    A CPU tensor takes the plain version (the per-block loop of
    ``_int8_decode_fallback``); a CUDA tensor launches the int8 entry of
    ``csrc/paged_attention.cu`` once or raises, the walk split as in
    :func:`paged_attention_decode`. Output in q's dtype."""
    if q.device.type == "cpu" or plain_active():
        return _int8_decode_plain(q, k_codes, v_codes, k_scales, v_scales,
                                  block_table, lengths, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_attention_decode_int8: no kernel for "
                           f"device {q.device}")
    _check("paged_attention_decode_int8", q, k_codes, v_codes,
           block_table, lengths, scales=(k_scales, v_scales))
    b, h, d = q.shape
    _, bs, kvh, _ = k_codes.shape
    mb = block_table.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    ce, nc, part, tickets = _split_args(q, True, b, h, kvh, d, mb)
    rc = _kernel_int8()(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_codes.data_ptr(),
        v_codes.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h,
        kvh, d, bs, mb, float(scale), ce, nc, _ptr(part), _ptr(tickets),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode_int8 kernel launch "
                           f"failed: CUDA error {rc}")
    paged_attention_decode_int8.launches += 1
    return out


paged_attention_decode_int8.launches = 0
