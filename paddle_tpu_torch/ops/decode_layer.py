"""The fused decode layer: one launch of the hand-written CUDA megakernel
``csrc/decode_layer.cu`` per Llama decode layer per decode step, and its
plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/decode_layer.py``, modes
``paged`` and ``paged_int8``. The JAX kernel never takes the dense
mode, so the dense engine's fused request counts its layers and runs
the unfused layer (``models/llama.py``), as JAX does. The JAX package
reaches its kernel through a jaxpr pass that splices a marked region of the
decode-block trace; in torch the model calls :func:`decode_layer`
directly when its forward is given a :class:`FusedDecode` request
(``models/llama.py``), so there is no marking and no pass.

The argument layout is JAX's (:data:`ARG_LAYOUT`, :func:`split_args`):
``(mode, x, cos, sin, eps1, eps2, pos, table, *cache, *weights)`` with
x (S, 1, d), cos/sin the (positions, head_dim) RoPE tables, pos (S,)
int32 write positions, table (S, max_blocks) int32, the cache as the
arena's (k, v) or int8 (k codes, v codes, k scales, v scales), and the
weights in :data:`WEIGHT_NAMES` order."""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, plain_active
from .fused import _rot, rms_norm_reference
from .paged_attention import (_int8_decode_plain, paged_attention_reference,
                              split_plan, write_paged_kv)

__all__ = ["ARG_LAYOUT", "WEIGHT_NAMES", "N_WEIGHTS", "N_CACHE", "MAX_SLOTS",
           "split_args", "decode_layer_reference", "kernel_viable", "decode_layer", "decode_layer_int8",
           "DecodeLayerScratch", "FusedDecode", "PHASES", "phase_us",
           "BAND_ROWS", "product_plan", "layer_plan"]

ARG_LAYOUT = ("x", "cos", "sin", "eps1", "eps2", "pos", "aux",
              "*cache", "*weights")
WEIGHT_NAMES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")
N_WEIGHTS = len(WEIGHT_NAMES)
N_CACHE = {"dense": 2, "paged": 2, "paged_int8": 4}
N_FIXED = 7          # x, cos, sin, eps1, eps2, pos, aux
# slots the kernel takes: four tensor-core tiles of 8 slots
MAX_SLOTS = 32
# weight rows of one split-K work item of the megakernel (64 of the gate
# and 64 of the up product for the paired one)
BAND_ROWS = 128
# an item's fixed cost (staging, partial sums, ticket) in K columns, for
# the plan's cost model
_ITEM_COST = 64
# attention units of the megakernel's split table walk per CTA: each CTA
# runs two at a time
WALK_UNITS_PER_CTA = 2
_grids = {}
# the (S, d) products read weight rows in 16-byte vectors, the attention
# phase one head row in at most 32 lanes of 16 bytes
_VEC_ELEMS = {"paged": 4, "paged_int8": 16}
_fns = {}


def split_args(mode: str, args):
    """(fixed, cache, weights) views over the flat argument list."""
    nc = N_CACHE[mode]
    return args[:N_FIXED], args[N_FIXED:N_FIXED + nc], args[N_FIXED + nc:]


def _rope_tables(cos, sin, pos, dtype):
    """(S, dh) cos/sin at each row's position (indices clamped to the
    table, as a JAX gather clamps them)."""
    p = pos.long().clamp(0, cos.shape[0] - 1)
    return cos[p].to(dtype), sin[p].to(dtype)


def decode_layer_reference(mode, x, cos, sin, eps1, eps2, pos, table,
                           *rest):
    """One Llama decode layer in plain PyTorch, the plain version of the
    megakernel: ``decode_layer_reference`` of the JAX package for modes
    ``paged`` and ``paged_int8`` (RMSNorm as ``_rms_ref``, per-row RoPE,
    the ``cached_attention`` write and read, the SwiGLU MLP). Weights in
    JAX's (in, out) orientation. The arena is updated in place, as
    ``models/generation.py`` ``cached_attention`` updates it; returns
    ``(out,) + cache`` with out (S, 1, d) and the same cache tensors."""
    if mode not in ("paged", "paged_int8"):
        raise NotImplementedError(
            f"decode_layer mode {mode!r}: the port has the paged modes")
    _, cache, wts = split_args(mode, (None,) * N_FIXED + tuple(rest))
    ln1, wq, wk, wv, wo, ln2, wg, wu, wd = wts
    S, s, d = x.shape
    dh = cos.shape[1]
    h = wq.shape[1] // dh
    kvh = wk.shape[1] // dh
    scale = 1.0 / math.sqrt(dh)
    pos = pos.to(torch.int32)
    r1 = rms_norm_reference(x, ln1, eps1)
    q = (r1 @ wq).reshape(S, s, h, dh)
    k = (r1 @ wk).reshape(S, s, kvh, dh)
    v = (r1 @ wv).reshape(S, s, kvh, dh)
    c, sn = _rope_tables(cos, sin, pos, x.dtype)       # (S, dh)
    q = q * c[:, None, None] + _rot(q) * sn[:, None, None]
    k = k * c[:, None, None] + _rot(k) * sn[:, None, None]
    write_paged_kv(cache, k, v, pos[:, None], table)
    lengths = pos + 1
    if mode == "paged_int8":
        out = _int8_decode_plain(q[:, 0].contiguous(), *cache, table,
                                 lengths, scale=scale)[:, None]
    else:
        out = paged_attention_reference(q, *cache, table, lengths,
                                        scale=scale)
    o = out.reshape(S, s, h * dh).to(x.dtype) @ wo
    h1 = x + o
    r2 = rms_norm_reference(h1, ln2, eps2)
    act = torch.nn.functional.silu(r2 @ wg) * (r2 @ wu)
    return (h1 + act @ wd,) + tuple(cache)


def _refusal(mode, x, cache, wts, window):
    """Why the card's kernel cannot take this call, or None. Weights in
    the wrapper's (out, in) orientation."""
    if mode not in ("paged", "paged_int8"):
        return f"mode {mode!r} (the kernel takes the paged modes)"
    if window is not None:
        return "a sliding window"
    if len(cache) != N_CACHE[mode] or len(wts) != N_WEIGHTS:
        return f"{len(cache)} cache and {len(wts)} weight tensors"
    if x.dtype != torch.float32 or any(w.dtype != torch.float32
                                       for w in wts):
        return "a hidden state or weight that is not float32"
    if x.dim() != 3 or x.shape[1] != 1:
        return f"x of shape {tuple(x.shape)} (the kernel takes (S, 1, d))"
    S, _, d = x.shape
    if not 1 <= S <= MAX_SLOTS:
        return f"{S} slots (the kernel takes 1 to {MAX_SLOTS})"
    arena_dtype = torch.int8 if mode == "paged_int8" else torch.float32
    if cache[0].dtype != arena_dtype or cache[1].dtype != arena_dtype \
            or any(c.dtype != torch.float32 for c in cache[2:]):
        return f"a {cache[0].dtype} arena for mode {mode!r}"
    _, bs, kvh, dh = cache[0].shape
    if dh % 2:
        return f"head_dim {dh} is odd (rotate-half RoPE)"
    ln1, wq, wk, wv, wo, ln2, wg, wu, wd = wts
    hd, ff = wq.shape[0], wg.shape[0]
    if hd % dh or (hd // dh) % kvh:
        return f"{hd // dh} query heads for {kvh} kv heads of {dh}"
    want = {"ln1": (d,), "wq": (hd, d), "wk": (kvh * dh, d),
            "wv": (kvh * dh, d), "wo": (d, hd), "ln2": (d,),
            "wg": (ff, d), "wu": (ff, d), "wd": (d, ff)}
    for name, w in zip(WEIGHT_NAMES, wts):
        if tuple(w.shape) != want[name]:
            return f"{name} of shape {tuple(w.shape)}, not {want[name]}"
    if d % 4 or hd % 4 or ff % 4:
        return f"widths d={d}, h*dh={hd}, ff={ff} not multiples of 4"
    lanes = dh // _VEC_ELEMS[mode]
    if dh % _VEC_ELEMS[mode] or lanes > 32 or lanes & (lanes - 1):
        return (f"head_dim {dh}: a head row must be a power of two of at "
                f"most 32 vectors of {_VEC_ELEMS[mode]}")
    return None


def kernel_viable(mode, x, cache, weights, window=None) -> bool:
    """Whether the card's megakernel takes this decode layer: the paged
    modes, no sliding window, an fp32 hidden state (S, 1, d) with
    1 <= S <= 32 and fp32 weights in the wrapper's (out, in) orientation,
    an even head_dim, whole GQA groups, widths that are multiples of 4
    (16-byte weight loads), and a head row of a power of two of at most
    32 sixteen-byte vectors (fp32: head_dim 4..128; int8: 16..512).

    The JAX gate's ``_VMEM_BUDGET`` (10 MB, ``decode_layer.py:225``) has
    no counterpart: it bounds the TPU kernel's resident set, one slot's
    whole weight set in VMEM, and not the function. The CUDA kernel
    streams the weights from device memory, so no width is too large."""
    return _refusal(mode, x, cache, tuple(weights), window) is None


def product_plan(n_out: int, k: int, grid: int, pair: bool = False):
    """(bands, ks, kslice): the split-K plan of one megakernel product of
    ``n_out`` output rows over ``k`` input columns on ``grid`` CTAs.
    Items are bands of :data:`BAND_ROWS` rows (``pair``: half as many
    output columns, gate and up rows together) times ``ks`` K-slices of
    ``kslice`` columns, a multiple of 32 (the last slice may be
    shorter). The plan fills the card, at least ``grid`` items where
    there are enough columns, and among those takes the ``ks`` (1-64)
    whose items end soonest: whole waves times (``kslice`` + an item's
    fixed cost); the fewest slices on a tie."""
    bands = -(-n_out // (BAND_ROWS // 2 if pair else BAND_ROWS))
    best = None
    for split in range(1, 65):
        kslice = -(-(-(-k // split)) // 32) * 32     # ceil(k / split), 32s
        ks = -(-k // kslice)
        items = bands * ks
        cost = (items < grid, -(-items // grid) * (kslice + _ITEM_COST)
                if items >= grid else -items)
        if best is None or cost < best[0]:
            best = (cost, (bands, ks, kslice))
    return best[1]


def layer_plan(S, d, h, dh, ff, mb, grid):
    """The host plan of one megakernel launch on ``grid`` CTAs, the
    kernel's 14 plan ints: (bands, ks, kslice) of the q, o, gate/up and
    down products, then the attention walk's (ce, nc), chunks enough to
    bring the S * h items up to the two units each CTA runs at once
    (handed out by a counter, so short and long units balance)."""
    hd = h * dh
    plan = [*product_plan(hd, d, grid), *product_plan(d, hd, grid),
            *product_plan(ff, d, grid, pair=True), *product_plan(d, ff, grid)]
    return plan + list(split_plan(S * h, mb, WALK_UNITS_PER_CTA * grid))


def _scratch_sizes(S, d, h, dh, ff, plan):
    """Float counts of the scratch regions q, attn, h1, act, sq and the
    partial sums (each a multiple of 4 floats, so every region starts
    16-byte aligned), and the tickets' int count (the attention unit
    counter, then one per band or attention item)."""
    hd = h * dh
    prods = [plan[i:i + 3] for i in range(0, 12, 3)]
    items = S * h
    part = max([b * ks * S * BAND_ROWS for b, ks, _ in prods]
               + [items * plan[13] * (dh + 2)])
    sizes = [S * hd, S * hd, S * d, S * ff, prods[1][0] * S, part]
    return [-(-n // 4) * 4 for n in sizes], 1 + max(
        [b for b, _, _ in prods] + [items])


class DecodeLayerScratch:
    """The megakernel's device scratch: q, attention, h1, the MLP
    activation and the products' partial sums of S rows (a few MB at 7B
    width) in one fp32 buffer, and the per-band tickets of its split-K
    reductions and table-walk merges (zeroed once: the kernel leaves them
    zero). Both are kept across calls and grown when a call needs more,
    but never during a CUDA graph capture: a buffer made there would
    live in the graph's memory pool, so the caller runs the call once
    before capturing it (``graphs``), and a capture that would
    grow one raises."""

    def __init__(self):
        self._buf = None
        self._tickets = None

    @staticmethod
    def _refuse_in_capture(what):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"decode_layer: the megakernel's {what} would be made "
                "during a CUDA graph capture; run the call once before "
                "capturing it")

    def get(self, numel: int, device) -> torch.Tensor:
        buf = self._buf
        if buf is None or buf.numel() < numel or buf.device != device:
            self._refuse_in_capture("scratch")
            buf = self._buf = torch.empty(numel, dtype=torch.float32,
                                          device=device)
        return buf

    def tickets(self, n: int, device) -> torch.Tensor:
        t = self._tickets
        if t is None or t.numel() < n or t.device != device:
            self._refuse_in_capture("tickets")
            t = self._tickets = torch.zeros(n, dtype=torch.int32,
                                            device=device)
        return t


class FusedDecode:
    """A request to run each decode layer of a forward through the fused
    decode-layer call, handed down the model's forward as one keyword.
    Holds the megakernel's scratch and the counts of the last forward:
    ``rewrites``, the layers routed through the fused call, and
    ``kernel_calls``, those of them that launched the kernel (a layer
    the kernel cannot take, or any layer on the CPU, runs the unfused
    math, as the JAX engine runs its captured jaxpr)."""

    def __init__(self):
        self.scratch = DecodeLayerScratch()
        self.rewrites = 0
        self.kernel_calls = 0

    def begin(self):
        self.rewrites = self.kernel_calls = 0


def _kernel(mode):
    name = "pt_decode_layer_int8" if mode == "paged_int8" \
        else "pt_decode_layer"
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("decode_layer"), name)
        # x, r1, cos, sin; the cache; table, lengths; the six weights the
        # kernel reads (ln1, wk and wv are the prologue's)
        n_ptr = 4 + N_CACHE[mode] + 2 + 6
        fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_float] * 2 \
            + [ctypes.c_void_p] * n_ptr \
            + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)] \
            + [ctypes.c_void_p] * 3 \
            + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _grid(mode, S, dh, device) -> int:
    """The CTAs of one cooperative launch (occupancy x SMs), which the
    host plan is made for; cached per device and shape."""
    key = (device.index, mode, S, dh)
    if key not in _grids:
        fn = _fns.get("pt_decode_layer_grid")
        if fn is None:
            fn = build.load("decode_layer").pt_decode_layer_grid
            fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
            _fns["pt_decode_layer_grid"] = fn
        grid = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(S, dh, int(mode == "paged_int8"), ctypes.byref(grid))
        if rc != 0:
            raise RuntimeError(f"decode_layer kernel: no grid for {S} slots "
                               f"(CUDA error {rc})")
        _grids[key] = grid.value
    return _grids[key]


def _launch(mode, x, cos, sin, eps1, eps2, pos, table, cache, wts,
            scratch, stamps):
    """The prologue in torch, then one cooperative launch of
    ``csrc/decode_layer.cu``. Prologue (JAX's ``:382-409``): RMSNorm #1
    in fp32 (its output r1 is also the q product's input), the k and v
    products (``torch.matmul``, outside the kernel as in JAX), RoPE on k
    at each row's position, trash-block routing of out-of-range
    positions, the arena write (``quantize_kv`` for int8). The host plan
    (:func:`layer_plan`) depends on the shapes alone: nothing is read
    back from the device."""
    reason = _refusal(mode, x, cache, wts, None)
    if reason is not None:
        raise ValueError(f"decode_layer kernel refuses {reason}")
    named = dict(x=x, cos=cos, sin=sin, pos=pos, table=table,
                 **{f"cache{i}": c for i, c in enumerate(cache)},
                 **dict(zip(WEIGHT_NAMES, wts)))
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"decode_layer: {name} is on {t.device}, x on "
                             f"{x.device}")
    for name, t in dict(named, cos=None, sin=None, pos=None).items():
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"decode_layer kernel needs a contiguous, "
                             f"16-byte aligned {name}")
    if pos.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("pos and table must be int32")
    ln1, wq, wk, wv, wo, ln2, wg, wu, wd = wts
    S, _, d = x.shape
    _, bs, kvh, dh = cache[0].shape
    mb = table.shape[1]
    hd, ff = wq.shape[0], wg.shape[0]
    if tuple(table.shape) != (S, mb) or tuple(pos.shape) != (S,):
        raise ValueError(f"table {tuple(table.shape)} / pos "
                         f"{tuple(pos.shape)} do not fit {S} slots")
    x2 = x.reshape(S, d)
    var = torch.mean(x2 * x2, dim=-1, keepdim=True)
    r1 = x2 * torch.rsqrt(var + eps1) * ln1
    k = (r1 @ wk.t()).view(S, kvh, dh)
    v = (r1 @ wv.t()).view(S, kvh, dh)
    c, sn = _rope_tables(cos, sin, pos, torch.float32)
    k = k * c[:, None] + _rot(k) * sn[:, None]
    write_paged_kv(cache, k[:, None], v[:, None], pos[:, None], table)
    lengths = pos + 1
    h = hd // dh
    plan = layer_plan(S, d, h, dh, ff, mb, _grid(mode, S, dh, x.device))
    sizes, n_tickets = _scratch_sizes(S, d, h, dh, ff, plan)
    buf = scratch.get(sum(sizes), x.device)
    regions = [buf.data_ptr() + 4 * sum(sizes[:i]) for i in range(6)]
    out = torch.empty_like(x)
    grid = ctypes.c_int(0)
    rc = _kernel(mode)(
        S, d, h, kvh, dh, ff, bs, mb, float(eps2), 1.0 / math.sqrt(dh),
        x2.data_ptr(), r1.data_ptr(), c.data_ptr(), sn.data_ptr(),
        *[t.data_ptr() for t in cache], table.data_ptr(),
        lengths.data_ptr(),
        *[w.data_ptr() for w in (wq, wo, ln2, wg, wu, wd)],
        (ctypes.c_int * 14)(*plan), (ctypes.c_void_p * 6)(*regions),
        scratch.tickets(n_tickets, x.device).data_ptr(), out.data_ptr(),
        None if stamps is None else stamps.data_ptr(), ctypes.byref(grid),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_layer kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def decode_layer(mode, x, cos, sin, eps1, eps2, pos, table, *rest,
                 scratch=None, stamps=None):
    """One Llama decode layer for S slots at s = 1: mode ``paged`` (fp32
    arena) or ``paged_int8``, arguments in :data:`ARG_LAYOUT` order with
    the weights as ``nn.Linear`` stores them, (out, in) — taken without a
    copy (the plain version gets transposed views). Updates the arena in
    place and returns ``(out,) + cache``, out (S, 1, d).

    A CPU tensor (or a call inside ``ops.plain_versions()``) takes the
    plain version :func:`decode_layer_reference`. A CUDA tensor runs the
    torch prologue and launches ``csrc/decode_layer.cu`` once, or
    raises: a shape the kernel does not take (:func:`kernel_viable`) is
    a ValueError, a failed launch a RuntimeError. ``scratch`` is a
    :class:`DecodeLayerScratch` to reuse (a fresh one otherwise).
    ``stamps``, for measurement only, is an int64 CUDA tensor of 6 that
    the kernel fills with ``%globaltimer`` nanoseconds: at entry, after
    each of phases A-D's grid barriers and after a barrier at the end
    (:func:`phase_us` turns them into each phase's microseconds); the
    serving path passes none."""
    _, cache, wts = split_args(mode, (None,) * N_FIXED + tuple(rest))
    if x.device.type == "cpu" or plain_active():
        lin = (1, 2, 3, 4, 6, 7, 8)
        wts_in_out = tuple(w.t() if i in lin else w
                           for i, w in enumerate(wts))
        return decode_layer_reference(mode, x, cos, sin, eps1, eps2, pos,
                                      table, *cache, *wts_in_out)
    if x.device.type != "cuda":
        raise RuntimeError(f"decode_layer: no kernel for device {x.device}")
    if stamps is not None and (stamps.device != x.device
                               or stamps.dtype != torch.int64
                               or stamps.numel() != 6):
        raise ValueError("decode_layer: stamps must be an int64 tensor of "
                         "6 on x's device")
    out = _launch(mode, x, cos, sin, eps1, eps2, pos, table, cache, wts,
                  scratch or DecodeLayerScratch(), stamps)
    if mode == "paged_int8":
        decode_layer_int8.launches += 1
    else:
        decode_layer.launches += 1
    return (out,) + tuple(cache)


def decode_layer_int8(x, cos, sin, eps1, eps2, pos, table, *rest,
                      scratch=None, stamps=None):
    """:func:`decode_layer` over the int8 arena (mode ``paged_int8``);
    its launches count here."""
    return decode_layer("paged_int8", x, cos, sin, eps1, eps2, pos, table,
                        *rest, scratch=scratch, stamps=stamps)


PHASES = ("A q", "B attention", "C o", "D gate/up", "E down")


def phase_us(stamps) -> dict:
    """{phase: microseconds} from a launch's 6 ``stamps``."""
    t = [int(v) for v in stamps.tolist()]
    return {name: (t[i + 1] - t[i]) / 1e3 for i, name in enumerate(PHASES)}


decode_layer.launches = 0
decode_layer_int8.launches = 0
