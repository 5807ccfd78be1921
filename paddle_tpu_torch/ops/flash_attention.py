"""Flash attention: the hand-written CUDA kernels
``csrc/flash_attention.cu`` (forward, dq, dkv) and their plain PyTorch
versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:
``_xla_sdpa`` (:func:`sdpa_reference`), the three Pallas kernels behind
``flash_block`` and ``flash_attention_fused``, and ``sdpa``. Layout is
bshd: q ``(b, sq, h, d)``, k/v ``(b, sk, hk, d)`` with ``h % hk == 0``
(GQA reads kv head ``i // (h // hk)``); lse and the backward's delta are
``(b, h, sq)`` fp32. ``window`` bands the scores to the last ``window``
keys and implies causal, as in the JAX package.

On the TPU the JAX ``sdpa`` sends equal heads to jax's library flash
kernel and GQA or a window to splash; the repo's own kernel is its third
choice. Here the hand-written kernel serves every unmasked, dropout-free
call: there is no library route. bf16 runs the Hopper kernels (wgmma
products fed by a TMA ring, accumulators in registers; head dims up to
64 run as 64, the others as 128 with TMA's zero fill), fp32 the scalar
ones."""
from __future__ import annotations

import ctypes
import math

import torch

from . import build, plain_active

__all__ = ["sdpa_reference", "flash_attention_reference",
           "flash_attention_bwd_reference", "bf16_rounding_spread",
           "bf16_tolerance", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_block", "flash_attention_fused", "sdpa"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _band(sq, sk, is_causal, window, device):
    """The ``_xla_sdpa`` mask: causal aligned at the bottom right
    (``tril(k=sk-sq)``), a window keeping keys (p - window, p]. None
    when nothing is masked."""
    if not is_causal and window is None:
        return None
    ones = torch.ones(sq, sk, dtype=torch.bool, device=device)
    keep = torch.tril(ones, diagonal=sk - sq)
    if window is not None:
        keep = keep & torch.triu(ones, diagonal=sk - sq - int(window) + 1)
    return keep


def _repeat_kv(q, k, v):
    rep = q.shape[2] // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2),
            v.repeat_interleave(rep, dim=2))


def _scores(q, k):
    """(b, h, sq, sk) fp32 q·kᵀ of bf16/fp32 inputs (fp32 products, as
    ``preferred_element_type=float32``)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())


def sdpa_reference(q, k, v, mask=None, is_causal=False, dropout_p=0.0,
                   scale=None, window=None):
    """``_xla_sdpa``: materialized fp32 scores, the causal/window band,
    an optional bool or additive mask, fp32 softmax, probabilities cast
    to q's dtype (then dropout from torch's generator) before the PV
    product."""
    sq, d = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k, v = _repeat_kv(q, k, v)
    scores = _scores(q, k) * scale
    band = _band(sq, sk, is_causal, window, q.device)
    if band is not None:
        scores = scores.masked_fill(~band, float("-inf"))
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, device=probs.device) >= dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention_reference(q, k, v, is_causal=False, scale=None,
                              window=None):
    """The plain version of the forward kernel: :func:`sdpa_reference`
    without mask or dropout, plus the (b, h, sq) fp32 logsumexp of the
    scaled, banded scores. Differentiable by torch's autograd."""
    d = q.shape[3]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if window is not None:
        is_causal = True
    kr, vr = _repeat_kv(q, k, v)
    scores = _scores(q, kr) * scale
    band = _band(q.shape[1], k.shape[1], is_causal, window, q.device)
    if band is not None:
        scores = scores.masked_fill(~band, float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vr), lse


def flash_attention_bwd_reference(q, k, v, do, lse, delta, *, is_causal,
                                  scale, window=None):
    """The plain version of both backward kernels, from the saved lse and
    delta = rowsum(do·o) - dlse: p = exp((q·kᵀ)·scale - lse), ds =
    p·(do·vᵀ - delta)·scale; dq = ds·k, dk = dsᵀ·q and dv = pᵀ·do summed
    over each kv head's group, in fp32, cast to q's dtype."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    if window is not None:
        is_causal = True
    kr, vr = _repeat_kv(q, k, v)
    s = _scores(q, kr) * scale
    band = _band(sq, sk, is_causal, window, q.device)
    if band is not None:
        s = s.masked_fill(~band, float("-inf"))
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = dk.reshape(b, sk, hk, rep, d).sum(3)
    dv = dv.reshape(b, sk, hk, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def bf16_rounding_spread(q, k, v, do, lse, delta, *, is_causal, scale,
                         window=None):
    """The scale of the bf16 kernels' rounding error, per element of o,
    dq, dk and dv (fp32, in their shapes): sqrt(Σ t²) over the terms t
    of the product whose operand the kernels round to bf16 (p in
    o = p·v and dv = pᵀ·do; ds in dq = ds·k and dk = dsᵀ·q; summed over
    a kv head's group). Rounding an operand moves its term by at most
    2^-8 of itself, so the output moves by a sum of bounded errors with
    a standard deviation of 2^-8 / sqrt(3) times this spread when they
    are independent and uniform."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    if window is not None:
        is_causal = True
    kr, vr = _repeat_kv(q, k, v)
    s = _scores(q, kr) * scale
    band = _band(sq, sk, is_causal, window, q.device)
    if band is not None:
        s = s.masked_fill(~band, float("-inf"))
    p = torch.exp(s - lse[..., None])
    del s
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds2 = (p * (dp - delta[..., None]) * scale).square()
    del dp
    p2 = p.square()
    del p

    def sq_(t):
        return t.float().square()

    o = torch.einsum("bhqk,bkhd->bqhd", p2, sq_(vr))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds2, sq_(kr))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds2, sq_(q))
    dv = torch.einsum("bhqk,bqhd->bkhd", p2, sq_(do))
    dk = dk.reshape(b, sk, hk, rep, d).sum(3)
    dv = dv.reshape(b, sk, hk, rep, d).sum(3)
    return tuple(t.sqrt() for t in (o, dq, dk, dv))


def bf16_tolerance(got, want, spread, roundings):
    """Per-element bound on |got - want| for two bf16 results of the same
    sum where ``roundings`` of the two sides (1 or 2) rounded the
    operands behind ``spread`` (:func:`bf16_rounding_spread`) to bf16:
    half a bf16 ulp of each output (2^-8 of its size, 1% slack for the
    value before rounding), 7 standard deviations of the operands'
    rounding, and 2e-5 for fp32 sums in another order."""
    ulp = 2.0 ** -8 * 1.01 * (got.float().abs() + want.float().abs())
    sd = 2.0 ** -8 * math.sqrt(roundings / 3.0) * spread
    return ulp + 7.0 * sd + 2e-5


def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        nptr = {"pt_flash_fwd": 5, "pt_flash_bwd_dq": 7,
                "pt_flash_bwd_dkv": 8}[name]
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * nptr \
            + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(name, q, k, v, *rest):
    if q.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32/bfloat16, got "
                        f"{q.dtype}")
    b, sq, h, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{name}: h={h} is not a multiple of "
                         f"kv heads={k.shape[2]}")
    if d % 16 or d > 128:
        raise ValueError(f"{name} kernel needs head_dim % 16 == 0 and "
                         f"<= 128, got {d}")
    if b * h > 65535:
        raise ValueError(f"{name} kernel: b*h={b * h} exceeds the grid")
    for t in (q, k, v) + rest:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             "aligned tensors")
    for t in (k, v) + tuple(r for r in rest if r.dim() == 4):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {q.dtype}/{t.dtype}")


def _args(q, k, is_causal, scale, window):
    b, sq, h, d = q.shape
    return [b, h, k.shape[2], sq, k.shape[1], d, float(scale),
            int(bool(is_causal or window is not None)),
            int(window or 0)]


def _launch(name, wrapper, q, *ptrs_and_args):
    rc = _kernel(name)(_DTYPE_CODE[q.dtype], *ptrs_and_args,
                       torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    wrapper.launches += 1


def flash_attention_fwd(q, k, v, *, is_causal=False, scale, window=None):
    """Forward: ``(o, lse)``. A CPU tensor takes the plain version; a
    CUDA tensor launches the forward kernel (``flash_fwd_sm90`` in bf16,
    ``flash_fwd_kernel`` in fp32) or raises."""
    if q.device.type == "cpu" or plain_active():
        return flash_attention_reference(q, k, v, is_causal, scale, window)
    _check("flash_attention_fwd", q, k, v)
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    _launch("pt_flash_fwd", flash_attention_fwd, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            *_args(q, k, is_causal, scale, window))
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, is_causal=False,
                           scale, window=None):
    """dq from the saved lse and delta. A CPU tensor takes the plain
    version; a CUDA tensor launches the dq kernel (``flash_dq_sm90`` in
    bf16, ``flash_bwd_dq_kernel`` in fp32) or raises."""
    if q.device.type == "cpu" or plain_active():
        return flash_attention_bwd_reference(
            q, k, v, do, lse, delta, is_causal=is_causal, scale=scale,
            window=window)[0]
    _check("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("pt_flash_bwd_dq", flash_attention_bwd_dq, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            *_args(q, k, is_causal, scale, window))
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, is_causal=False,
                            scale, window=None):
    """(dk, dv), summed over each kv head's group of q heads. A CPU
    tensor takes the plain version; a CUDA tensor launches the dkv
    kernel (``flash_dkv_sm90`` in bf16, ``flash_bwd_dkv_kernel`` in
    fp32) or raises."""
    if q.device.type == "cpu" or plain_active():
        return flash_attention_bwd_reference(
            q, k, v, do, lse, delta, is_causal=is_causal, scale=scale,
            window=window)[1:]
    _check("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("pt_flash_bwd_dkv", flash_attention_bwd_dkv, q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_args(q, k, is_causal, scale, window))
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _FlashBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, is_causal, scale, window):
        o, lse = flash_attention_fwd(q, k, v, is_causal=is_causal,
                                     scale=scale, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = dict(is_causal=is_causal, scale=scale, window=window)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        # delta' = rowsum(do·o) - dlse: the lse cotangent enters both
        # backward kernels through the delta slot (the product in the
        # working dtype, the sum in fp32, as the JAX wrapper)
        delta = (do * o).float().sum(-1).transpose(1, 2)
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.cfg)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         **ctx.cfg)
        return dq, dk, dv, None, None, None


def flash_block(q, k, v, is_causal=False, scale=None, window=None):
    """``(o, lse)`` with cotangents for both: o (b, sq, h, d) in q's
    dtype, lse (b, h, sq) fp32. The forward and both backward passes run
    the kernels on CUDA tensors (the plain versions on CPU tensors).
    Causal attention needs sq == sk: the TPU kernels align causality at
    the top left and ``_xla_sdpa`` at the bottom right, which agree only
    there, so other shapes raise instead of choosing one."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if window is not None:
        if int(window) <= 0:
            raise ValueError(f"window={window}: must be positive")
        is_causal = True
    if is_causal and sq != sk:
        raise ValueError(f"causal flash attention needs sq == sk, got "
                         f"sq={sq} sk={sk}")
    if h % hk:
        raise ValueError(f"h={h} is not a multiple of kv heads={hk}")
    return _FlashBlock.apply(q, k, v, bool(is_causal), float(scale),
                             None if window is None else int(window))


def flash_attention_fused(q, k, v, is_causal=False, scale=None,
                          window=None):
    """:func:`flash_block` with the logsumexp discarded."""
    return flash_block(q, k, v, is_causal, scale, window)[0]


def sdpa(q, k, v, mask=None, is_causal=False, dropout_p=0.0, scale=None,
         window=None):
    """Scaled dot-product attention, bshd layout. Without a mask and
    without dropout it runs the flash kernels; otherwise the plain
    ``_xla_sdpa`` sequence, which is the JAX ``sdpa``'s own route for
    those calls on every backend."""
    if mask is None and dropout_p == 0.0:
        return flash_attention_fused(q, k, v, is_causal, scale, window)
    return sdpa_reference(q, k, v, mask, is_causal, dropout_p, scale,
                          window)
