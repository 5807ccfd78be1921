"""Fused transformer ops: the hand-written CUDA kernels
``csrc/rms_norm.cu``, ``csrc/rope.cu`` and ``csrc/adamw.cu`` and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused.py``: ``fused_rms_norm``
without ``residual`` (the TPU ``_rms_kernel``; :func:`rms_norm`) and
with it (``_rms_res_kernel``; :func:`rms_norm_residual`), the gradient
of both (``_rms_bwd``, the VJP of ``_rms_ref``; :func:`rms_norm_bwd`),
``fused_rope`` (``_rope_kernel``) and ``fused_adamw``
(``_adamw_kernel``)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, plain_active

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_bwd",
           "rms_norm_backward_reference", "rms_norm_plan",
           "rms_norm_residual",
           "rms_norm_residual_reference", "fused_rms_norm", "fused_rope",
           "rope_reference", "fused_adamw", "adamw_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}


def _kernel(lib, name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} kernel takes float32/bfloat16, got "
                            f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             "aligned tensors")


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """The JAX package's ``_rms_ref`` order: mean of squares in fp32,
    normalize, cast to x's dtype, then multiply by the weight."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rms_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                                grad: torch.Tensor, eps: float):
    """The gradient of :func:`rms_norm_reference` (the JAX ``_rms_bwd``,
    the VJP of ``_rms_ref``) written out, with the rounding sites of
    torch's and XLA's VJP and the fp32 operations of torch's autograd in
    its order. With xf = float(x), r = rsqrt(mean(xf²) + eps), n =
    cast(xf·r) to x's dtype: dn = float(cast(grad·w)) to x's dtype;
    a = (−0.5·Σ_row(dn·xf))·r³/h·xf (rsqrt's, the mean's and the
    square's backward); dx = cast((dn·r + a) + a), fp32 with one
    rounding, i.e. r·dn − xf·(r³/h)·Σ_row(dn·xf); dw = the products
    grad·n in the product's dtype, summed over every row in fp32 and
    rounded once to w's dtype. Returns ``(dx, dw)``."""
    h = x.shape[-1]
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    n = (xf * r).to(x.dtype)
    dn = (grad * weight).to(x.dtype).float()
    dot = (dn * xf).sum(dim=-1, keepdim=True)
    a = -0.5 * dot * r ** 3 / h * xf
    dx = (dn * r + a + a).to(x.dtype)
    dw = (grad * n).reshape(-1, h).sum(0, dtype=torch.float32)
    return dx, dw.to(weight.dtype)


def _check_rms(name, x, weight, *more):
    """What the RMSNorm kernels need, or raise: CUDA fp32/bf16 tensors,
    a (h,) weight in x's dtype, h a multiple of the 16-byte vector
    width, every other tensor x's shape and dtype. Returns h."""
    _check_cuda(name, x, weight, *more)
    h = x.shape[-1]
    if weight.dtype != x.dtype or tuple(weight.shape) != (h,):
        raise ValueError(
            f"{name}: weight must be ({h},) {x.dtype}, got "
            f"{tuple(weight.shape)} {weight.dtype}")
    for t in more:
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: tensors must be {tuple(x.shape)} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    vec = 16 // x.element_size()
    if h % vec:
        raise ValueError(f"{name} kernel needs h % {vec} == 0 (h={h})")
    return h


# A thread holds 1, 2 or 4 16-byte vectors of a row (the register
# instances of the kernels); 0 is the looping instance.
_VPT = (1, 2, 4)
_THREADS = 256
_sms = {}
_bwd_plans = {}


def rms_norm_plan(nvec: int):
    """(vectors a thread, threads a CTA) of the RMSNorm kernels, forward
    and backward, over rows of ``nvec`` 16-byte vectors: up to 256
    threads (the first forward kernel's CTA, whose vector-to-thread map
    and so whose sums the forward keeps bit for bit), each holding the
    fewest vectors of 1, 2 or 4 that cover the row in registers; past
    1024 vectors (fp32 h > 4096, bf16 h > 8192) ``(0, 256)``, the looping
    instance, which reads each row twice (the second time from L1/L2)."""
    threads = min(_THREADS, -(-nvec // 32) * 32)
    for vpt in _VPT:
        if vpt * threads >= nvec:
            return vpt, threads
    return 0, _THREADS


def _sm_count(dev):
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev.index]


def _forward_launch(x, residual, weight, eps):
    """One launch of the forward kernel: ``out``, or ``(out, x +
    residual)`` when ``residual`` is given."""
    name = "rms_norm" if residual is None else "rms_norm_residual"
    more = () if residual is None else (residual,)
    h = _check_rms(name, x, weight, *more)
    out = torch.empty_like(x)
    total = None if residual is None else torch.empty_like(x)
    rows = x.numel() // h
    if rows:
        vpt, threads = rms_norm_plan(h * x.element_size() // 16)
        tail = [rows, h, float(eps), vpt, threads, _stream(x)]
        if residual is None:
            fn = _kernel("rms_norm", "pt_rms_norm",
                         [ctypes.c_int] + [ctypes.c_void_p] * 3
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
                    out.data_ptr(), *tail)
        else:
            fn = _kernel("rms_norm", "pt_rms_norm_residual",
                         [ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), residual.data_ptr(),
                    weight.data_ptr(), out.data_ptr(), total.data_ptr(),
                    *tail)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{rc}")
        (rms_norm if residual is None else rms_norm_residual).launches += 1
    return out if residual is None else (out, total)


def _rms_norm_forward(x, weight, eps):
    """The forward alone: the plain version for a CPU tensor, else the
    ``csrc/rms_norm.cu`` launch (or a raise)."""
    if x.device.type == "cpu" or plain_active():
        return rms_norm_reference(x, weight, eps)
    return _forward_launch(x, None, weight, eps)


def _bwd_plan(x, dw):
    """(vectors a thread, threads, CTAs) of the backward for x's rows:
    :func:`rms_norm_plan`, and a grid of as many CTAs as fit on the card
    at once, at most two an SM (the fastest at (8192, 4096) bf16 on the
    H100, ``PERF.md`` §6; it also bounds the dw scratch at 2 * SMs * h
    fp32). Cached."""
    h = x.shape[-1]
    key = (x.device.index, x.dtype, h, dw)
    if key not in _bwd_plans:
        vpt, threads = rms_norm_plan(h * x.element_size() // 16)
        fn = _kernel("rms_norm", "pt_rms_norm_bwd_occupancy",
                     [ctypes.c_int] * 4)
        with torch.cuda.device(x.device):
            per_sm = fn(_DTYPE_CODE[x.dtype], vpt, threads, int(dw))
        if per_sm <= 0:
            raise RuntimeError(f"rms_norm_bwd kernel: no CTA of {threads} "
                               f"threads fits an SM (occupancy query: "
                               f"{per_sm})")
        _bwd_plans[key] = (vpt, threads,
                           min(2, per_sm) * _sm_count(x.device))
    return _bwd_plans[key]


def _bwd_launch(x, weight, grad, gs, eps, need_x, need_w, plan):
    """One backward launch (two with dw) at ``plan`` = (vectors a thread,
    threads, CTAs): ``(dx, dw)``, each None when not needed."""
    vpt, threads, ctas = plan
    h = x.shape[-1]
    rows = x.numel() // h
    dx = torch.empty_like(x) if need_x else None
    dw = torch.empty_like(weight) if need_w else None
    ctas = min(rows, ctas)
    part = torch.empty(ctas, h, dtype=torch.float32, device=x.device) \
        if need_w else None
    fn = _kernel("rms_norm", "pt_rms_norm_bwd",
                 [ctypes.c_int] + [ctypes.c_void_p] * 7
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
            grad.data_ptr(), *(None if t is None else t.data_ptr()
                               for t in (gs, dx, dw, part)),
            rows, h, float(eps), ctas, vpt, threads, _stream(x))
    if rc != 0:
        raise RuntimeError(f"rms_norm_bwd kernel launch failed: CUDA error "
                           f"{rc}")
    rms_norm_bwd.launches += 1
    return dx, dw


def rms_norm_bwd(x, weight, grad, eps, need_x=True, need_w=True,
                 grad_sum=None):
    """``(dx, dw)`` of ``rms_norm(x, weight, eps)`` for the cotangent
    ``grad``, each None when not needed; ``grad_sum`` (the residual
    entry's second cotangent) is added to dx in x's dtype. A CPU tensor
    takes :func:`rms_norm_backward_reference`; a CUDA tensor launches
    the backward of ``csrc/rms_norm.cu`` (without its dw stage when dw
    is not needed) or raises."""
    if x.device.type == "cpu" or plain_active():
        dx, dw = rms_norm_backward_reference(x, weight, grad, eps)
        if grad_sum is not None:
            dx = dx + grad_sum
        return dx if need_x else None, dw if need_w else None
    grad = grad.contiguous()
    gs = None if grad_sum is None else grad_sum.contiguous()
    _check_rms("rms_norm_bwd", x, weight, grad,
               *(() if gs is None else (gs,)))
    if x.numel() == 0 or not (need_x or need_w):
        return (torch.empty_like(x) if need_x else None,
                torch.zeros_like(weight) if need_w else None)
    return _bwd_launch(x, weight, grad, gs, eps, need_x, need_w,
                       _bwd_plan(x, need_w))


rms_norm_bwd.launches = 0


class _RMSNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: :func:`rms_norm_bwd` (the backward
    kernel on the card, the plain VJP on the CPU), as JAX's
    ``_rms_bwd``."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, grad, ctx.eps,
                              *ctx.needs_input_grad[:2])
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, differentiable in x and weight. A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``csrc/rms_norm.cu`` (forward and backward) or raises."""
    if torch.is_grad_enabled() and (x.requires_grad
                                    or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _rms_norm_forward(x, weight, eps)


rms_norm.launches = 0


def rms_norm_residual_reference(x, residual, weight, eps):
    """``_rms_ref`` with a residual: s = x + residual in x's dtype, then
    :func:`rms_norm_reference` of s. Returns ``(normed, s)``."""
    s = x + residual
    return rms_norm_reference(s, weight, eps), s


def _rms_norm_residual_forward(x, residual, weight, eps):
    """The forward alone: the plain version for a CPU tensor, else one
    launch of the residual entry of ``csrc/rms_norm.cu`` (or a raise)."""
    if x.device.type == "cpu" or plain_active():
        return rms_norm_residual_reference(x, residual, weight, eps)
    return _forward_launch(x, residual, weight, eps)


class _RMSNormResidual(torch.autograd.Function):
    """Forward: the kernel. Backward: :func:`rms_norm_bwd` through s =
    x + residual (saved from the forward) for the normed output's
    cotangent, plus the sum's cotangent in x's dtype — the JAX residual
    ``custom_vjp`` backward, the VJP of ``_rms_ref`` (fused.py:149-153);
    x and residual get the same gradient."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        out, total = _rms_norm_residual_forward(x, residual, weight, eps)
        ctx.save_for_backward(total, weight)
        ctx.eps = eps
        return out, total

    @staticmethod
    def backward(ctx, g_out, g_sum):
        total, weight = ctx.saved_tensors
        need_x, need_r, need_w = ctx.needs_input_grad[:3]
        ds, dw = rms_norm_bwd(total, weight, g_out, ctx.eps,
                              need_x or need_r, need_w, grad_sum=g_sum)
        return ds if need_x else None, ds if need_r else None, dw, None


def rms_norm_residual(x, residual, weight, eps):
    """``(rms(x + residual) * weight, x + residual)`` over the last axis,
    the sum in x's dtype, differentiable in x, residual and weight. A CPU
    tensor takes the plain version; a CUDA tensor launches the residual
    entry of ``csrc/rms_norm.cu`` (one pass writes both outputs) and its
    backward, or raises."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, residual, weight)):
        return _RMSNormResidual.apply(x, residual, weight, eps)
    return _rms_norm_residual_forward(x, residual, weight, eps)


rms_norm_residual.launches = 0


def fused_rms_norm(x, weight, eps: float = 1e-6, residual=None):
    """RMSNorm, optionally fused with a residual add: the JAX
    ``fused_rms_norm`` contract. Without ``residual``, :func:`rms_norm`;
    with it, ``(normed(x + residual) * weight, x + residual)`` through
    :func:`rms_norm_residual`."""
    if residual is None:
        return rms_norm(x, weight, eps)
    return rms_norm_residual(x, residual, weight, eps)

# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rot(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rope_one_reference(x, cos, sin):
    return x * cos[None, :, None, :] + _rot(x) * sin[None, :, None, :]


def rope_reference(q, k, cos, sin, start=None):
    """The JAX ``_rope_ref``: (b, s, h, d) q and k, (s, d) cos/sin,
    ``x*cos + rot(x)*sin`` computed in the inputs' dtype. With
    ``start`` (a (1,) int32 tensor) cos/sin are whole (T, d) tables and
    rows ``start .. start + s - 1`` are used, the start clamped to
    [0, T - s] as ``jax.lax.dynamic_slice_in_dim`` clamps it."""
    if start is not None:
        s = q.shape[1]
        rows = start.long().clamp(0, cos.shape[0] - s) \
            + torch.arange(s, device=cos.device)
        cos, sin = cos.index_select(0, rows), sin.index_select(0, rows)
    return _rope_one_reference(q, cos, sin), _rope_one_reference(k, cos, sin)


def _rope_launch(xs, cos, sin, sign, start=None):
    """Rotate each tensor of ``xs`` (one launch for all of them; they
    share a shape) by +theta (sign 1) or -theta (sign -1); ``start`` as
    in :func:`rope_reference`."""
    x0 = xs[0]
    _check_cuda("rope", *xs, cos, sin)
    b, s, h, d = x0.shape
    vec = 16 // x0.element_size()
    if d % (2 * vec):
        raise ValueError(f"rope kernel needs head_dim % {2 * vec} == 0, "
                         f"got {d}")
    rows = s if start is None else cos.shape[0]
    if tuple(cos.shape) != (rows, d) or tuple(sin.shape) != (rows, d) \
            or cos.dtype != x0.dtype or sin.dtype != x0.dtype or rows < s:
        raise ValueError(f"rope: cos/sin must be ({rows}, {d}) {x0.dtype} "
                         f"with at least {s} rows, got {tuple(cos.shape)} "
                         f"{cos.dtype}")
    if start is not None and (start.dtype != torch.int32
                              or start.device != x0.device
                              or start.numel() != 1):
        raise ValueError("rope: start must be one int32 on the tensors' "
                         f"device, got {start.dtype} {tuple(start.shape)} "
                         f"on {start.device}")
    outs = [torch.empty_like(x) for x in xs]
    if x0.numel() == 0:
        return outs
    x1, o1 = (xs[1], outs[1]) if len(xs) == 2 else (xs[0], outs[0])
    fn = _kernel("rope", "pt_rope",
                 [ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x0.dtype], x0.data_ptr(), outs[0].data_ptr(),
            x1.data_ptr(), o1.data_ptr(), len(xs), cos.data_ptr(),
            sin.data_ptr(), None if start is None else start.data_ptr(),
            rows, b * s, s, h, d, float(sign), _stream(x0))
    if rc != 0:
        raise RuntimeError(f"rope kernel launch failed: CUDA error {rc}")
    fused_rope.launches += 1
    return outs


def _rope_pair(q, k, cos, sin, sign, start=None):
    """q and k rotated by sign * theta: one launch when their shapes are
    equal, two for GQA (as ``fused_rope`` at fused.py:250-255)."""
    if q.device.type == "cpu" or plain_active():
        sn = sin if sign > 0 else -sin
        return rope_reference(q, k, cos, sn, start)
    if q.shape == k.shape:
        return tuple(_rope_launch([q, k], cos, sin, sign, start))
    return _rope_launch([q], cos, sin, sign, start)[0], \
        _rope_launch([k], cos, sin, sign, start)[0]


class _Rope(torch.autograd.Function):
    """The rotation is orthogonal: the backward is the same kernel with
    sin negated (``ct*c + rot(ct)*(-s)`` is the JAX ``_rope_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        ctx.shapes, ctx.dtype = (q.shape, k.shape), q.dtype
        return _rope_pair(q, k, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        gq, gk = (torch.zeros(shape, dtype=ctx.dtype, device=cos.device)
                  if g is None else g.contiguous()
                  for g, shape in zip((gq, gk), ctx.shapes))
        dq, dk = _rope_pair(gq, gk, cos, sin, -1.0)
        return dq, dk, None, None


def fused_rope(q, k, cos, sin, start=None):
    """Rotary embedding of q (b, s, h, d) and k (b, s, hk, d) with
    (s, d) cos/sin in their dtype, differentiable in q and k. CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/rope.cu`` or raise. fp32 and bf16; the kernel rounds once
    from fp32 where the JAX reference rounds each bf16 product.

    ``start`` is the serving route (``generate()``'s cache path, the
    JAX ``dynamic_slice_in_dim(cos, pos, s)``): a (1,) int32 tensor on
    the tensors' device holding the first position, with cos/sin the
    whole (T, d) tables. The kernel reads the position on the device,
    so a captured CUDA graph replays it at each step's position. It is
    inference only (no gradient)."""
    if start is not None:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
            raise NotImplementedError(
                "fused_rope(start=) is the inference route; call it under "
                "torch.no_grad() or slice the tables for training")
        return _rope_pair(q, k, cos, sin, 1.0, start)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _Rope.apply(q, k, cos, sin)
    return _rope_pair(q, k, cos, sin, 1.0)


fused_rope.launches = 0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_reference(p, g, m, v, lr, beta1, beta2, eps, weight_decay, bc1,
                    bc2):
    """The TPU ``_adamw_kernel`` arithmetic: every scalar an fp32 value
    (as in its SMEM block, so ``1 - beta1`` is taken in fp32), the bias
    corrections ``bc1 = 1 - beta1**step`` and ``bc2 = 1 - beta2**step``
    given, m and v upcast to fp32 (as the TPU wrapper upcasts bf16
    moments). Returns new ``(p, m, v)``: p in p's dtype, m and v fp32."""
    pf, gf, m, v = p.float(), g.float(), m.float(), v.float()
    lr, beta1, beta2, eps, weight_decay, bc1, bc2 = (
        torch.tensor(x, dtype=torch.float32, device=p.device)
        for x in (lr, beta1, beta2, eps, weight_decay, bc1, bc2))
    m_new = beta1 * m + (1 - beta1) * gf
    v_new = beta2 * v + (1 - beta2) * gf * gf
    mhat = m_new / bc1
    vhat = v_new / bc2
    p_new = pf - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf)
    return p_new.to(p.dtype), m_new, v_new


def _pow_f32(base: float, step: int) -> np.float32:
    """fp32 ``base ** step`` by binary exponentiation: XLA's ``pow`` of
    an fp32 base and the optimizer's int32 step, bit for bit."""
    b, acc, e = np.float32(base), np.float32(1), int(step)
    while e:
        if e & 1:
            acc = np.float32(acc * b)
        b = np.float32(b * b)
        e >>= 1
    return acc


def _bias_corrections(beta1, beta2, step):
    """(1 - beta1**step, 1 - beta2**step) in fp32, as the JAX optimizer
    computes them from its int32 step."""
    one = np.float32(1)
    return (float(one - _pow_f32(beta1, step)),
            float(one - _pow_f32(beta2, step)))


def fused_adamw(p, g, m, v, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                weight_decay=0.01, step=1):
    """One decoupled AdamW step, **in place**: p, m and v are
    overwritten (the JAX ``fused_adamw`` returns new arrays). m and v
    are both fp32 or both bf16 (``multi_precision=False`` on a bf16
    parameter); p is fp32 or bf16; g is fp32 or bf16 and is cast to fp32
    in the kernel. The arithmetic is fp32 and each of p, m and v is
    stored rounded once. A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/adamw.cu`` or raises. The JAX wrapper skips
    its kernel below 1024 elements for the same math in jnp, in the
    operands' dtypes; the port launches for every size."""
    bc1, bc2 = _bias_corrections(beta1, beta2, step)
    if p.device.type == "cpu" or plain_active():
        np_, nm, nv = adamw_reference(p, g, m, v, lr, beta1, beta2, eps,
                                      weight_decay, bc1, bc2)
        p.copy_(np_)
        m.copy_(nm)
        v.copy_(nv)
        return p, m, v
    _check_cuda("fused_adamw", p, g, m, v)
    if m.dtype != v.dtype:
        raise TypeError(f"fused_adamw: moments of two dtypes ({m.dtype}, "
                        f"{v.dtype})")
    n = p.numel()
    if g.numel() != n or m.numel() != n or v.numel() != n:
        raise ValueError("fused_adamw: p, g, m and v differ in size")
    if n == 0:
        return p, m, v
    fn = _kernel("adamw", "pt_adamw",
                 [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                 + [ctypes.c_longlong] + [ctypes.c_float] * 7
                 + [ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[p.dtype], _DTYPE_CODE[g.dtype],
            _DTYPE_CODE[m.dtype], p.data_ptr(),
            g.data_ptr(), m.data_ptr(), v.data_ptr(), n, float(lr),
            float(beta1), float(beta2), float(eps), float(weight_decay),
            bc1, bc2, _stream(p))
    if rc != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: CUDA error "
                           f"{rc}")
    fused_adamw.launches += 1
    return p, m, v


fused_adamw.launches = 0
