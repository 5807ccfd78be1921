"""Fused transformer ops: the hand-written CUDA kernels
``csrc/rms_norm.cu``, ``csrc/rope.cu`` and ``csrc/adamw.cu`` and their
plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/fused.py``: ``fused_rms_norm``
without ``residual`` (the TPU ``_rms_kernel``; :func:`rms_norm`) and
with it (``_rms_res_kernel``; :func:`rms_norm_residual`),
``fused_rope`` (``_rope_kernel``) and ``fused_adamw``
(``_adamw_kernel``)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build, plain_active

__all__ = ["rms_norm", "rms_norm_reference", "rms_norm_residual",
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


def _check_rms(name, x, weight, *more):
    """What the RMSNorm kernels need, or raise: CUDA fp32/bf16 tensors,
    a (h,) weight in x's dtype, h a multiple of the 16-byte vector
    width. Returns h."""
    _check_cuda(name, x, weight, *more)
    h = x.shape[-1]
    if weight.dtype != x.dtype or tuple(weight.shape) != (h,):
        raise ValueError(
            f"{name}: weight must be ({h},) {x.dtype}, got "
            f"{tuple(weight.shape)} {weight.dtype}")
    vec = 16 // x.element_size()
    if h % vec:
        raise ValueError(f"{name} kernel needs h % {vec} == 0 (h={h})")
    return h


def _rms_norm_forward(x, weight, eps):
    """The forward alone: the plain version for a CPU tensor, else the
    ``csrc/rms_norm.cu`` launch (or a raise)."""
    if x.device.type == "cpu" or plain_active():
        return rms_norm_reference(x, weight, eps)
    h = _check_rms("rms_norm", x, weight)
    out = torch.empty_like(x)
    rows = x.numel() // h
    if rows == 0:
        return out
    fn = _kernel("rms_norm", "pt_rms_norm",
                 [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_float, ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), weight.data_ptr(),
            out.data_ptr(), rows, h, float(eps), _stream(x))
    if rc != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    rms_norm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    """Forward: the kernel. Backward: the gradient of
    :func:`rms_norm_reference` recomputed by torch's autograd — the JAX
    ``_rms_bwd`` is the same jnp VJP, so there is no backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_norm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wd = weight.detach().requires_grad_(ctx.needs_input_grad[1])
            out = rms_norm_reference(xd, wd, ctx.eps)
            wrt = [t for t in (xd, wd) if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad))
        gx = next(grads) if xd.requires_grad else None
        gw = next(grads) if wd.requires_grad else None
        return gx, gw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm over the last axis, differentiable in x and weight. A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``csrc/rms_norm.cu`` or raises."""
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
    h = _check_rms("rms_norm_residual", x, weight, residual)
    if residual.shape != x.shape or residual.dtype != x.dtype:
        raise ValueError(
            f"rms_norm_residual: residual must be {tuple(x.shape)} "
            f"{x.dtype}, got {tuple(residual.shape)} {residual.dtype}")
    out, total = torch.empty_like(x), torch.empty_like(x)
    rows = x.numel() // h
    if rows == 0:
        return out, total
    fn = _kernel("rms_norm", "pt_rms_norm_residual",
                 [ctypes.c_int] + [ctypes.c_void_p] * 5
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), residual.data_ptr(),
            weight.data_ptr(), out.data_ptr(), total.data_ptr(), rows, h,
            float(eps), _stream(x))
    if rc != 0:
        raise RuntimeError(f"rms_norm_residual kernel launch failed: CUDA "
                           f"error {rc}")
    rms_norm_residual.launches += 1
    return out, total


class _RMSNormResidual(torch.autograd.Function):
    """Forward: the kernel. Backward: the torch VJP of
    :func:`rms_norm_residual_reference` for both outputs' cotangents —
    the JAX residual ``custom_vjp`` backward is the VJP of ``_rms_ref``
    (fused.py:149-153)."""

    @staticmethod
    def forward(ctx, x, residual, weight, eps):
        ctx.save_for_backward(x, residual, weight)
        ctx.eps = eps
        return _rms_norm_residual_forward(x, residual, weight, eps)

    @staticmethod
    def backward(ctx, g_out, g_sum):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            outs = rms_norm_residual_reference(*leaves, ctx.eps)
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt, (g_out, g_sum)))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves) + (None,)


def rms_norm_residual(x, residual, weight, eps):
    """``(rms(x + residual) * weight, x + residual)`` over the last axis,
    the sum in x's dtype, differentiable in x, residual and weight. A CPU
    tensor takes the plain version; a CUDA tensor launches the residual
    entry of ``csrc/rms_norm.cu`` (one pass writes both outputs) or
    raises."""
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


def rope_reference(q, k, cos, sin):
    """The JAX ``_rope_ref``: (b, s, h, d) q and k, (s, d) cos/sin,
    ``x*cos + rot(x)*sin`` computed in the inputs' dtype."""
    return _rope_one_reference(q, cos, sin), _rope_one_reference(k, cos, sin)


def _rope_launch(xs, cos, sin, sign):
    """Rotate each tensor of ``xs`` (one launch for all of them; they
    share a shape) by +theta (sign 1) or -theta (sign -1)."""
    x0 = xs[0]
    _check_cuda("rope", *xs, cos, sin)
    b, s, h, d = x0.shape
    vec = 16 // x0.element_size()
    if d % (2 * vec):
        raise ValueError(f"rope kernel needs head_dim % {2 * vec} == 0, "
                         f"got {d}")
    if tuple(cos.shape) != (s, d) or tuple(sin.shape) != (s, d) \
            or cos.dtype != x0.dtype or sin.dtype != x0.dtype:
        raise ValueError(f"rope: cos/sin must be ({s}, {d}) {x0.dtype}, "
                         f"got {tuple(cos.shape)} {cos.dtype}")
    outs = [torch.empty_like(x) for x in xs]
    if x0.numel() == 0:
        return outs
    x1, o1 = (xs[1], outs[1]) if len(xs) == 2 else (xs[0], outs[0])
    fn = _kernel("rope", "pt_rope",
                 [ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x0.dtype], x0.data_ptr(), outs[0].data_ptr(),
            x1.data_ptr(), o1.data_ptr(), len(xs), cos.data_ptr(),
            sin.data_ptr(), b * s, s, h, d, float(sign), _stream(x0))
    if rc != 0:
        raise RuntimeError(f"rope kernel launch failed: CUDA error {rc}")
    fused_rope.launches += 1
    return outs


def _rope_pair(q, k, cos, sin, sign):
    """q and k rotated by sign * theta: one launch when their shapes are
    equal, two for GQA (as ``fused_rope`` at fused.py:250-255)."""
    if q.device.type == "cpu" or plain_active():
        sn = sin if sign > 0 else -sin
        return rope_reference(q, k, cos, sn)
    if q.shape == k.shape:
        return tuple(_rope_launch([q, k], cos, sin, sign))
    return _rope_launch([q], cos, sin, sign)[0], \
        _rope_launch([k], cos, sin, sign)[0]


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


def fused_rope(q, k, cos, sin):
    """Rotary embedding of q (b, s, h, d) and k (b, s, hk, d) with
    (s, d) cos/sin in their dtype, differentiable in q and k. CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/rope.cu`` or raise. fp32 and bf16; the kernel rounds once
    from fp32 where the JAX reference rounds each bf16 product."""
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
