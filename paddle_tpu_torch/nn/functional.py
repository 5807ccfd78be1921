"""Functional ops of the port.

Counterparts of ``paddle_tpu/nn/functional.py``: ``linear``,
``embedding``, ``gelu``, ``softmax``, ``layer_norm``, ``rms_norm``,
``cross_entropy`` (hard labels) and ``scaled_dot_product_attention``.
q/k/v are (batch, seq, heads, head_dim), the paddle convention. Inside
``amp.auto_cast`` the call sites cast their inputs by the op's role, as
the JAX ones do: ``linear`` (white) to the low dtype, ``softmax`` and
``cross_entropy`` (black) up to fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..amp import black_cast, white_cast
from ..ops.flash_attention import sdpa
from ..ops.fused import rms_norm as _fused_rms_norm
from ..ops.math import promote

__all__ = ["linear", "embedding", "gelu", "softmax", "layer_norm",
           "layer_norm_one_pass", "rms_norm", "cross_entropy",
           "scaled_dot_product_attention"]


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with ``weight`` in torch's (out, in)
    layout (the JAX weight is its transpose). A white op: inside
    ``auto_cast`` x and the weight run in the low dtype. The bias, cast
    to the product's dtype, is added after the product is rounded, as in
    JAX (not fused into the GEMM's epilogue)."""
    if x.shape[-1] != weight.shape[-1]:
        raise ValueError(f"linear: input feature dim {x.shape[-1]} "
                         f"(x.shape={list(x.shape)}) != weight in-dim "
                         f"{weight.shape[-1]} (weight.shape="
                         f"{list(weight.shape)})")
    x, weight = promote(*white_cast(x, weight, op_name=("linear",
                                                         "matmul")))
    out = F.linear(x, weight)
    if bias is not None:
        out = out + (bias.to(out.dtype) if out.is_floating_point()
                     else bias)
    return out


def embedding(x, weight):
    """Rows of ``weight`` at the int ids ``x`` (the JAX ``embedding``
    without ``padding_idx``, which no caller of the port sets)."""
    return weight[x.long()]


def gelu(x, approximate=False):
    """GELU, exact (erf) by default as ``jax.nn.gelu(approximate=False)``
    in the JAX ``F.gelu``; ``approximate=True`` is the tanh form."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1, dtype=None):
    """Softmax over ``axis``; a black op (fp32 inside ``auto_cast``)
    unless ``dtype`` names the compute dtype."""
    x = x.to(dtype) if dtype is not None else black_cast(x,
                                                         op_name="softmax")
    return torch.softmax(x, dim=axis)


def layer_norm_one_pass(x, eps: float, ndim: int = 1):
    """Normalize over the last ``ndim`` axes with fp32 statistics from
    one read of x (``paddle_tpu/ops/pallas/fused.py:160``
    ``layer_norm_one_pass``): shifted moments ``var = E[(x-s)^2] -
    E[x-s]^2`` with s the row's first element (detached: the output is
    shift-invariant), clamped at 0; the result in x's dtype."""
    dims = tuple(range(x.dim() - ndim, x.dim()))
    xf = x.float()
    shift = xf[(Ellipsis,) + (slice(0, 1),) * ndim].detach()
    d = xf - shift
    dm = d.mean(dim=dims, keepdim=True)
    d2 = (d * d).mean(dim=dims, keepdim=True)
    var = torch.clamp(d2 - dm * dm, min=0.0)
    return ((d - dm) * torch.rsqrt(var + eps)).to(x.dtype)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over ``normalized_shape`` (the trailing axes): the
    one-pass statistics, then ``* weight + bias`` with torch's dtype
    promotion (a bf16 input with the fp32 O2 LayerNorm weights gives fp32,
    as in JAX)."""
    ndim = 1 if isinstance(normalized_shape, int) else \
        len(tuple(normalized_shape))
    out = layer_norm_one_pass(x, epsilon, ndim)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last axis times ``weight``: the fused op (the
    CUDA kernel on the GPU, a gradient through its torch VJP)."""
    return _fused_rms_norm(x, weight, epsilon)


def cross_entropy(input, label, ignore_index=-100, reduction="mean",
                  axis=-1, label_smoothing=0.0):
    """Hard-label softmax cross-entropy (the JAX ``F.cross_entropy``
    path for integer labels, ``:881-957``). The logits are a black op's
    input (fp32 inside ``auto_cast``); labels are clipped to [0, C) for
    the gather, and tokens whose label is ``ignore_index`` count 0.
    ``label_smoothing`` eps gives ``(1-eps)·nll − eps·mean_c(logp)``.
    "mean" divides the sum by the number of valid labels (at least 1).

    With the class axis last, CUDA logits always take
    ``ops.xent.softmax_xent_rows`` (the CUDA kernels; the JAX package
    takes its kernels only under ``PT_FUSION_PASSES=1``, so the port's
    CUDA default differs on purpose); CPU logits take it under that flag,
    as in JAX, and the log-softmax route otherwise. The fused rows keep
    no (N, C) log-prob tensor; with smoothing ``mean_c(logp) =
    mean_c(logits) − lse``. Their fp32 loss is cast to the logits' dtype,
    as JAX does, so the route changes no dtype."""
    from ..ops.xent import softmax_xent_rows
    from ..passes import fusion_enabled
    logits = black_cast(input, op_name="cross_entropy")
    ax = axis % logits.dim()
    nclass = logits.shape[ax]
    lab = label.long()
    if lab.dim() == logits.dim():
        lab = lab.squeeze(ax)
    safe = lab.clamp(0, nclass - 1)
    if ax == logits.dim() - 1 and (logits.is_cuda or fusion_enabled()):
        nll, lse = softmax_xent_rows(logits.reshape(-1, nclass),
                                     safe.reshape(-1))
        loss = nll.reshape(lab.shape)
        if label_smoothing > 0:
            mean_logit = logits.float().mean(dim=ax)
            loss = (1 - label_smoothing) * loss \
                + label_smoothing * (lse.reshape(lab.shape) - mean_logit)
        loss = loss.to(logits.dtype)
    else:
        logp = torch.log_softmax(logits, dim=ax)
        loss = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
        if label_smoothing > 0:
            loss = (1 - label_smoothing) * loss \
                - label_smoothing * logp.mean(dim=ax)
    valid = lab != ignore_index
    loss = torch.where(valid, loss, torch.zeros((), dtype=loss.dtype,
                                                device=loss.device))
    if reduction == "mean":
        denom = valid.to(loss.dtype).sum()
        return loss.sum() / torch.clamp(denom, min=1.0)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction={reduction!r}: expected 'mean', 'sum' "
                     "or 'none'")


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, sliding_window=None):
    """Flash attention kernels when there is no mask and no dropout,
    else the plain ``_xla_sdpa`` sequence (``ops.flash_attention.sdpa``).
    ``sliding_window`` bands causal attention to the last W keys."""
    return sdpa(query, key, value, attn_mask, is_causal=is_causal,
                dropout_p=dropout_p if training else 0.0,
                window=sliding_window)
