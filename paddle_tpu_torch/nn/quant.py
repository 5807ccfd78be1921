"""Weight-only quantization for inference: int8/int4 absmax codes.

Counterpart of ``paddle_tpu/nn/quant/__init__.py``. The JAX package
stores a linear weight as (in, out); torch's ``nn.Linear`` as (out, in),
and so does every function here: scales are ``(out,)`` per output
channel, or ``(out, in // group_size)`` per group of ``group_size``
consecutive input columns (JAX's ``(in // group_size, out)``
transposed). int4 codes are nibble-packed along the last (in) axis, two
consecutive input columns a byte, the even column in the low nibble, an
odd column count padded with a zero nibble: the port's byte ``[o, j]``
is JAX's ``[j, o]``.

:func:`dequantize_array` computes ``q * scale / qmax`` (a product, then
a true division), element by element as the JAX function does; the
weight-only product of the serving engines (``ops.weight_only``) reads
the codes and computes the same weights in its kernel."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear", "quantize_array", "dequantize_array",
           "quant_step_bound"]


def _bits(algo) -> int:
    if algo in ("weight_only_int8", "llm.int8", None):
        return 8
    if algo == "weight_only_int4":
        return 4
    raise ValueError(f"unsupported weight-quant algo {algo!r}")


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(out, in) int8 codes in [-8, 7] -> (out, ceil(in/2)) packed
    bytes: two consecutive input columns a byte (low nibble = even
    column). An odd column count is padded; the caller carries the true
    count."""
    even, odd = q[:, ::2], q[:, 1::2]
    if odd.shape[1] < even.shape[1]:
        odd = F.pad(odd, (0, 1))
    packed = (even.to(torch.int16) & 0xF) | ((odd.to(torch.int16) & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8)


def _unpack_int4(q: torch.Tensor, in_features: Optional[int] = None
                 ) -> torch.Tensor:
    """Inverse of :func:`_pack_int4`; ``in_features`` slices the packing
    pad back off (odd column counts)."""
    u = q.view(torch.uint8).to(torch.int16)
    lo, hi = u & 0xF, u >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    full = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)
    if in_features is not None and in_features < full.shape[1]:
        full = full[:, :in_features]
    return full.to(torch.int8)


def quantize_array(w: torch.Tensor, bits: int = 8, group_size: int = -1):
    """Absmax symmetric quantization of an (out, in) weight: returns
    (int8 codes, int4 nibble-packed on the in axis; fp32 scales,
    ``(out,)`` per channel or ``(out, in // group_size)`` grouped, where
    ``group_size`` must divide ``in``). The codes are JAX's
    ``clip(round(w / max(scale, 1e-9) * qmax), -qmax - 1, qmax)`` with
    round-half-to-even."""
    qmax = 2 ** (bits - 1) - 1
    w = w.detach().float()
    out_f, in_f = w.shape
    if group_size and group_size > 0:
        if in_f % group_size:
            raise ValueError(
                f"group_size={group_size} does not divide in_features="
                f"{in_f}; weight-only grouped quantization needs whole "
                "groups (pad the weight or use per-channel group_size=-1)")
        gw = w.reshape(out_f, in_f // group_size, group_size)
        scale = gw.abs().amax(dim=-1)                       # (out, groups)
        q = torch.round(gw / scale.clamp_min(1e-9)[..., None] * qmax)
        q = q.clamp(-qmax - 1, qmax).reshape(out_f, in_f).to(torch.int8)
    else:
        scale = w.abs().amax(dim=1)                         # (out,)
        q = torch.round(w / scale.clamp_min(1e-9)[:, None] * qmax)
        q = q.clamp(-qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        q = _pack_int4(q)
    return q, scale.float()


def dequantize_array(q: torch.Tensor, scale: torch.Tensor, bits: int = 8,
                     in_features: Optional[int] = None,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_array` (grouped when ``scale`` is 2-D):
    ``q * scale / qmax`` in fp32, a product and then a true division, as
    the JAX function computes it (not a product by a precomputed
    ``scale / qmax``, which rounds differently)."""
    # a device tensor, not a host scalar: CUDA's division by a host
    # scalar multiplies by its reciprocal
    qmax = torch.full((), float(2 ** (bits - 1) - 1), dtype=torch.float32,
                      device=q.device)
    if bits == 4:
        q = _unpack_int4(q, in_features)
    qf = q.float()
    if scale.dim() == 2:                                      # grouped
        out_f, rows = qf.shape
        groups = scale.shape[1]
        w = (qf.reshape(out_f, groups, rows // groups) * scale[..., None]
             / qmax).reshape(out_f, rows)
    else:
        w = qf * scale[:, None] / qmax
    return w.to(out_dtype)


def quant_step_bound(scale, bits: int = 8) -> float:
    """Worst-case elementwise |dequant - original| of a weight quantized
    against ``scale``: half the quantization step, max(scale) / qmax /
    2. The weight half of the serving engine's ``quant_error_bound()``."""
    qmax = 2 ** (bits - 1) - 1
    s = scale.detach().cpu().numpy() if isinstance(scale, torch.Tensor) \
        else np.asarray(scale)
    return float(np.max(s)) / qmax / 2


def weight_quantize(x: torch.Tensor, algo="weight_only_int8", arch=None,
                    group_size: int = -1):
    """Per-output-channel (or per-group) absmax quantization of an (out,
    in) weight: (int8 codes, fp32 scales). int4 packs two nibbles a
    byte; the original column count is carried on the returned codes
    (``_orig_in_features``) so that the round trip slices an odd
    count's pad back off."""
    qw, scale = quantize_array(x, _bits(algo), group_size)
    qw._orig_in_features = int(x.shape[1])
    return qw, scale


def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo="weight_only_int8", out_dtype="float32",
                      in_features: Optional[int] = None, group_size=-1):
    """Inverse of :func:`weight_quantize` (the grouped layout is carried
    by the scales' shape). For int4 the column count is ``in_features``,
    else the ``_orig_in_features`` tag :func:`weight_quantize` left."""
    if in_features is None:
        in_features = getattr(x, "_orig_in_features", None)
    dt = getattr(torch, out_dtype) if isinstance(out_dtype, str) \
        else out_dtype
    return dequantize_array(x, scale, _bits(algo), in_features=in_features,
                            out_dtype=dt)


def weight_only_linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
                       weight_scale=None, weight_dtype="int8", arch=None,
                       group_size: int = -1) -> torch.Tensor:
    """``y = x @ dequant(weight).T + bias`` in fp32, cast to x's dtype,
    through the weight-only product (``ops.weight_only``: its kernel on
    a CUDA tensor, ``dequantize_array`` and ``F.linear`` on the CPU). A
    ``group_size > 0`` request must match the scales' grouping, and an
    int4 weight's packed width must fit the activation's feature
    count: both refusals are JAX's."""
    from ..ops.weight_only import weight_only_matmul
    in_f = int(x.shape[-1])
    if group_size and group_size > 0 and weight_scale is not None:
        if weight_scale.dim() != 2:
            raise ValueError(
                f"weight_only_linear: group_size={group_size} requested "
                "but weight_scale is per-channel (1-D) — quantize with "
                "weight_quantize(..., group_size=...) to get per-group "
                "scales (silently running per-channel would misreport "
                "the quantization error)")
        if int(weight_scale.shape[1]) * group_size != in_f:
            raise ValueError(
                f"weight_only_linear: group_size={group_size} "
                f"contradicts the scales' grouping — "
                f"{int(weight_scale.shape[1])} groups x {group_size} != "
                f"in_features={in_f} (the weight was quantized with a "
                "different group size)")
    bits = 4 if weight_dtype == "int4" else 8
    if bits == 4:
        tag = getattr(weight, "_orig_in_features", None)
        if tag is not None and int(tag) != in_f:
            raise ValueError(
                f"weight_only_linear: activation has {in_f} features "
                f"but the int4 weight was quantized from "
                f"in_features={int(tag)}")
        if (in_f + 1) // 2 != int(weight.shape[1]):
            raise ValueError(
                f"weight_only_linear: activation has {in_f} features "
                f"but the packed int4 weight has {int(weight.shape[1])} "
                f"columns (expects {(in_f + 1) // 2})")
    y = weight_only_matmul(x, weight, weight_scale, bits, in_f)
    if bias is not None:
        y = (y.float() + bias).to(x.dtype)
    return y


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold: float = 6.0):
    """LLM.int8-shaped API: the whole product runs through the int8
    weight-only product (the outlier split is a bandwidth device the
    JAX package leaves out too)."""
    return weight_only_linear(x, weight, bias=bias,
                              weight_scale=weight_scale,
                              weight_dtype="int8")
