"""The weight-only quantized product: the hand-written CUDA kernel
``csrc/weight_only_gemm.cu`` and its plain PyTorch version.

``weight_only_matmul(x, codes, scales, bits, in_features)`` is
``x @ dequantize_array(codes, scales, bits, in_features).T`` in fp32,
cast to x's dtype: codes (out, in) int8 or (out, ceil(in / 2)) packed
int4 in the port's layout (``nn.quant``), scales fp32 (out,) per channel
or (out, in // group) grouped. It has no Pallas counterpart: the JAX
package dequantizes the serving weights inside its decode program and
XLA fuses the scale multiply into the GEMM's prologue
(``paddle_tpu/serving/quant.py`` ``dequantize_pv``). The serving
engines' quantized layers (``serving.quant.WeightOnlyLinear``) call it.

A CPU tensor (or any inside ``ops.plain_versions()``) takes the plain
version, ``dequantize_array`` then ``F.linear``, which is what a model
whose fp32 weights are the dequantized codes computes: the quantized
engines equal their "dequant twin" bit for bit on the CPU. A CUDA
tensor launches the kernel, or raises."""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import plain_active
from .fused import _kernel, _stream

__all__ = ["weight_only_matmul", "weight_only_matmul_reference",
           "weight_only_bytes"]

_X_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def weight_only_matmul_reference(x: torch.Tensor, codes: torch.Tensor,
                                 scales: torch.Tensor, bits: int,
                                 in_features: int) -> torch.Tensor:
    """The plain version: dequantize (``nn.quant.dequantize_array``),
    then one fp32 ``F.linear``, cast to x's dtype."""
    from ..nn.quant import dequantize_array
    w = dequantize_array(codes, scales, bits, in_features=in_features)
    return F.linear(x.float(), w).to(x.dtype)


def weight_only_bytes(x_shape, codes, scales, out_dtype) -> int:
    """Bytes the product must move: the codes and scales read once, x
    read once, y written once (the bound's numerator)."""
    m = math.prod(x_shape[:-1])
    size = torch.empty(0, dtype=out_dtype).element_size()
    return (codes.numel() + 4 * scales.numel()
            + m * x_shape[-1] * size + m * codes.shape[0] * size)


def _check(x, codes, scales, bits, in_features):
    if x.dtype not in _X_DTYPE:
        raise TypeError(f"weight_only_matmul kernel takes float32/bfloat16 "
                        f"activations, got {x.dtype}")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"weight_only_matmul: int8 codes and float32 scales, "
                        f"got {codes.dtype} and {scales.dtype}")
    if bits not in (4, 8):
        raise ValueError(f"weight_only_matmul: bits={bits}; 8 or 4")
    for t in (codes, scales):
        if t.device != x.device:
            raise ValueError(f"weight_only_matmul: tensors on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("weight_only_matmul kernel needs contiguous "
                             "codes and scales")
    n = codes.shape[0]
    want = in_features if bits == 8 else (in_features + 1) // 2
    if codes.dim() != 2 or codes.shape[1] != want \
            or x.shape[-1] != in_features:
        raise ValueError(
            f"weight_only_matmul: x (..., {in_features}) and {bits}-bit "
            f"codes ({n}, {want}) expected, got {tuple(x.shape)} and "
            f"{tuple(codes.shape)}")
    if scales.dim() == 1:
        if scales.shape[0] != n:
            raise ValueError(f"weight_only_matmul: per-channel scales "
                             f"({n},), got {tuple(scales.shape)}")
        return 0, 0
    groups = scales.shape[1] if scales.dim() == 2 else 0
    if scales.dim() != 2 or scales.shape[0] != n or groups < 1 \
            or in_features % groups:
        raise ValueError(f"weight_only_matmul: grouped scales ({n}, groups) "
                         f"with groups dividing {in_features}, got "
                         f"{tuple(scales.shape)}")
    return groups, in_features // groups


def weight_only_matmul(x: torch.Tensor, codes: torch.Tensor,
                       scales: torch.Tensor, bits: int,
                       in_features: int) -> torch.Tensor:
    """(..., in) activations times the quantized (out, in) weight ->
    (..., out) of x's dtype. On a CUDA tensor one launch of
    ``csrc/weight_only_gemm.cu`` over the flattened rows (counted in
    ``weight_only_matmul.launches``); bad dtypes, devices or shapes
    raise. A CPU tensor, or any inside ``ops.plain_versions()``, takes
    :func:`weight_only_matmul_reference`."""
    if x.device.type == "cpu" or plain_active():
        return weight_only_matmul_reference(x, codes, scales, bits,
                                            in_features)
    groups, gsize = _check(x, codes, scales, bits, in_features)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_features)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    m, n = x2.shape[0], codes.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y.reshape(*lead, n)
    row_bytes = codes.shape[1]
    vec = int(row_bytes % 16 == 0 and in_features % 4 == 0
              and codes.data_ptr() % 16 == 0
              and x2.data_ptr() % (4 * x2.element_size()) == 0)
    fn = _kernel("weight_only_gemm", "pt_weight_only_gemm",
                 [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                 + [ctypes.c_int] * 3 + [ctypes.c_long]
                 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    rc = fn(_X_DTYPE[x.dtype], bits, vec, x2.data_ptr(), codes.data_ptr(),
            scales.data_ptr(), y.data_ptr(), m, n, in_features, row_bytes,
            groups, gsize, _stream(x))
    if rc != 0:
        raise RuntimeError(f"weight_only_gemm kernel launch failed: CUDA "
                           f"error {rc}")
    weight_only_matmul.launches += 1
    return y.reshape(*lead, n)


weight_only_matmul.launches = 0
