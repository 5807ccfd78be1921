"""Products of the port that follow ``amp.auto_cast``.

Counterparts of ``paddle_tpu/ops/math.py`` ``matmul`` (``:574``) and
``einsum`` (``:678``): white ops, so inside ``auto_cast`` their floating
operands run in the low dtype; outside, mixed fp32/bf16 operands
promote to fp32 as jnp's do. The products themselves are
``torch.matmul``/``torch.einsum`` (cuBLAS), as the JAX package leaves
them to XLA."""
from __future__ import annotations

import torch

from ..amp import white_cast

__all__ = ["matmul", "einsum", "promote"]


def promote(*ops):
    """The operands with their floating dtypes promoted to a common one
    (jnp's promotion of a mixed fp32/bf16 product; torch's products
    take one dtype)."""
    floats = [t.dtype for t in ops if t.is_floating_point()]
    if len(set(floats)) <= 1:
        return ops
    d = floats[0]
    for f in floats[1:]:
        d = torch.promote_types(d, f)
    return tuple(t.to(d) if t.is_floating_point() else t for t in ops)


def matmul(x, y, transpose_y=False):
    a, b = promote(*white_cast(x, y, op_name="matmul"))
    if transpose_y and b.dim() > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def einsum(equation, *operands):
    ops = white_cast(*operands, op_name="einsum")
    ops = promote(*(ops if isinstance(ops, tuple) else (ops,)))
    return torch.einsum(equation, *ops)
