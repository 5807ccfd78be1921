"""Functional ops of the port that route to its kernels.

Counterparts of ``paddle_tpu/nn/functional.py`` ``rms_norm`` and
``scaled_dot_product_attention``; q/k/v are (batch, seq, heads,
head_dim), the paddle convention."""
from __future__ import annotations

from ..ops.flash_attention import sdpa
from ..ops.fused import rms_norm as _fused_rms_norm

__all__ = ["rms_norm", "scaled_dot_product_attention"]


def rms_norm(x, weight, epsilon=1e-6):
    """RMSNorm over the last axis times ``weight``: the fused op (the
    CUDA kernel on the GPU, a gradient through its torch VJP)."""
    return _fused_rms_norm(x, weight, epsilon)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, sliding_window=None):
    """Flash attention kernels when there is no mask and no dropout,
    else the plain ``_xla_sdpa`` sequence (``ops.flash_attention.sdpa``).
    ``sliding_window`` bands causal attention to the last W keys."""
    return sdpa(query, key, value, attn_mask, is_causal=is_causal,
                dropout_p=dropout_p if training else 0.0,
                window=sliding_window)
