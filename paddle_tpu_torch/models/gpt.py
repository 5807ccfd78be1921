"""GPT attention (the non-cache branch).

Counterpart of ``paddle_tpu/models/gpt.py`` ``GPTAttention`` (``:66-105``)
without its KV-cache decode branch: one fused ``qkv_proj``, q/k/v cut
out of its (b, s, 3, heads, head_dim) view, causal attention at scale
1/sqrt(head_dim) through ``scaled_dot_product_attention`` (the flash
kernels), then ``out_proj``. ERNIE-MoE uses it as its attention. The
JAX layer's explicit ``attn_mask`` has no caller in the port; the rest
of the GPT model is not ported yet."""
from __future__ import annotations

from torch import nn

from ..nn import Linear
from ..nn import functional as PF

__all__ = ["GPTAttention"]


class GPTAttention(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        if getattr(config, "dropout", 0.0):
            raise NotImplementedError("attention dropout is not ported")
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.head_dim = h // self.num_heads
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = Linear(h, 3 * h, **kw)
        self.out_proj = Linear(h, h, **kw)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        # the flash kernels take contiguous (b, s, heads, head_dim) tensors;
        # the slices of the fused product are strided
        q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
        out = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.out_proj(out.reshape(b, s, h))
