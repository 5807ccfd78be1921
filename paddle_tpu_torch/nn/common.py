"""Layers of the port that route through its functional ops.

Counterparts of ``paddle_tpu/nn/common.py`` ``Linear`` and
``Embedding`` and ``paddle_tpu/nn/norm.py`` ``LayerNorm``: subclasses of
the torch layers (so ``amp.decorate`` and ``state_dict`` treat them as
torch's) whose forward is the port's functional op, so that the
``auto_cast`` roles and the JAX numerics apply. Parameters keep torch's
layout (a Linear weight is (out, in); ``convert.params_from_jax``
transposes the JAX (in, out) weights). Default initialisation follows
the JAX layers' distributions, not their bits: Xavier-uniform Linear
weights and zero biases, N(0, ``init_std``) embeddings (the JAX default
is N(0, 1)), LayerNorm weight 1 and bias 0. ``reset_parameters`` takes
a ``torch.Generator`` so a model can seed every layer from one."""
from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as PF

__all__ = ["Linear", "Embedding", "LayerNorm", "xavier_uniform_"]


@torch.no_grad()
def xavier_uniform_(p: torch.Tensor, fan_in: int, fan_out: int,
                    generator=None) -> torch.Tensor:
    """U(-a, a) with a = sqrt(6 / (fan_in + fan_out)), the JAX
    ``XavierUniform`` initializer."""
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return p.uniform_(-a, a, generator=generator)


class Linear(nn.Linear):
    def reset_parameters(self, generator=None):
        xavier_uniform_(self.weight, self.in_features, self.out_features,
                        generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return PF.linear(x, self.weight, self.bias)


class Embedding(nn.Embedding):
    def __init__(self, num_embeddings, embedding_dim, init_std=1.0,
                 device=None, dtype=None):
        self.init_std = init_std
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.weight.normal_(0.0, self.init_std, generator=generator)

    def forward(self, x):
        return PF.embedding(x, self.weight)


class LayerNorm(nn.LayerNorm):
    def reset_parameters(self, generator=None):
        super().reset_parameters()

    def forward(self, x):
        return PF.layer_norm(x, self.normalized_shape, self.weight,
                             self.bias, self.eps)
