"""ERNIE-style Mixture-of-Experts causal LM.

Counterpart of ``paddle_tpu/models/ernie_moe.py``: a pre-LN decoder with
learned positions (``wpe``), GPT attention (the flash kernels), every
``moe_every``-th block's FFN a GShard top-k ``MoELayer`` (the others
``Linear -> GELU -> Linear``), a head tied to the token embedding
(``matmul(h, wte.weight^T)``), and the loss ``F.cross_entropy`` plus
``aux_loss_weight`` times the sum of the gates' aux losses. Parameter
names match the JAX model's ``named_parameters()``, so
``convert.params_from_jax`` maps one onto the other.

On one card there is no expert mesh: ``expert_parallel`` is accepted
and changes nothing (the JAX layer ignores its expert axis without a
mesh). ``tensor_parallel`` likewise."""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from ..incubate.distributed.models import MoELayer
from ..nn import Embedding, LayerNorm, Linear
from ..nn import functional as PF
from ..ops.math import matmul
from .gpt import GPTAttention

__all__ = ["ErnieMoEConfig", "ErnieMoEBlock", "ErnieMoEModel",
           "ErnieMoEForCausalLM", "ernie_moe_tiny_config",
           "ernie_moe_base_config"]


@dataclass
class ErnieMoEConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 2              # every 2nd layer is MoE (GShard style)
    gate: str = "gshard"
    aux_loss_weight: float = 0.01
    expert_parallel: bool = True
    tensor_parallel: bool = False
    dropout: float = 0.0
    dtype: str = "float32"


def ernie_moe_tiny_config(**kw) -> ErnieMoEConfig:
    base = dict(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=256,
                max_position_embeddings=128, num_experts=4)
    base.update(kw)
    return ErnieMoEConfig(**base)


def ernie_moe_base_config(**kw) -> ErnieMoEConfig:
    return ErnieMoEConfig(**kw)


class ErnieMoEBlock(nn.Module):
    def __init__(self, config: ErnieMoEConfig, use_moe: bool, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.ln_1 = LayerNorm(h, eps=config.layer_norm_epsilon, **kw)
        self.attn = GPTAttention(config, **kw)
        self.ln_2 = LayerNorm(h, eps=config.layer_norm_epsilon, **kw)
        self.use_moe = use_moe
        if use_moe:
            self.mlp = MoELayer(
                d_model=h, num_expert=config.num_experts,
                d_hidden=config.intermediate_size, top_k=config.top_k,
                capacity_factor=config.capacity_factor, gate=config.gate,
                **kw)
        else:
            self.mlp = nn.Sequential(
                Linear(h, config.intermediate_size, **kw), nn.GELU(),
                Linear(config.intermediate_size, h, **kw))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class ErnieMoEModel(nn.Module):
    def __init__(self, config: ErnieMoEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        # N(0, 0.02) embeddings, as the JAX model's weight_attr
        self.wte = Embedding(config.vocab_size, config.hidden_size,
                             init_std=0.02, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, init_std=0.02, **kw)
        self.layers = nn.ModuleList([
            ErnieMoEBlock(config, i % config.moe_every
                          == config.moe_every - 1, **kw)
            for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size,
                              eps=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        for block in self.layers:
            x = block(x)
        return self.ln_f(x)

    def aux_loss(self):
        """Sum of the gates' load-balance losses of the last forward."""
        total = None
        for layer in self.layers:
            if layer.use_moe and layer.mlp.l_aux is not None:
                total = layer.mlp.l_aux if total is None \
                    else total + layer.mlp.l_aux
        return total


class ErnieMoEForCausalLM(nn.Module):
    """Built directly on ``device`` (default the GPU; ``device="cpu"``
    must be asked for) with weights drawn from a ``torch.Generator``
    seeded with ``seed`` on that device: embeddings N(0, 0.02), Linear
    and expert weights Xavier-uniform, biases 0, LayerNorm weights 1 —
    the JAX layers' distributions. Replace them with
    ``load_state_dict(convert.params_from_jax(...))`` to run the JAX
    model's weights."""

    def __init__(self, config: ErnieMoEConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype or getattr(torch, config.dtype)
        self.config = config
        # built on the meta device, then allocated once on the target
        self.ernie = ErnieMoEModel(config, device="meta", dtype=dt)
        self.to_empty(device=dev)
        self.init_weights(seed)

    @property
    def device(self) -> torch.device:
        return self.ernie.wte.weight.device

    @torch.no_grad()
    def init_weights(self, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator=gen)

    def forward(self, input_ids, labels=None):
        """(b, s) ids -> (b, s, vocab) logits of causal attention; with
        ``labels`` the ``(loss, logits)`` pair, the loss being the mean
        cross-entropy plus ``aux_loss_weight`` times the summed aux
        losses."""
        h = self.ernie(input_ids)
        logits = matmul(h, self.ernie.wte.weight, transpose_y=True)
        if labels is None:
            return logits
        loss = PF.cross_entropy(logits, labels, reduction="mean")
        aux = self.ernie.aux_loss()
        if aux is not None:
            loss = loss + self.config.aux_loss_weight * aux
        return loss, logits

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def active_params(self) -> float:
        """Parameters a token runs through: all but the (1 - k/E) share
        of the expert weights (the bench's ``active_p``)."""
        c = self.config
        expert = sum(p.numel() for n, p in self.named_parameters()
                     if ".experts." in n)
        return self.num_params() - expert * (1 - c.top_k / c.num_experts)
