"""Mixture-of-Experts layer of the port.

Counterpart of ``paddle_tpu/incubate/distributed/models/moe.py``: the
gates (``NaiveGate``, ``GShardGate`` with its load-balance aux loss,
``SwitchGate``), the stacked ``ExpertMLP``, and ``MoELayer`` with the
sort-based capacity routing of ``ops.moe_dispatch`` (the JAX layer's
default "gather" dispatch; its "scatter" mode and ``PT_MOE_DISPATCH``
compute the same function and are not carried over) and
``forward_dense``, the one-hot dense dispatch the tests use as the
parity oracle.

On one card there is no expert mesh: ``expert_axis`` is accepted and
ignored, as the JAX layer ignores it when no mesh is active.

Dtypes follow the JAX layer under ``amp.auto_cast``: the gate's Linear
is white (bf16 logits under O2); the GShard aux loss takes the softmax
of those logits in their own dtype (it calls ``jax.nn.softmax``
directly, not the black-cast ``F.softmax``); routing and the gate
weights use the logits upcast to fp32. Routing ties break toward the
lower expert id, as ``jax.lax.top_k`` does: a stable descending sort,
because ``torch.topk`` promises no order among ties and one different
choice moves a whole token to another expert."""
from __future__ import annotations

import math

import torch
from torch import nn

from ....nn import Linear
from ....nn import functional as PF
from ....nn.common import xavier_uniform_
from ....ops.math import einsum
from ....ops.moe_dispatch import build_index_maps, moe_combine, moe_dispatch

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate", "ExpertMLP"]


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BaseGate(nn.Module):
    def __init__(self, d_model, num_expert):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert


class NaiveGate(BaseGate):
    """top-k gate, no aux loss."""

    def __init__(self, d_model, num_expert, topk=2, device=None,
                 dtype=None):
        super().__init__(d_model, num_expert)
        self.gate = Linear(d_model, num_expert, bias=False, device=device,
                           dtype=dtype)
        self.topk = topk

    def forward(self, x):
        return self.gate(x), None


def _gshard_aux(lg: torch.Tensor) -> torch.Tensor:
    """E · sum_e mean_t(softmax(lg))_e · mean_t(onehot(argmax lg))_e, in
    the logits' dtype."""
    e = lg.shape[-1]
    probs = torch.softmax(lg, dim=-1)
    top1 = torch.argmax(lg, dim=-1)
    me = probs.mean(dim=0)
    ce = nn.functional.one_hot(top1, e).to(lg.dtype).mean(dim=0)
    return (me * ce).sum() * e


class GShardGate(BaseGate):
    """top-2 gate with the GShard load-balance aux loss."""

    def __init__(self, d_model, num_expert, topk=2, capacity_factor=1.25,
                 device=None, dtype=None):
        super().__init__(d_model, num_expert)
        self.gate = Linear(d_model, num_expert, bias=False, device=device,
                           dtype=dtype)
        self.topk = topk
        self.capacity_factor = capacity_factor

    def forward(self, x):
        logits = self.gate(x)
        return logits, _gshard_aux(logits)


class SwitchGate(BaseGate):
    """top-1 switch gate with the same load-balance loss."""

    def __init__(self, d_model, num_expert, topk=1, capacity_factor=1.25,
                 device=None, dtype=None):
        super().__init__(d_model, num_expert)
        self.gate = Linear(d_model, num_expert, bias=False, device=device,
                           dtype=dtype)
        self.topk = 1
        self.capacity_factor = capacity_factor

    forward = GShardGate.forward


class ExpertMLP(nn.Module):
    """Stacked expert FFN weights in the JAX layout: w1 (E, d, ffn), b1
    (E, 1, ffn), w2 (E, ffn, d), b2 (E, 1, d); (E, cap, d) -> (E, cap,
    d) through two batched products (``ops.math.einsum``, white under
    ``auto_cast``). The weights start Xavier-uniform with the JAX fans of
    a 3-D parameter (fan_in = shape[1]·shape[2], fan_out =
    shape[0]·shape[2]); the biases at zero."""

    def __init__(self, num_expert, d_model, d_hidden, activation=PF.gelu,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w1 = nn.Parameter(torch.empty(num_expert, d_model, d_hidden,
                                           **kw))
        self.b1 = nn.Parameter(torch.empty(num_expert, 1, d_hidden, **kw))
        self.w2 = nn.Parameter(torch.empty(num_expert, d_hidden, d_model,
                                           **kw))
        self.b2 = nn.Parameter(torch.empty(num_expert, 1, d_model, **kw))
        self.activation = activation
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for w in (self.w1, self.w2):
            e, a, b = w.shape
            xavier_uniform_(w, a * b, e * b, generator)
        self.b1.zero_()
        self.b2.zero_()

    def forward(self, x):
        h = einsum("ecd,edh->ech", x, self.w1) + self.b1
        h = self.activation(h)
        return einsum("ech,ehd->ecd", h, self.w2) + self.b2


class MoELayer(nn.Module):
    """``forward(x: (b, s, d)) -> (b, s, d)``; the gate's aux loss of the
    last forward on ``self.l_aux``.

    Routing: the top-k experts of each token from the fp32 logits, then
    ``build_index_maps`` gives the token->slot and slot->token maps over
    a capacity of ``ceil(capacity_factor · tokens · k / E)`` slots per
    expert (at least k); tokens past an expert's capacity are dropped.
    Dispatch, the experts, and the gate-weighted combine follow; every
    data movement is ``ops.moe_dispatch.gather_rows``."""

    def __init__(self, d_model, experts=None, gate=None, num_expert=None,
                 d_hidden=None, top_k=2, capacity_factor=1.25,
                 expert_axis=None, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if gate is None:
            gate = GShardGate(d_model, num_expert, topk=top_k,
                              capacity_factor=capacity_factor, **kw)
        if isinstance(gate, str):
            gate = {"gshard": GShardGate, "switch": SwitchGate,
                    "naive": NaiveGate}[gate](d_model, num_expert,
                                              topk=top_k, **kw)
        self.gate = gate
        if experts is None:
            experts = ExpertMLP(num_expert, d_model, d_hidden, **kw)
        self.experts = experts
        self.num_expert = num_expert or gate.num_expert
        self.top_k = getattr(gate, "topk", top_k)
        # the gate's capacity factor wins, as in the JAX layer
        self.capacity_factor = getattr(gate, "capacity_factor",
                                       capacity_factor) or capacity_factor
        self.l_aux = None

    def _capacity(self, tokens: int) -> int:
        cap = int(math.ceil(self.capacity_factor * tokens * self.top_k
                            / self.num_expert))
        return max(cap, self.top_k)

    def _route(self, logits, cap):
        """(slot, inv, gates) of the (T, E) gate logits: the index maps
        from the top-k of the logits upcast to fp32 (no gradient), and the
        (T, k) fp32 gate weights (differentiable; 0 for a dropped
        choice)."""
        e, k = self.num_expert, self.top_k
        with torch.no_grad():
            _, topi = _top_k(logits.detach().float(), k)
            slot, inv, keep = build_index_maps(topi, e, cap)
        probs = torch.softmax(logits.float(), dim=-1)
        topv = probs.gather(-1, topi)
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
        gates = torch.where(keep.reshape(-1, k), topv,
                            torch.zeros((), device=topv.device))
        return slot, inv, gates

    def forward(self, x):
        b, s, d = x.shape
        tokens = b * s
        e = self.num_expert
        cap = self._capacity(tokens)
        xt = x.reshape(tokens, d)
        logits, self.l_aux = self.gate(xt)
        slot, inv, gates = self._route(logits, cap)
        buf = moe_dispatch(xt, inv, slot)                     # (E*cap, d)
        eo = self.experts(buf.reshape(e, cap, d))
        out = moe_combine(eo.reshape(e * cap, d), gates, inv, slot)
        return out.reshape(b, s, d)

    def forward_dense(self, x):
        """The dense-dispatch oracle: one-hot (E, cap, T) dispatch and
        combine tensors, O(E·cap·T) memory; for parity tests only."""
        b, s, d = x.shape
        tokens = b * s
        e, k = self.num_expert, self.top_k
        cap = self._capacity(tokens)
        xt = x.reshape(tokens, d)
        logits, self.l_aux = self.gate(xt)
        probs = torch.softmax(logits.float(), dim=-1)
        topv, topi = _top_k(probs, k)
        topv = topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)
        onehot = nn.functional.one_hot(topi, e).to(torch.int32)  # (T, k, E)
        flat = onehot.reshape(-1, e)
        pos = torch.cumsum(flat, dim=0) * flat - 1
        pos_tk = pos.reshape(-1, k, e).amax(dim=-1)
        kp = (pos_tk < cap) & (pos_tk >= 0)
        gates = torch.where(kp, topv, torch.zeros((), device=x.device))
        tidx = torch.arange(tokens, device=x.device)[:, None].expand(
            tokens, k)
        where = (topi.reshape(-1), pos_tk.clamp(0, cap - 1).reshape(-1),
                 tidx.reshape(-1))
        zeros = torch.zeros(e, cap, tokens, device=x.device)
        disp = zeros.index_put(where, kp.reshape(-1).float(),
                               accumulate=True)
        comb = zeros.index_put(where, gates.reshape(-1), accumulate=True)
        expert_in = torch.einsum("ect,td->ecd", disp.to(xt.dtype), xt)
        eo = self.experts(expert_in)
        out = torch.einsum("ect,ecd->td", comb.to(eo.dtype), eo)
        return out.reshape(b, s, d)
