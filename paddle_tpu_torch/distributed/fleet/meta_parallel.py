"""The Megatron tensor-parallel layers over the mp process group.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel.py:60-212``
with its names and signatures. The JAX layers hold the whole weight with
an ``"mp"`` partition spec and GSPMD inserts the collectives; here each
layer holds only this rank's slice of its weight, and the collectives are
explicit (``mp_ops``). The group is ``mp_group``, else fleet's
(``fleet.init(mp_degree=n)``), else none: with no group, or one of one
member, every layer is its serial version.

Weights keep Paddle's and JAX's ``(in, out)`` layout (``x @ W``), so a
JAX layer's full weight carries across by slicing alone
(``convert.params_from_jax_mp`` with :func:`mp_partition_specs`):

- ``ColumnParallelLinear``: W ``(in, out/n)`` split by output column,
  bias ``(out/n,)``; ``c_identity`` in front, and with ``gather_output``
  the columns all-gathered behind;
- ``RowParallelLinear``: W ``(in/n, out)`` split by input row, the
  partial products all-reduced, the bias (whole) added after; unless
  ``input_is_parallel``, the input is first split along its last axis;
- ``VocabParallelEmbedding``: the table ``(V/n, D)`` split by row, a
  masked lookup and an all-reduce;
- ``ParallelCrossEntropy``: per-token cross-entropy on logits split by
  class (the output of a ``ColumnParallelLinear(gather_output=False)``);
- ``ScatterOp``/``GatherOp``: this rank's slice of a tensor along
  ``axis`` and the concatenation back (Megatron's sequence-parallel
  pair); JAX states them as sharding constraints, which leave the
  global value as it is;
- ``mark_as_sequence_parallel_parameter`` and ``get_rng_state_tracker``:
  named seeds, and a ``rng_state(name)`` context under which the port's
  threefry draws (``paddle_tpu_torch.random.split_key``) take that
  stream, the previous one restored on exit (JAX's tracker: each entry
  starts again from the named seed's key).

Initial weights follow JAX's initializers on the global shape (Xavier
normal for the linears, N(0, 1) for the table, zero biases), drawn for
the local slice. ``PipelineLayer``, ``LayerDesc`` and
``SharedLayerDesc`` come with the pipeline (``ROADMAP.md`` A.6 (e2))."""
from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from ... import random as prandom
from ...device import resolve_device
from ..mesh import get_hybrid_communicate_group
from . import mp_ops
from .mp_ops import mp_degree

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "ScatterOp",
           "GatherOp", "mark_as_sequence_parallel_parameter",
           "get_rng_state_tracker", "mp_partition_specs"]


def _group(mp_group):
    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _split_size(total: int, n: int, what: str) -> int:
    if total % n:
        raise ValueError(f"{what}={total} does not split into mp degree {n}")
    return total // n


def _param(shape, std, device, dtype) -> nn.Parameter:
    p = nn.Parameter(torch.empty(shape, device=resolve_device(device),
                                 dtype=dtype or torch.float32))
    with torch.no_grad():
        if std:
            p.normal_(0.0, std)
        else:
            p.zero_()
    return p


class _MPLayer(nn.Module):
    # {parameter: its partition spec in the layer's (Paddle's) layout}
    _MP_SPECS: dict = {}

    def __init__(self, mp_group):
        super().__init__()
        self.mp_group = _group(mp_group)
        self.degree = mp_degree(self.mp_group)


class ColumnParallelLinear(_MPLayer):
    """W ``(in, out)`` split over mp by output column (JAX's
    ``P(None, "mp")``)."""
    _MP_SPECS = {"weight": (None, "mp"), "bias": ("mp",)}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        local = _split_size(out_features, self.degree, "out_features")
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = _param((in_features, local), std, device, dtype)
        self.bias = _param((local,), 0.0, device, dtype) if has_bias \
            else None

    def forward(self, x):
        out = torch.matmul(mp_ops.c_identity(x, self.mp_group), self.weight)
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = mp_ops.gather(out, self.mp_group, -1)
        return out


class RowParallelLinear(_MPLayer):
    """W ``(in, out)`` split over mp by input row (JAX's
    ``P("mp", None)``); the bias is whole on every rank."""
    _MP_SPECS = {"weight": ("mp", None), "bias": None}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        local = _split_size(in_features, self.degree, "in_features")
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = _param((local, out_features), std, device, dtype)
        self.bias = _param((out_features,), 0.0, device, dtype) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = mp_ops.split(x, self.mp_group, -1)
        out = mp_ops.mp_allreduce(torch.matmul(x, self.weight),
                                  self.mp_group)
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(_MPLayer):
    """The ``(num_embeddings, embedding_dim)`` table split over mp by
    row (JAX's ``P("mp", None)``)."""
    _MP_SPECS = {"weight": ("mp", None)}

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        local = _split_size(num_embeddings, self.degree, "num_embeddings")
        self.weight = _param((local, embedding_dim), 1.0, device, dtype)

    def forward(self, x):
        return mp_ops.vocab_parallel_embedding(x, self.weight,
                                               self.mp_group)


class ParallelCrossEntropy(_MPLayer):
    """Per-token softmax cross-entropy (``reduction="none"``) of logits
    split over mp by class; tokens labelled ``ignore_index`` give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return mp_ops.parallel_cross_entropy(input, label, self.mp_group,
                                             self.ignore_index)


class ScatterOp:
    """This rank's slice of ``x`` along ``axis`` over the mp group (the
    gradient: the all-gather of the slices')."""

    @staticmethod
    def apply(x, axis=1):
        return mp_ops.split(x, _group(None), axis)


class GatherOp:
    """Every mp rank's slice concatenated along ``axis`` (the gradient:
    this rank's slice)."""

    @staticmethod
    def apply(x, axis=1):
        return mp_ops.gather(x, _group(None), axis)


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True


def mp_partition_specs(model: nn.Module) -> dict:
    """``{parameter name: partition spec}`` of every parameter of
    ``model`` that a meta-parallel layer splits, in that layer's layout,
    beside the model's own ``partition_specs()`` where it has one."""
    out = dict(model.partition_specs()) \
        if hasattr(model, "partition_specs") else {}
    for mname, mod in model.named_modules():
        for pname, spec in getattr(mod, "_MP_SPECS", {}).items():
            if getattr(mod, pname, None) is not None:
                out[f"{mname}.{pname}" if mname else pname] = spec
    return out


class _RNGStateTracker:
    """Named seeds (JAX's tracker): ``add(name, seed)`` keeps the key of
    ``seed``; under ``rng_state(name)`` the port's draws take that key's
    stream, and the stream in use before comes back on exit. An unknown
    name leaves the draws as they are."""

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        self._states[name] = prandom.prng_key(seed)

    def rng_state(self, name="model-parallel-rng"):
        if name in self._states:
            return prandom.rng_context(self._states[name])
        return contextlib.nullcontext()


_RNG_TRACKER = _RNGStateTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER
