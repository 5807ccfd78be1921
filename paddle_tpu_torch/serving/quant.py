"""Weight-only quantized serving: int8/int4 decode weights, read as codes
by the weight-only product kernel.

Counterpart of ``paddle_tpu/serving/quant.py``. A decode step at serving
batch sizes reads every weight byte once and does little arithmetic with
it, so fp32 weights cap decode tokens/s at the card's memory rate over
the weight bytes. Here the serving weight set (q/k/v/o, the MLP's
gate/up/down and an untied ``lm_head``) is quantized once when the engine
is built (int8 or int4, per output channel or per group of input
columns, ``nn.quant``) and every product of every program the engine
runs (decode block, prefill, prefill chunk, speculative verify) reads
the codes and scales through ``ops.weight_only``: on the card one launch
of ``csrc/weight_only_gemm.cu``, which dequantizes in registers, so the
fp32 weight never crosses device memory.

The JAX package quantizes the backend's flat parameter list and wraps
its pure step with an in-graph dequantize. The port's idiom is a module
swap: the backend holds its own copy of the model's module tree in which
each matching ``nn.Linear`` is a :class:`WeightOnlyLinear` (codes and
scales as buffers); the norms, the embedding and the RoPE tables are the
caller's tensors, shared. The caller's model is left as it was, as the
JAX model keeps its fp32 parameters.

The contract is JAX's: ``quant=QuantConfig(...)`` (or ``"int8"`` /
``"int4"`` / ``True``) on the ``ContinuousBatchingEngine`` factory or a
direct ``PagedEngine``, or ``PT_SERVING_QUANT_WEIGHTS=int8|int4``
(``PT_SERVING_QUANT_GROUP`` for the group size) when neither an argument
nor a backend is given; ``quant=`` beside an explicit backend is
refused; the build-time bound ``engine.weight_error_bound()`` (half the
largest quantization step) sits beside the KV bound in
``engine.quant_error_bound()`` and the ``pt_serving_*_error_bound``
gauges."""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.quant import quant_step_bound, quantize_array
from ..observability import metrics as _om
from ..ops.weight_only import weight_only_matmul
from ..utils.flags import env_int, env_str

__all__ = ["QuantConfig", "WeightOnlyLinear", "quantize_backend_model",
           "resolve_quant_config", "scale_pspec"]

# quant-bound gauges (JAX's names; registered at import, no-ops until
# metrics.enable() / PT_METRICS)
_M_KV_BOUND = _om.gauge(
    "pt_serving_kv_error_bound",
    "runtime worst-case |dequant - fp32| over the engine's int8 KV "
    "arena (0 in fp32 mode)")
_M_W_BOUND = _om.gauge(
    "pt_serving_weight_error_bound",
    "build-time worst-case |dequant - fp32| over the engine's "
    "weight-only-quantized decode weights (0 in fp32 mode)")

_BITS = {"int8": 8, "int4": 4}

# the serving weight set: attention and MLP projections and the lm_head.
# Embeddings (a gather, not a product) and norm vectors stay fp32.
_WEIGHT_PATTERNS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                    "up_proj", "down_proj", "lm_head")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How to quantize the serving weights. ``weights``: "int8" |
    "int4". ``group_size``: -1 = per-output-channel absmax scales;
    > 0 = one scale per ``group_size`` input columns per channel (it
    must divide every quantized weight's in_features)."""
    weights: str = "int8"
    group_size: int = -1

    def __post_init__(self):
        if self.weights not in _BITS:
            raise ValueError(
                f"QuantConfig.weights={self.weights!r}; expected 'int8' "
                "or 'int4'")
        if self.group_size != -1 and self.group_size <= 0:
            raise ValueError(
                f"QuantConfig.group_size={self.group_size}; expected -1 "
                "(per-channel) or a positive group size")

    @property
    def bits(self) -> int:
        return _BITS[self.weights]


def resolve_quant_config(quant) -> Optional[QuantConfig]:
    """The engine's ``quant`` argument: a QuantConfig passes through,
    ``"int8"``/``"int4"`` and ``True`` (int8) build one, ``False`` is
    off, ``None`` reads ``PT_SERVING_QUANT_WEIGHTS`` (unset or empty:
    off) and ``PT_SERVING_QUANT_GROUP``."""
    if isinstance(quant, QuantConfig):
        return quant
    if quant is True:
        return QuantConfig()
    if quant is False:
        return None
    if isinstance(quant, str):
        return QuantConfig(weights=quant)
    if quant is not None:
        raise ValueError(f"quant={quant!r}: pass a QuantConfig, "
                         "'int8'/'int4', True/False, or None "
                         "(env-controlled)")
    w = env_str("PT_SERVING_QUANT_WEIGHTS", "")
    if not w:
        return None
    return QuantConfig(weights=w,
                       group_size=env_int("PT_SERVING_QUANT_GROUP", -1))


class WeightOnlyLinear(nn.Module):
    """An ``nn.Linear`` whose weight is held as codes and fp32 scales
    (buffers ``codes``, ``scales``); the forward is
    ``ops.weight_only.weight_only_matmul`` (plus the linear's bias, if
    any, added in fp32)."""

    def __init__(self, linear: nn.Linear, cfg: QuantConfig):
        super().__init__()
        codes, scales = quantize_array(linear.weight, cfg.bits,
                                       cfg.group_size)
        self.bits = cfg.bits
        self.in_features = linear.in_features
        self.out_features = linear.out_features
        self.register_buffer("codes", codes)
        self.register_buffer("scales", scales)
        self.bias = linear.bias

    def forward(self, x):
        y = weight_only_matmul(x, self.codes, self.scales, self.bits,
                               self.in_features)
        if self.bias is not None:
            y = (y.float() + self.bias).to(x.dtype)
        return y

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bits={self.bits}, scales="
                f"{tuple(self.scales.shape)}")


def scale_pspec(weight_spec, scales: torch.Tensor) -> tuple:
    """The tensor-parallel split of a quantized weight's scales (JAX
    ``quant.py`` ``scale_pspec``, in the port's ``(out, in)`` layout):
    the scales ride their weight's out-dim (dim 0) shard — per-channel
    ``(out,)`` scales as ``(axes,)``, grouped ``(out, in // group)`` as
    ``(axes, None)``; a replicated weight replicates its scales. The
    codes pack int4 pairs and groups along the in axis, so an out-dim
    shard never splits a pair or a group; any other split (the psum
    layout's row shards) is refused."""
    dims = tuple(weight_spec or ())
    if not dims or all(d is None for d in dims):
        return ()
    if len(dims) != 2 or dims[1] is not None:
        raise NotImplementedError(
            f"weight-only quant cannot shard scales for weight spec "
            f"{weight_spec} — only out-dim (column) sharding composes "
            "(tp mode='exact')")
    return (dims[0],) if scales.dim() == 1 else (dims[0], None)


def _copy_tree(module: nn.Module) -> nn.Module:
    """A copy of ``module``'s tree of modules that shares every
    parameter and buffer tensor: replacing a submodule of the copy
    leaves the original as it was."""
    c = copy.copy(module)
    c._parameters = dict(module._parameters)
    c._buffers = dict(module._buffers)
    c._modules = {name: None if child is None else _copy_tree(child)
                  for name, child in module._modules.items()}
    return c


@torch.no_grad()
def quantize_backend_model(model: nn.Module, cfg: QuantConfig
                           ) -> Tuple[nn.Module, float]:
    """``(copy, weight_error_bound)``: the backend's copy of ``model``
    with every ``nn.Linear`` of the serving weight set (a module name
    matching ``_WEIGHT_PATTERNS``) replaced by a
    :class:`WeightOnlyLinear`, and the largest half quantization step
    over them. A model with no matching linear is refused: serving fp32
    from a ``quant=`` request would be a misconfiguration."""
    qmodel = _copy_tree(model)
    bound, swapped = 0.0, 0
    for name, parent in list(qmodel.named_modules()):
        for child_name, child in list(parent._modules.items()):
            full = f"{name}.{child_name}" if name else child_name
            if isinstance(child, nn.Linear) \
                    and any(pat in full for pat in _WEIGHT_PATTERNS):
                q = WeightOnlyLinear(child, cfg)
                parent._modules[child_name] = q
                bound = max(bound, quant_step_bound(q.scales, cfg.bits))
                swapped += 1
    if not swapped:
        raise ValueError(
            f"{type(model).__name__} has no quantizable serving weights "
            f"(looked for nn.Linear modules matching {_WEIGHT_PATTERNS}) "
            "— weight-only serving quant needs the standard projection "
            "layout")
    return qmodel, bound
