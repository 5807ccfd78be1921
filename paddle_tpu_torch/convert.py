"""Weights from the JAX package into the port.

The JAX ``nn.Linear`` stores its weight as (in, out); ``torch.nn.Linear``
as (out, in). ``params_from_jax`` transposes every linear weight (Llama's
projections and head; ERNIE-MoE's ``qkv_proj``, ``out_proj``, dense
``mlp.N`` layers and MoE ``gate.gate``), and the last two axes of every
stacked linear weight of the stacked trunk (``self_attn__q_proj__weight``
and its kin: JAX's (L, in, out) to the port's (L, out, in)), and passes
the rest (embeddings,
norm weights and biases, and the MoE expert stacks ``w1``/``b1``/``w2``/
``b2``, whose layout the port keeps) through. The RoPE tables are
buffers the port computes itself, so they are not carried over.
``adamw_state_from_jax`` carries an AdamW state (moments, fp32 masters,
step) the same way, for ``Optimizer.load_state``."""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "adamw_state_from_jax"]

_LINEARS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj", "qkv_proj", "out_proj", "gate.gate")
_LINEAR_SUFFIXES = tuple(f"{n}.weight" for n in _LINEARS)
# the stacked trunk's names: the layer's dotted path with "." -> "__"
_STACKED_SUFFIXES = tuple(f"{n.replace('.', '__')}__weight"
                          for n in _LINEARS)
# the Linear layers of an nn.Sequential FFN (ERNIE-MoE's dense blocks)
_SEQUENTIAL_LINEAR = re.compile(r"\.mlp\.\d+\.weight$")


def _linear_ndim(name: str) -> int:
    """2 for a linear weight, 3 for a stacked one, 0 for anything
    else."""
    if name.endswith(_STACKED_SUFFIXES):
        return 3
    if name.endswith(_LINEAR_SUFFIXES) or name == "lm_head.weight" \
            or _SEQUENTIAL_LINEAR.search(name):
        return 2
    return 0


def _to_torch(name: str, arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":     # numpy's bf16 extension type
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    ndim = _linear_ndim(name)
    if ndim:
        if t.ndim != ndim:
            raise ValueError(f"{name}: expected a {ndim}-D linear weight, "
                             f"got shape {tuple(t.shape)}")
        t = t.transpose(-1, -2).contiguous()
    return t


def params_from_jax(named_numpy: Dict[str, np.ndarray]
                    ) -> Dict[str, torch.Tensor]:
    """``{jax named_parameters() name: numpy array}`` -> a state dict
    that the port model's ``load_state_dict`` takes (CPU tensors; the
    load copies them onto the model's device)."""
    return {name: _to_torch(name, arr) for name, arr in named_numpy.items()}


def adamw_state_from_jax(functional_state: dict,
                         param_names: Dict[str, str]) -> dict:
    """A JAX ``Optimizer.functional_state()`` (arrays as numpy or jax)
    -> ``{"step": int, "slots": {parameter name: {"moment1",
    "moment2"[, "master"]: CPU tensor}}}``. ``param_names`` maps the JAX
    optimizer's slot names to the model's ``named_parameters()`` names;
    linear-weight states are transposed like the weights."""
    slots = {}
    for opt_name, s in functional_state["slots"].items():
        name = param_names[opt_name]
        slots[name] = {k: _to_torch(name, v) for k, v in s.items()}
    return {"step": int(np.asarray(functional_state["step"])),
            "slots": slots}
