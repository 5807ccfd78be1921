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
step) the same way, for ``Optimizer.load_state``.

A model split over an mp process group: ``params_from_jax_mp`` takes
this rank's slice of each parameter that a partition-spec table (the
port's layout, ``LlamaForCausalLM.partition_specs()`` or
``meta_parallel.mp_partition_specs``) splits, after the transposes;
``jax_state_dict`` goes the other way for the distributed checkpoint:
every parameter in JAX's layout under JAX's name, a split one as this
rank's region of JAX's global tensor (a ``ShardedTensor``), so that
``save_state_dict`` writes JAX's global shapes."""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = ["params_from_jax", "adamw_state_from_jax", "params_from_jax_mp",
           "jax_state_dict"]

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


def params_from_jax_mp(named_numpy: Dict[str, np.ndarray], specs: dict,
                       rank: int, degree: int) -> Dict[str, torch.Tensor]:
    """:func:`params_from_jax`, then rank ``rank``'s slice of ``degree``
    (``mesh.spec_piece``, a copy) of each parameter that ``specs``
    splits: the state dict of a model that holds only its mp slice."""
    from .distributed.mesh import spec_piece
    return {n: spec_piece(t, specs.get(n), rank, degree).contiguous()
            for n, t in params_from_jax(named_numpy).items()}


def jax_state_dict(model: torch.nn.Module) -> dict:
    """``{JAX name: tensor or ShardedTensor}``: every parameter of
    ``model`` in JAX's layout (linear weights transposed back, as views
    of the parameters); a parameter that ``fleet.distributed_model``
    split over the mp group is this rank's region of JAX's global
    tensor, written by the first dp rank that holds it.
    ``distributed.save_state_dict`` of it writes a directory that JAX's
    ``load_state_dict`` reads with its global shapes;
    ``distributed.load_state_dict`` into it fills the parameters in
    place, from a directory of any split (or none)."""
    from .distributed.mesh import get_hybrid_communicate_group, spec_dim
    from .distributed.sharding import ShardedTensor
    split = getattr(model, "_mp_split", {})
    group = getattr(model, "mp_group", None)
    hcg = get_hybrid_communicate_group()
    replica = hcg.get_data_parallel_rank() if hcg is not None else 0
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        swap = _linear_ndim(name) != 0
        if swap:
            t = t.transpose(-1, -2)
        if name not in split:
            out[name] = t
            continue
        spec, gshape = split[name]
        dim = spec_dim(spec)
        shape = list(gshape)
        if swap:
            shape[-1], shape[-2] = shape[-2], shape[-1]
            dim = {len(shape) - 1: len(shape) - 2,
                   len(shape) - 2: len(shape) - 1}.get(dim, dim)
        region = [[0, d] for d in shape]
        k = shape[dim] // group.nranks
        region[dim] = [group.rank * k, (group.rank + 1) * k]
        out[name] = ShardedTensor(shape, t, region, group, dim,
                                  replica=replica)
    return out
