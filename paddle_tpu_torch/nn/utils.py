"""Gradient and parameter utilities of the port.

Counterparts of ``paddle_tpu/nn/utils.py`` ``clip_grad_norm_``,
``clip_grad_value_``, ``parameters_to_vector`` and
``vector_to_parameters``, with the JAX constants: ``clip_grad_norm_``
scales by ``max_norm / (total + 1e-6)`` (the optimizer's
``ClipGradByGlobalNorm`` by ``clip_norm / max(norm, 1e-12)``) and sums
in the gradients' own dtype, as the JAX function does. The gradients are
replaced, as the JAX function replaces them; the parameters are written
in place."""
from __future__ import annotations

import torch

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters"]


def _as_list(parameters):
    if isinstance(parameters, torch.Tensor):
        return [parameters]
    return list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False) -> torch.Tensor:
    """Scale all gradients so their global norm is at most ``max_norm``;
    returns the norm before the clip."""
    params = [p for p in _as_list(parameters) if p.grad is not None]
    if not params:
        return torch.zeros(())
    if float(norm_type) == float("inf"):
        total = torch.stack([p.grad.abs().max() for p in params]).max()
    else:
        total = torch.stack([(p.grad.abs() ** norm_type).sum()
                             for p in params]).sum() ** (1.0 / norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            f"clip_grad_norm_: total norm is {float(total)} "
            "(error_if_nonfinite=True)")
    scale = (max_norm / (total + 1e-6)).clamp_max(1.0)
    for p in params:
        p.grad = p.grad * scale
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value) -> None:
    """Clamp every gradient element into [-clip_value, clip_value]."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad = p.grad.clamp(-clip_value, clip_value)


def parameters_to_vector(parameters) -> torch.Tensor:
    """The parameters flattened and concatenated into one 1-D tensor
    (differentiable)."""
    return torch.cat([p.reshape(-1) for p in _as_list(parameters)])


@torch.no_grad()
def vector_to_parameters(vec, parameters) -> None:
    """Write consecutive slices of the 1-D ``vec`` into the parameters,
    in place, each cast to its parameter's dtype."""
    params = _as_list(parameters)
    need = sum(p.numel() for p in params)
    if vec.shape[0] != need:
        raise ValueError(
            f"vector has {vec.shape[0]} elements but parameters need "
            f"{need}")
    offset = 0
    for p in params:
        n = p.numel()
        p.copy_(vec[offset:offset + n].reshape(p.shape))
        offset += n
