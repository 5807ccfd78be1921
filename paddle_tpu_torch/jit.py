"""The training step of the port.

Counterpart of ``paddle_tpu/jit/__init__.py`` ``TrainStep``: the JAX
step is one jitted program (forward, ``value_and_grad``, the optimizer's
functional update); here it runs eagerly in PyTorch's idiom — forward,
``loss.backward()``, ``optimizer.step()``, clear the gradients — with
one host sync per call. A CUDA graph of the step is later work."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, opt); loss = step(batch)``.
    ``loss_fn(model, batch)`` returns the loss (or a tuple whose first
    item is the loss). Numpy arrays in ``batch`` become tensors on the
    model's device; nothing is ever moved off it."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.last_loss = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _to_device(self, batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(b) for b in batch)
        if isinstance(batch, np.ndarray):
            return torch.from_numpy(batch).to(self.device)
        return batch

    def __call__(self, batch):
        """One optimizer step; returns the (detached) loss tensor. The
        call ends by reading the loss on the host (``last_loss``): one
        sync per step, so the host never queues more than one step."""
        self.optimizer.clear_grad()
        out = self.loss_fn(self.model, self._to_device(batch))
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        loss = loss.detach()
        self.last_loss = float(loss)
        return loss

    def run_steps(self, batch, n_steps: int):
        """``n_steps`` steps on ``batch``; returns the last loss."""
        for _ in range(n_steps):
            loss = self(batch)
        return loss
