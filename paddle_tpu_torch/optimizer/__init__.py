"""Optimizers of the port.

Counterpart of ``paddle_tpu/optimizer/__init__.py`` ``Optimizer``
(``get_lr``/``step``/``clear_grad``) and ``Adam``/``AdamW`` on the
decoupled path, which runs ``ops.fused.fused_adamw`` once per parameter
(the CUDA kernel on the GPU). The JAX optimizer is a pure update inside
the jitted step; here ``step()`` updates the parameters and the states
in place, on the parameters' own device. LR schedulers and gradient
clipping are not ported yet."""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from ..ops.fused import fused_adamw

__all__ = ["Optimizer", "AdamW"]

_LOW = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        params, seen = [], set()
        for p in parameters:
            if id(p) not in seen:          # a tied weight counts once
                seen.add(id(p))
                params.append(p)
        self._param_list = params
        self._learning_rate = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._multi_precision = multi_precision
        self._slots: Dict[int, dict] = {}   # id(param) -> state tensors
        self._step_count = 0

    def get_lr(self) -> float:
        return float(self._learning_rate)

    def clear_grad(self):
        """Drop every parameter's gradient (frees its memory)."""
        for p in self._param_list:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One update of every parameter that holds a gradient. The step
        count starts at 1 for the first update, as in the JAX package."""
        todo = [p for p in self._param_list
                if p.grad is not None and p.requires_grad]
        if not todo:
            return
        lr = self.get_lr()
        self._step_count += 1
        for p in todo:
            self._apply(p, p.grad, self._ensure_slots(p), lr,
                        self._step_count)

    def _init_slots(self, p) -> dict:
        return {}

    def _ensure_slots(self, p) -> dict:
        """States on the parameter's device: the optimizer's own, plus an
        fp32 master copy of a low-precision parameter under
        ``multi_precision`` (made from the parameter's current value)."""
        slots = self._slots.get(id(p))
        if slots is None:
            slots = self._init_slots(p)
            if self._multi_precision and p.dtype in _LOW:
                slots["master"] = p.detach().float()
            self._slots[id(p)] = slots
        return slots

    def _apply(self, p, g, slots, lr, step):
        raise NotImplementedError

    # -- state carried in from elsewhere (convert.adamw_state_from_jax) ---
    def load_state(self, state: dict,
                   named_parameters: Iterable) -> None:
        """Set the step count and the per-parameter states from
        ``{"step": int, "slots": {parameter name: {slot: tensor}}}``,
        naming parameters as ``named_parameters`` does; each tensor is
        copied onto its parameter's device."""
        by_name = dict(named_parameters)
        for name, slots in state["slots"].items():
            p = by_name[name]
            self._slots[id(p)] = {k: v.to(p.device).contiguous()
                                  for k, v in slots.items()}
        self._step_count = int(state["step"])


class AdamW(Optimizer):
    """Decoupled AdamW through the fused update (one kernel launch per
    parameter on the GPU). Moments in the parameter's dtype unless
    ``multi_precision`` keeps an fp32 master (then fp32 moments), as the
    JAX ``Adam._init_slots``: a bf16 model with ``multi_precision=False``
    carries bf16 moments. With ``multi_precision`` a bf16 parameter is
    updated through its fp32 master, which is then copied back into the
    parameter."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay,
                         multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._eps = epsilon

    def _init_slots(self, p):
        mdt = torch.float32 if (self._multi_precision
                                or p.dtype == torch.float32) else p.dtype
        return {"moment1": torch.zeros_like(p, dtype=mdt),
                "moment2": torch.zeros_like(p, dtype=mdt)}

    def _apply(self, p, g, slots, lr, step):
        target = slots.get("master", p)
        fused_adamw(target, g.contiguous(), slots["moment1"],
                    slots["moment2"], lr, self._beta1, self._beta2,
                    self._eps, self._weight_decay, step)
        if target is not p:
            p.copy_(target)
