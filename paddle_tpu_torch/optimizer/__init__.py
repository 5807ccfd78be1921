"""Optimizers of the port.

Counterpart of ``paddle_tpu/optimizer/__init__.py``: ``Optimizer``
(``get_lr``/``set_lr``/``set_lr_scheduler``/``step``/``clear_grad``/
``state_dict``/``set_state_dict``), the gradient clips
``ClipGradByValue``/``ClipGradByNorm``/``ClipGradByGlobalNorm`` (torch
ops, norms in fp32 as JAX computes them), the LR schedulers
(:mod:`.lr`, a copy of the JAX module), and ``AdamW`` on the decoupled
path, which runs ``ops.fused.fused_adamw`` once per parameter (the CUDA
kernel on the GPU). The JAX optimizer is a pure update inside the
jitted step; here ``step()`` clips the gradients, then updates the
parameters and the states in place, on the parameters' own device. The
other optimizers of the JAX module are not ported yet."""
from __future__ import annotations

from typing import Dict, Iterable

import torch

from ..ops.fused import fused_adamw
from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "AdamW", "lr", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]

_LOW = (torch.bfloat16, torch.float16)


# ---------------------------------------------------------------------------
# gradient clipping: {name: grad} -> {name: clipped grad}, new tensors
# ---------------------------------------------------------------------------

class ClipGradBase:
    def apply(self, grads: dict) -> dict:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def apply(self, grads):
        return {k: g.clamp(self.min, self.max) for k, g in grads.items()}


def _scale(clip_norm, norm):
    """min(clip_norm / max(norm, 1e-12), 1) on the norm's device, fp32."""
    return (clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, grads):
        out = {}
        for k, g in grads.items():
            gf = g.float()
            out[k] = (gf * _scale(self.clip_norm, gf.square().sum().sqrt())
                      ).to(g.dtype)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients by one factor, to a global L2 norm of at most
    ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def apply(self, grads):
        sq = sum(g.float().square().sum() for g in grads.values())
        scale = _scale(self.clip_norm, sq.sqrt())
        return {k: (g.float() * scale).to(g.dtype)
                for k, g in grads.items()}


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        params, seen = [], set()
        for p in parameters:
            if id(p) not in seen:          # a tied weight counts once
                seen.add(id(p))
                params.append(p)
        self._param_list = params
        # the JAX optimizer's names for unnamed parameters (state_dict)
        self._param_names = [f"param_{i}" for i in range(len(params))]
        self._learning_rate = learning_rate
        self._weight_decay = 0.0 if weight_decay is None else weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._slots: Dict[int, dict] = {}   # id(param) -> state tensors
        self._step_count = 0

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = value

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def clear_grad(self):
        """Drop every parameter's gradient (frees its memory)."""
        for p in self._param_list:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One update of every parameter that holds a gradient, after
        ``grad_clip`` (applied to all of them together). The step count
        starts at 1 for the first update, as in the JAX package."""
        todo = {n: p for n, p in zip(self._param_names, self._param_list)
                if p.grad is not None and p.requires_grad}
        if not todo:
            return
        grads = {n: p.grad for n, p in todo.items()}
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(grads)
        lr = self.get_lr()
        self._step_count += 1
        for n, p in todo.items():
            self._apply(p, grads[n], self._ensure_slots(p), lr,
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

    # -- state dict (the JAX layout: "<param name>.<slot>" keys) ---------
    def state_dict(self) -> dict:
        """Copies of the states (later steps update the live ones in
        place), the step count and the scheduler's state."""
        out = {}
        for n, p in zip(self._param_names, self._param_list):
            for k, v in self._slots.get(id(p), {}).items():
                out[f"{n}.{k}"] = v.detach().clone()
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state: dict) -> None:
        self._step_count = int(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        by_name = dict(zip(self._param_names, self._param_list))
        for k, v in state.items():
            if k in ("@step", "LR_Scheduler"):
                continue
            n, slot = k.rsplit(".", 1)
            p = by_name[n]
            self._slots.setdefault(id(p), {})[slot] = \
                torch.as_tensor(v).to(p.device, copy=True).contiguous()


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
                 grad_clip=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
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
