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
other optimizers of the JAX module are not ported yet.

As in the JAX step, where the step count is a device int32 that the
program increments (``functional_state``), the optimizer keeps its step
count and its learning rate in (1,) int32 and fp32 tensors on the
parameters' device, which the kernel reads: ``step()`` adds 1 to the
step tensor on the device, so a CUDA graph of the training step
(``jit.TrainStep``) replays the right bias corrections, and whoever
replays it writes the learning rate first. The host ``_step_count``
mirrors the step for ``state_dict()``. Loading a state copies into the
tensors the optimizer already holds, so a captured graph keeps reading
them.

The hooks of JAX's ``Optimizer``: ``_grad_sync`` (``{name: grad}`` ->
``{name: grad}``, set by ``distributed.collectives.attach_grad_sync``)
runs first in ``step()``, before ``grad_clip``; ``_shard_plan`` (set by
``distributed.sharding.group_sharded_parallel``) then makes the step
reduce the gradients over its process group and update each rank's
region of every parameter (its slots are regions: ``state_dict()``
returns them as ``ShardedTensor``s under JAX's keys). The clips sum
squares over the group where a gradient is a region."""
from __future__ import annotations

import time
from typing import Dict, Iterable

import torch

from ..ops.fused import fused_adamw
from . import lr
from .lr import LRScheduler

__all__ = ["Optimizer", "AdamW", "lr", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]

_LOW = (torch.bfloat16, torch.float16)


def _capturing(device: torch.device) -> bool:
    """Whether the current stream of ``device`` is being captured into a
    CUDA graph (never on the CPU)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


# ---------------------------------------------------------------------------
# gradient clipping: {name: grad} -> {name: clipped grad}, new tensors
# ---------------------------------------------------------------------------

class ClipGradBase:
    def apply(self, grads: dict, reduce_squares=None) -> dict:
        """``reduce_squares``: ``{name: local sum of squares}`` -> the
        global sums, where the gradients are regions of a sharded step
        (``distributed.sharding``); None sums locally."""
        raise NotImplementedError


def _squares(grads, reduce_squares):
    """Each gradient's fp32 sum of squares (over the group where the
    step shards it)."""
    sq = {k: g.float().square().sum() for k, g in grads.items()}
    return sq if reduce_squares is None else reduce_squares(sq)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def apply(self, grads, reduce_squares=None):
        return {k: g.clamp(self.min, self.max) for k, g in grads.items()}


def _scale(clip_norm, norm):
    """min(clip_norm / max(norm, 1e-12), 1) on the norm's device, fp32."""
    return (clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)


class ClipGradByNorm(ClipGradBase):
    """Each gradient on its own to an L2 norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, grads, reduce_squares=None):
        sq = _squares(grads, reduce_squares)
        return {k: (g.float() * _scale(self.clip_norm, sq[k].sqrt())
                    ).to(g.dtype) for k, g in grads.items()}


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients by one factor, to a global L2 norm of at most
    ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    def apply(self, grads, reduce_squares=None):
        sq = sum(_squares(grads, reduce_squares).values())
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
        self._step_count = 0                # host mirror of _step_tensor
        dev = params[0].device if params else torch.device("cpu")
        self._step_tensor = torch.zeros(1, dtype=torch.int32, device=dev)
        self._lr_tensor = torch.full((1,), self.get_lr(),
                                     dtype=torch.float32, device=dev)
        # the in-graph gradient sync ({name: grad} -> {name: grad}) and
        # the group-sharded plan (module docstring)
        self._grad_sync = None
        self._shard_plan = None

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

    def write_lr(self):
        """``get_lr()`` into the device lr tensor (a fill on the device:
        no copy from host memory, no sync)."""
        self._lr_tensor.fill_(self.get_lr())

    @torch.no_grad()
    def step(self):
        """One update of every parameter that holds a gradient, after
        ``grad_clip`` (applied to all of them together). The step count
        starts at 1 for the first update, as in the JAX package; it is
        incremented on the device, with no host read. Run eagerly, the
        step writes ``get_lr()`` into the lr tensor and moves the host
        mirror; under CUDA stream capture it does neither (the replayer
        writes the lr and moves the mirror at each replay)."""
        todo = {n: p for n, p in zip(self._param_names, self._param_list)
                if p.grad is not None and p.requires_grad}
        if not todo:
            return
        grads = {n: p.grad for n, p in todo.items()}
        if self._grad_sync is not None:
            grads = self._grad_sync(grads)
        plan = self._shard_plan
        if plan is not None:
            grads = plan.sync(todo, grads)
        if self._grad_clip is not None:
            grads = self._grad_clip.apply(
                grads, None if plan is None else plan.reduce_squares(todo))
        if not _capturing(self._step_tensor.device):
            self.write_lr()
            self._step_count += 1
        self._step_tensor.add_(1)
        t0 = time.perf_counter()
        for n, p in todo.items():
            if plan is None:
                self._apply(p, grads[n], self._ensure_slots(p),
                            self._lr_tensor, self._step_tensor)
            else:
                plan.apply(self, p, grads[n])
        if plan is not None:
            plan.finish(todo.values(), t0, self._step_tensor.device)

    def _init_slots(self, p) -> dict:
        return {}

    def _ensure_slots(self, p) -> dict:
        """States on the parameter's device: the optimizer's own, plus an
        fp32 master copy of a low-precision parameter under
        ``multi_precision`` (made from the parameter's current value)."""
        slots = self._slots.get(id(p))
        if slots is None:
            src = p.detach() if self._shard_plan is None else \
                self._shard_plan.local_param(p).contiguous()
            slots = self._init_slots(src)
            if self._multi_precision and src.dtype in _LOW:
                slots["master"] = src.float()
            self._slots[id(p)] = slots
        return slots

    def functional_state(self) -> dict:
        """Every trainable parameter's states, made where missing (zeros,
        or the fp32 master), and the step count, as JAX's
        ``functional_state``: ``{"slots": {name: {slot: tensor}},
        "step": int}`` (the held tensors, not copies)."""
        slots = {}
        for n, p in zip(self._param_names, self._param_list):
            if p.requires_grad:
                slots[n] = dict(self._ensure_slots(p))
        return {"slots": slots, "step": self._step_count}

    def _apply(self, p, g, slots, lr, step):
        raise NotImplementedError

    def _set_slot(self, p, slot: str, value) -> None:
        """Copy ``value`` into the state tensor the optimizer holds for
        ``(p, slot)`` (its address stays, for a captured graph that reads
        it); a new tensor on p's device where there is none yet."""
        slots = self._slots.setdefault(id(p), {})
        if self._shard_plan is not None:
            value = self._shard_plan.localize(p, value)
        value = torch.as_tensor(value)
        held = slots.get(slot)
        if held is not None and held.shape == value.shape \
                and held.dtype == value.dtype:
            held.copy_(value)
        else:
            slots[slot] = value.to(p.device, copy=True).contiguous()

    def _set_step(self, step: int) -> None:
        self._step_count = int(step)
        self._step_tensor.fill_(self._step_count)

    # -- state carried in from elsewhere (convert.adamw_state_from_jax) ---
    def load_state(self, state: dict,
                   named_parameters: Iterable) -> None:
        """Set the step count and the per-parameter states from
        ``{"step": int, "slots": {parameter name: {slot: tensor}}}``,
        naming parameters as ``named_parameters`` does; each tensor is
        copied onto its parameter's device, into the state tensor held
        for it where there is one."""
        by_name = dict(named_parameters)
        for name, slots in state["slots"].items():
            for k, v in slots.items():
                self._set_slot(by_name[name], k, v)
        self._set_step(state["step"])

    # -- state dict (the JAX layout: "<param name>.<slot>" keys) ---------
    def state_dict(self) -> dict:
        """Copies of the states (later steps update the live ones in
        place), the step count and the scheduler's state; under a
        group-sharded plan a sharded parameter's states are this rank's
        regions, as ``ShardedTensor``s."""
        out = {}
        plan = self._shard_plan
        for n, p in zip(self._param_names, self._param_list):
            for k, v in self._slots.get(id(p), {}).items():
                v = v.detach().clone()
                if plan is not None and plan.dim(p) is not None:
                    from ..distributed.sharding import ShardedTensor
                    v = ShardedTensor(plan.shape(p), v, plan.region(p),
                                      plan.group, plan.dim(p))
                out[f"{n}.{k}"] = v
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state: dict) -> None:
        """The inverse of ``state_dict()``: states are copied into the
        tensors held for them where there are some, as ``load_state``."""
        self._set_step(state.get("@step", 0))
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                  LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        by_name = dict(zip(self._param_names, self._param_list))
        for k, v in state.items():
            if k in ("@step", "LR_Scheduler"):
                continue
            n, slot = k.rsplit(".", 1)
            self._set_slot(by_name[n], slot, v)


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
        """``lr`` and ``step``: the optimizer's device tensors."""
        target = slots.get("master", p)
        fused_adamw(target, g.contiguous(), slots["moment1"],
                    slots["moment2"], lr, self._beta1, self._beta2,
                    self._eps, self._weight_decay, step)
        if target is not p:
            p.copy_(target)
