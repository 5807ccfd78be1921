"""Fleet's meta-optimizers over the port's optimizer.

Counterpart of ``paddle_tpu/distributed/fleet/meta_optimizers.py``: the
reference's static-graph passes (gradient merge, recompute, AMP) as
wrappers of an inner optimizer, which ``fleet.distributed_optimizer``
stacks by ``DistributedStrategy`` flags.

- ``GradientMergeOptimizer``: k-step accumulation. Each ``step()`` adds
  the parameters' gradients to an accumulator (in the gradient's dtype,
  as JAX adds them) and drops them; every k-th installs the sum (times
  1/k with ``avg``) and runs the inner step, which under a group-sharded
  inner optimizer reduces them over its group once for the k
  micro-steps. ``state_dict`` keeps the partial accumulation.
- ``RecomputeOptimizer``: carries the inner optimizer (the
  rematerialization itself is the model's recompute setting).
- ``AMPOptimizer``: fp16 scales the loss through ``amp.GradScaler``;
  bf16 needs no scaling."""
from __future__ import annotations

import torch

__all__ = ["GradientMergeOptimizer", "RecomputeOptimizer",
           "AMPOptimizer"]


class _MetaBase:
    def __init__(self, inner):
        self.inner_opt = inner

    def __getattr__(self, name):
        return getattr(self.inner_opt, name)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()`` then this wrapper's ``step()`` (the inner
        optimizer's would skip the accumulation or the scaling)."""
        loss.backward()
        self.step()
        return None, None


class GradientMergeOptimizer(_MetaBase):
    """k-step gradient accumulation (module docstring)::

        opt = GradientMergeOptimizer(inner, k_steps=4, avg=True)
        for batch in loader:
            loss.backward(); opt.step(); opt.clear_grad()"""

    def __init__(self, inner, k_steps=1, avg=True):
        super().__init__(inner)
        self.k_steps = max(int(k_steps), 1)
        self.avg = bool(avg)
        self._acc: dict = {}
        self._micro = 0

    @torch.no_grad()
    def step(self):
        self._micro += 1
        params = self.inner_opt._param_list
        for p in params:
            if p.grad is None or not p.requires_grad:
                continue
            acc = self._acc.get(id(p))
            self._acc[id(p)] = p.grad if acc is None else acc + p.grad
            # backward() adds into p.grad: drop it, so a loop without
            # clear_grad (minimize) does not count it twice
            p.grad = None
        if self._micro < self.k_steps:
            return
        scale = 1.0 / self.k_steps if self.avg else 1.0
        for p in params:
            acc = self._acc.get(id(p))
            if acc is not None:
                p.grad = acc * torch.tensor(scale, dtype=acc.dtype,
                                            device=acc.device)
        self._acc.clear()
        self.inner_opt.step()
        self._micro = 0
        for p in params:
            p.grad = None

    def clear_grad(self, set_to_zero=False):
        """Drops only the current micro-step's gradients: the merged
        accumulator lives in this wrapper."""
        self.inner_opt.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self):
        """The inner state plus the micro-step count and the partial
        accumulation (``@gm_acc.<parameter name>``)."""
        out = dict(self.inner_opt.state_dict())
        out["@gm_micro"] = self._micro
        names = dict(zip((id(p) for p in self.inner_opt._param_list),
                         self.inner_opt._param_names))
        for aid, acc in self._acc.items():
            n = names.get(aid)
            if n is not None:
                out[f"@gm_acc.{n}"] = acc.detach().clone()
        return out

    def set_state_dict(self, state):
        state = dict(state)
        self._micro = int(state.pop("@gm_micro", 0))
        by_name = dict(zip(self.inner_opt._param_names,
                           self.inner_opt._param_list))
        self._acc = {}
        for k in list(state):
            if k.startswith("@gm_acc."):
                p = by_name.get(k[len("@gm_acc."):])
                v = torch.as_tensor(state.pop(k))
                if p is not None:
                    self._acc[id(p)] = v.to(p.device, copy=True)
        self.inner_opt.set_state_dict(state)


class RecomputeOptimizer(_MetaBase):
    """The reference's API shape: the recompute is the model's (its
    ``recompute`` config), this wrapper carries the inner optimizer."""

    def __init__(self, inner, checkpoints=None):
        super().__init__(inner)
        self.checkpoints = checkpoints or []

    def step(self):
        self.inner_opt.step()


class AMPOptimizer(_MetaBase):
    """Mixed precision: fp16 through ``amp.GradScaler`` loss scaling,
    bf16 plain (``amp.decorate(level="O2")``'s semantics)."""

    def __init__(self, inner, dtype="bfloat16", init_loss_scaling=2.**15):
        super().__init__(inner)
        self.dtype = dtype
        self._scaler = None
        if dtype == "float16":
            from ...amp import GradScaler
            self._scaler = GradScaler(init_loss_scaling=init_loss_scaling)

    def scale_loss(self, loss):
        if self._scaler is not None:
            return self._scaler.scale(loss)
        return loss

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """fp16: the loss is scaled before the backward, or ``step``'s
        unscale would shrink never-scaled gradients."""
        self.scale_loss(loss).backward()
        self.step()
        return None, None

    def step(self):
        if self._scaler is not None:
            self._scaler.step(self.inner_opt)
            self._scaler.update()
            return
        self.inner_opt.step()
