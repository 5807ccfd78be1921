"""Mixed precision for the port.

Counterpart of ``paddle_tpu/amp/__init__.py``. ``decorate``: at level O2
every floating parameter becomes the low dtype (RMSNorm weights
included; only BatchNorm and LayerNorm keep theirs), and the optimizer
keeps fp32 masters (``multi_precision``). Buffers such as the RoPE
tables are not parameters and stay as they are.

``auto_cast`` opens a scope in which the port's op call sites cast
their inputs by the op's role, as the JAX ``white_cast``/``black_cast``
do: a white op (matmul class) runs in the low dtype, a black op
(softmax, cross-entropy) upcasts bf16/fp16 inputs to fp32,
any other op follows its inputs. The roles are the JAX op registry's
(``paddle_tpu/ops/registry.py`` ``_AMP_WHITE``/``_AMP_BLACK``) for the
op names the port's call sites pass: white ``linear``, ``matmul`` and
``einsum`` (``white_cast`` casts unless the op is black, as in JAX, so
no white list is needed), black ``softmax`` and ``cross_entropy``; a
name joins ``AMP_BLACK`` when a call site for it is ported. The JAX
scope's custom white and black lists have no caller in the port and
are not carried over. Outside a scope nothing is cast.

``GradScaler`` is JAX's dynamic loss scaling: ``scale`` multiplies the
loss, ``unscale_`` divides every gradient by the scale in fp32 and
checks them for inf/NaN, ``step`` skips the update on a non-finite
gradient, and the scale grows by ``incr_ratio`` after
``incr_every_n_steps`` good steps and shrinks by ``decr_ratio`` after
``decr_every_n_nan_or_inf`` bad ones. Under a group-sharded optimizer
the found-inf is reduced over its group (``distributed.sharding``), so
every rank skips the same steps."""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

__all__ = ["decorate", "auto_cast", "get_amp_dtype", "white_cast",
           "black_cast", "AMP_BLACK", "GradScaler", "amp_decorate"]

_EXCLUDED = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)
_LOW = (torch.bfloat16, torch.float16)

AMP_BLACK = frozenset({"softmax", "cross_entropy"})

# the low dtypes of the scopes open on this thread, innermost last
_scopes = threading.local()


def _stack() -> list:
    st = getattr(_scopes, "stack", None)
    if st is None:
        st = _scopes.stack = []
    return st


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """Cast the models' parameters in place (the Parameter objects stay
    the same, so an optimizer built on them keeps working) and turn on
    the optimizers' fp32 masters. Returns what it was given, as the JAX
    ``decorate`` does."""
    d = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            excluded = {id(p) for sub in m.modules()
                        if isinstance(sub, _EXCLUDED)
                        for p in sub.parameters(recurse=False)}
            for p in m.parameters():
                if id(p) not in excluded and p.is_floating_point():
                    p.data = p.data.to(d)
    if optimizers is None:
        return models
    opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    for opt in opt_list:
        opt._multi_precision = True
    return models, optimizers


@contextlib.contextmanager
def auto_cast(level="O1", dtype="bfloat16"):
    """A scope of automatic casting at the op call sites (see the module
    docstring). O1 and O2 cast alike at the call sites, as in the JAX
    package (O2's difference is ``decorate``)."""
    _stack().append(getattr(torch, dtype) if isinstance(dtype, str)
                    else dtype)
    try:
        yield
    finally:
        _stack().pop()


def _in_any(op_name, names) -> bool:
    ops = (op_name,) if isinstance(op_name, str) else tuple(op_name)
    return any(n in names for n in ops)


def get_amp_dtype(op_name=None):
    """The low dtype of the innermost scope: None outside one, and for an
    op whose role is black."""
    st = _stack()
    if not st or (op_name is not None and _in_any(op_name, AMP_BLACK)):
        return None
    return st[-1]


def _one(out):
    return out if len(out) > 1 else out[0]


def white_cast(*tensors, op_name=None):
    """Cast a white op's floating inputs (``op_name``: its name or alias
    names) to the scope's low dtype; outside a scope they pass
    unchanged."""
    d = get_amp_dtype(op_name)
    if d is None:
        return _one(tensors)
    return _one(tuple(a.to(d) if isinstance(a, torch.Tensor)
                      and a.is_floating_point() else a for a in tensors))


def black_cast(*tensors, op_name=None):
    """Cast a black op's bf16/fp16 inputs up to fp32 inside a scope."""
    if not _stack() or (op_name is not None
                        and not _in_any(op_name, AMP_BLACK)):
        return _one(tensors)
    return _one(tuple(a.float() if isinstance(a, torch.Tensor)
                      and a.dtype in _LOW else a for a in tensors))


amp_decorate = decorate


class GradScaler:
    """Dynamic loss scaling (JAX's ``amp.GradScaler``; module
    docstring). ``state_dict`` keeps the scale and the good and bad step
    counts under JAX's keys."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Every gradient times 1 / scale (in fp32, stored back in its
        dtype); records whether any is inf or NaN (one host read)."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale
        bad = None
        for p in optimizer._param_list:
            if p.grad is None:
                continue
            g = p.grad.float() * inv
            b = (~torch.isfinite(g)).any()
            bad = b if bad is None else bad | b
            p.grad.copy_(g.to(p.grad.dtype))
        plan = getattr(optimizer, "_shard_plan", None)
        if bad is None:
            bad = torch.zeros((), dtype=torch.bool)
        self._found_inf = plan.any_nonfinite(bad) if plan is not None \
            else bool(bad)
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update_scale()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        pass  # the scale moves in step(), as in JAX; kept for the API

    def _update_scale(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)

    set_state_dict = load_state_dict
