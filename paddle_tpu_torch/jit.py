"""The training and evaluation steps of the port.

Counterpart of ``paddle_tpu/jit/__init__.py`` ``TrainStep`` and
``EvalStep``. The JAX step is one jitted program (forward,
``value_and_grad``, the optimizer's functional update) compiled once per
batch signature (structure, shapes and dtypes: jit's cache key), and
``run_steps`` scans n steps in one program so that no host round trip
falls between them. Here the step is PyTorch's idiom — forward,
``loss.backward()``, ``optimizer.step()``, clear the gradients — and on
the card it is one CUDA graph per batch signature
(:class:`~paddle_tpu_torch.graphs.CapturedProgram`):

- the first call with a new signature copies the batch into static
  input tensors and runs one real step on a side stream (the warm-up,
  which makes the optimizer's states and fp32 masters; it counts as a
  step, so n calls are n optimizer steps), then captures the next step
  into a graph over those static tensors (capture does not execute);
- each later call copies the batch into the static inputs (one
  device-to-device copy for a batch already on the card), writes
  ``get_lr()`` into the optimizer's lr tensor, replays the graph and
  returns the loss from a static output. The optimizer increments its
  device step tensor inside the graph, so each replay has its own bias
  corrections; the host mirror of the step moves with each replay.

The graphs of one step share one memory pool: they never run at once,
and everything a step allocates inside (activations, the gradients that
``clear_grad`` drops at its end) dies within it. There is no switch
that turns capture off; a capture that fails raises and names the
cause. On the CPU the same step runs eagerly, and so does the step of a
model split over an mp process group of more than one rank
(``fleet.distributed_model``): its forward and backward run collectives
of the process group, which a CUDA graph cannot hold (gloo stages them
through host memory); ``TrainStep.eager_reason`` says so, and the first
such call warns."""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch

from . import ops
from .graphs import CapturedProgram

__all__ = ["TrainStep", "EvalStep"]


# ---------------------------------------------------------------------------
# batches and outputs as (structure, tensor leaves)
# ---------------------------------------------------------------------------

def _flatten(tree, leaves: list):
    """The structure of ``tree`` (tuples, lists and dicts), its tensor
    and numpy leaves appended to ``leaves`` in order; any other leaf is
    part of the structure (a constant of the program)."""
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(t, leaves) for t in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves))
                            for k, v in tree.items()))
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    return ("const", tree)


def _unflatten(structure, leaves):
    """The inverse of :func:`_flatten` over an iterator of leaves."""
    if structure is None:
        return next(leaves)
    kind, body = structure
    if kind == "const":
        return body
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in body}
    return kind(_unflatten(s, leaves) for s in body)


def _on_device(batch, device):
    """``batch`` with its tensor and numpy leaves as tensors on
    ``device`` (the eager route)."""
    leaves = []
    structure = _flatten(batch, leaves)
    return _unflatten(structure, iter([t.to(device) for t in leaves]))


def _signature(structure, leaves):
    """The program's cache key: the structure (with its constants) and
    each tensor leaf's shape and dtype."""
    return structure, tuple((tuple(t.shape), t.dtype) for t in leaves)


class _Program:
    """One captured program: its static input and output tensors (all
    outside the graph's pool), the structure of its outputs, and the
    graph."""

    def __init__(self, inputs, structure, device, pool, name, body):
        self.inputs = inputs
        self.batch = _unflatten(structure, iter(inputs))
        self.outputs = None
        self.out_structure = None
        self.body = body
        self.program = CapturedProgram(self._run, device, pool=pool,
                                       name=name)

    def _run(self):
        leaves = []
        structure = _flatten(self.body(self.batch), leaves)
        if self.outputs is None:        # the warm-up: allocate them here
            self.outputs = [t.clone() for t in leaves]
            self.out_structure = structure
        else:                           # the capture
            for s, t in zip(self.outputs, leaves):
                s.copy_(t)

    def load(self, leaves):
        for s, t in zip(self.inputs, leaves):
            s.copy_(t)

    def result(self):
        """The outputs as the body returned them, copied out of the
        static tensors (the next replay overwrites those)."""
        return _unflatten(self.out_structure,
                          iter([t.clone() for t in self.outputs]))


def _make_program(programs: dict, batch, device, pool, name, body):
    """The program of ``batch``'s signature from ``programs`` as
    ``(program, new)``; a new one holds the batch in fresh static
    tensors, has run its warm-up (its outputs are the first call's
    result) and is captured."""
    leaves = []
    structure = _flatten(batch, leaves)
    key = _signature(structure, leaves)
    prog = programs.get(key)
    if prog is not None:
        prog.load(leaves)
        return prog, False
    inputs = [t.to(device, copy=True) for t in leaves]
    prog = _Program(inputs, structure, device, pool, name, body)
    prog.program.capture()
    prog.body = None            # the graph replays without it (no cycle)
    # the warm-up was real work: its launches stay counted
    ops.add_launch_counts(prog.program.warmup_launches)
    programs[key] = prog
    return prog, True


def _drop_module_graphs(model: torch.nn.Module) -> None:
    """Detach every tensor that a module keeps as a plain attribute from
    its last forward (``MoELayer.l_aux``): such a tensor keeps that
    forward's autograd graph alive, and with it the parameters'
    gradient accumulators on the stream that forward ran on, which a
    captured backward would then have to join (on the default stream,
    capture fails)."""
    for module in model.modules():
        for name, value in vars(module).items():
            if isinstance(value, torch.Tensor) and value.grad_fn is not None:
                setattr(module, name, value.detach())


# ---------------------------------------------------------------------------
# TrainStep
# ---------------------------------------------------------------------------

class TrainStep:
    """``step = TrainStep(model, loss_fn, opt); loss = step(batch)``.
    ``loss_fn(model, batch)`` returns the loss, or a tuple whose first
    item is the loss; then the call returns ``(loss, *aux)`` as JAX's
    does. ``batch`` is a tuple, list or dict of tensors and numpy
    arrays; numpy arrays become tensors on the model's device, and
    nothing is ever moved off it. On the card each batch signature is
    one CUDA graph (module docstring); ``captures`` counts them and
    ``graph_bytes`` is the device memory their shared pool took."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.last_loss = None
        self._programs = {}
        self._pool = None
        self._warned = False

    @property
    def eager_reason(self) -> Optional[str]:
        """Why the step cannot be captured on the card, or None: a
        module of the model runs collectives of an mp process group."""
        for m in self.model.modules():
            group = getattr(m, "mp_group", None)
            if group is not None and group.nranks > 1:
                return (f"the model is split over an mp process group of "
                        f"{group.nranks} ranks; its collectives cannot sit "
                        "inside a CUDA graph, so the step runs eagerly")
        return None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def captures(self) -> int:
        return sum(p.program.captures for p in self._programs.values())

    @property
    def graph_bytes(self) -> int:
        return sum(p.program.graph_bytes for p in self._programs.values())

    def _step(self, batch):
        """One eager step (forward, backward, update, gradients
        dropped): ``(loss,)`` or ``(loss, *aux)``, detached."""
        _drop_module_graphs(self.model)
        opt = self.optimizer
        opt.clear_grad()
        out = self.loss_fn(self.model, batch)
        loss, aux = (out[0], out[1:]) if isinstance(out, tuple) \
            else (out, ())
        loss.backward()
        opt.step()
        opt.clear_grad()
        return tuple(t.detach() if isinstance(t, torch.Tensor) else t
                     for t in (loss, *aux))

    def _steps(self, batch, n_steps: int):
        """``n_steps`` steps on ``batch``; the last one's outputs."""
        reason = self.eager_reason
        if self.device.type != "cuda" or reason:
            if reason and self.device.type == "cuda" and not self._warned:
                warnings.warn(f"TrainStep: {reason}", RuntimeWarning,
                              stacklevel=3)
                self._warned = True
            batch = _on_device(batch, self.device)
            for _ in range(n_steps):
                out = self._step(batch)
            return out
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog, new = _make_program(self._programs, batch, self.device,
                                  self._pool, "the training step",
                                  self._step)
        replays = n_steps - 1 if new else n_steps
        if replays:
            # the lr once a dispatch, as JAX's run_steps reads it
            self.optimizer.write_lr()
            for _ in range(replays):
                prog.program()
            self.optimizer._step_count += replays
        return prog.result()

    def _finish(self, out):
        """Read the loss on the host (``last_loss``: one sync a call)
        and return ``loss`` or ``(loss, *aux)``."""
        self.last_loss = float(out[0])
        return out if len(out) > 1 else out[0]

    def __call__(self, batch):
        """One optimizer step; returns the (detached) loss, or
        ``(loss, *aux)``. The call ends by reading the loss on the host
        (``last_loss``)."""
        return self._finish(self._steps(batch, 1))

    def run_steps(self, batch, n_steps: int):
        """``n_steps`` optimizer steps on ``batch`` with no host read
        between them (n replays of the step's graph on the card); the lr
        is read once, as in JAX's ``run_steps``. Returns the last step's
        loss (and aux) and reads the loss once."""
        if n_steps < 1:
            raise ValueError(f"run_steps: n_steps must be >= 1, got "
                             f"{n_steps}")
        return self._finish(self._steps(batch, n_steps))

    def lower(self, batch):
        raise NotImplementedError(
            "TrainStep.lower (the ahead-of-time export of the step and "
            "its memory precheck) is not ported: ROADMAP.md A.9")


# ---------------------------------------------------------------------------
# EvalStep
# ---------------------------------------------------------------------------

class EvalStep:
    """``(batch) -> outputs`` of ``fn(model, batch)`` (default
    ``model(batch)``) with the model in eval mode under
    ``torch.no_grad()``, its training mode restored after. On the card
    each batch signature is one CUDA graph, its outputs copied out of
    static buffers; on the CPU the function runs eagerly."""

    def __init__(self, model: torch.nn.Module, fn: Optional[Callable] = None):
        self.model = model
        self.fn = fn or (lambda m, b: m(b))
        self._programs = {}
        self._pool = None

    @property
    def captures(self) -> int:
        return sum(p.program.captures for p in self._programs.values())

    def _eval(self, batch):
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return self.fn(self.model, batch)
        finally:
            self.model.train(was_training)

    def __call__(self, batch):
        device = next(self.model.parameters()).device
        if device.type != "cuda":
            return self._eval(_on_device(batch, device))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        prog, new = _make_program(self._programs, batch, device, self._pool,
                                  "the evaluation step", self._eval)
        if not new:
            prog.program()
        return prog.result()
