"""The tensor-parallel hooks of the serving forward.

Counterpart of ``paddle_tpu/utils/tp_hooks.py``. The JAX model calls
these hooks at four sites of its cache-path forward (in front of o_proj
and down_proj, after them, and on the logits); outside a sharded trace
they are no-ops, so the same model code serves one chip and a mesh.

The port keeps the sites and the names. Its model writes the cache-path
forward as a generator (``models/llama.py``) that yields at each site
``(hook, shard tensor, *args)`` and resumes with the hook's result. One
controller drives that forward:

- :func:`run_local` runs one generator (an unsharded model): each hook
  gets a one-shard list and hands it back unchanged, as outside a
  sharded trace;
- :func:`run_shards` (``serving.tp``) steps one generator per shard in
  lockstep, in mesh linear-index order, and at each site calls the hook
  on the list of every shard's tensor: the collective a JAX
  ``shard_map`` program runs at that site. Each shard resumes with its
  own element of the result.

The hooks take and return that list. The serving hooks act only while
a :class:`TPSpec` is :func:`active`; ``serving/tp.py`` arms it around
every sharded run.

The training route of a model split over an mp process group
(``fleet.distributed_model``: one process a rank, each running its own
slice) yields its own hooks with its group: :func:`mp_reduce`
(``mp_allreduce``, ``distributed/fleet/mp_ops.py``) at the sites behind
o_proj and down_proj, in place of :func:`maybe_reduce`, and
:func:`mp_copy_in` (``c_identity``) at one more site in front of each
pair of column-split products. A model with no mp group yields what it
always did.
This module lives in ``utils`` because the model imports it and must
not import the serving package."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

__all__ = ["TPSpec", "current_tp", "active", "maybe_gather",
           "maybe_gather_logits", "maybe_reduce", "mp_copy_in", "mp_reduce",
           "run_local", "run_shards"]


@dataclasses.dataclass(frozen=True)
class TPSpec:
    """What a sharded run needs to know: the hierarchical collective plan
    over the TP mesh axes, the shard degree, the weight layout
    (``"exact"`` | ``"psum"``), and whether the psum-mode hidden-state
    all-reduce rides the int8 wire format."""
    plan: object          # distributed.collectives.HierarchyPlan
    degree: int
    mode: str
    int8: bool


_ACTIVE: List[TPSpec] = []
_BOUND_SINK: Optional[list] = None   # armed by serving/tp.py's bound probe


def current_tp() -> Optional[TPSpec]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def active(spec: TPSpec):
    _ACTIVE.append(spec)
    try:
        yield
    finally:
        _ACTIVE.pop()


def _gather_last_dim(ts, plan):
    """All-gather the shards of the LAST dim (chunks in linear-index
    order over the plan's axes, the column shards' layout). Pure data
    movement: exact."""
    from ..distributed.collectives.hierarchical import hier_all_gather
    moved = [t.movedim(-1, 0) for t in ts]
    return [t.movedim(0, -1) for t in hier_all_gather(moved, plan)]


def maybe_gather(ts, full_width: int):
    """Exact-mode gather in front of a replicated row-parallel weight
    (attention heads before o_proj, the MLP activation before
    down_proj). No-op when TP is off, the tensors are already full width
    (the layer is not sharded), or the mode is psum (the row-parallel
    reduce follows instead)."""
    spec = current_tp()
    if spec is None or spec.mode != "exact" or \
            ts[0].shape[-1] == full_width:
        return ts
    return _gather_last_dim(ts, spec.plan)


def maybe_gather_logits(ts, vocab_size: int):
    """The final-logits all-gather (both modes): vocab-sharded lm_head
    shards -> full logits on every shard. No-op for full-width logits
    (a tied head reads the replicated embedding)."""
    spec = current_tp()
    if spec is None or ts[0].shape[-1] == vocab_size:
        return ts
    return _gather_last_dim(ts, spec.plan)


def mp_copy_in(ts, group):
    """The training route's ``c_identity`` in front of the column-split
    products of a model split over the mp process group ``group``:
    identity forward, the gradient all-reduced."""
    from ..distributed.fleet.mp_ops import c_identity
    return [c_identity(t, group) for t in ts]


def mp_reduce(ts, group):
    """The training route's ``mp_allreduce`` behind the row-split
    products (o_proj, down_proj) of a model split over the mp process
    group ``group``: the partial sums all-reduced, the gradient passed
    through."""
    from ..distributed.fleet.mp_ops import mp_allreduce
    return [mp_allreduce(t, group) for t in ts]


def maybe_reduce(ts):
    """Psum-mode hidden-state all-reduce behind a row-sharded weight
    (o_proj / down_proj partial sums). With ``int8`` it rides the
    EQuARX wire format; while the bound probe has ``_BOUND_SINK`` armed,
    each hop also appends its runtime error bound there."""
    spec = current_tp()
    if spec is None or spec.mode != "psum":
        return ts
    from ..distributed.collectives.hierarchical import hier_all_reduce
    from ..distributed.collectives.quantized import quantized_all_reduce
    if not spec.int8:
        return hier_all_reduce(ts, spec.plan)
    if _BOUND_SINK is not None:
        out, bound = quantized_all_reduce(ts, spec.plan,
                                          return_error_bound=True)
        _BOUND_SINK.append(bound)
        return out
    return quantized_all_reduce(ts, spec.plan)


def run_local(gen):
    """Run one cache-path forward generator to its result, handing each
    hook a one-shard list (an unsharded model: every hook is the
    identity there)."""
    value = None
    try:
        while True:
            hook, t, *args = gen.send(value)
            value = hook([t], *args)[0]
    except StopIteration as stop:
        return stop.value


def run_shards(gens, enter=None):
    """Step one forward generator per shard in lockstep and return each
    shard's result. At every site all shards must yield the same hook;
    it runs once, on the list of their tensors. ``enter(s)`` (optional)
    is a context manager each shard's step runs under (``serving.tp``
    uses it to put a shard's work on its device's stream)."""
    values = [None] * len(gens)
    while True:
        yielded, done = [], []
        for s, gen in enumerate(gens):
            ctx = enter(s) if enter is not None else contextlib.nullcontext()
            with ctx:
                try:
                    yielded.append(gen.send(values[s]))
                except StopIteration as stop:
                    done.append(stop.value)
        if done:
            if len(done) != len(gens):
                raise RuntimeError("shards of one forward left it at "
                                   "different sites")
            return done
        hook, _, *args = yielded[0]
        if any(y[0] is not hook for y in yielded):
            raise RuntimeError("shards of one forward yielded different "
                               "hooks")
        values = hook([y[1] for y in yielded], *args)
