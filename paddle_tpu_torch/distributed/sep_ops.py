"""The sequence-parallel (sep) communication of a training step, with
autograd.

Each rank of a sep group (``fleet.init(sep_degree=S)``) holds the
contiguous piece ``[r s/S, (r+1) s/S)`` of every sequence. The JAX
package binds the ``"sep"`` mesh axis inside ``shard_map``
(``paddle_tpu/distributed/context_parallel.py``), where ``ppermute`` and
``all_to_all`` transpose into their reverse, and GSPMD gathers what the
megatron layout needs; here each exchange is a
``torch.autograd.Function`` over the process group
(``distributed.communication``):

- :func:`ring_pass`: the pieces a tensor takes around the ring, S - 1
  hops (each this rank's current piece to the next rank, the previous
  rank's in return: tagged p2p, ``batch_isend_irecv``); the gradient
  takes the reverse hops. One autograd node holds the whole pass and
  returns this rank's own piece first, so its backward runs on every
  rank even where no hopped piece is used (rank 0 of a causal ring):
  a rank that skipped it would leave its neighbours' reverse hops
  waiting. Every rank issues its sends and receives in one order (nccl
  ignores tags).
- :func:`all_to_all`: ``split_axis`` cut in S chunks, chunk j to rank j,
  the received chunks joined along ``concat_axis`` in rank order (JAX's
  ``all_to_all(tiled=True)``); the gradient is the inverse all-to-all.
  It is ``communication.alltoall_single``: on gloo and nccl one
  ``torch.distributed.all_to_all_single`` (each rank sends each other
  rank its chunk only); the store route gathers every rank's list.
- :func:`seq_all_gather`: every rank's piece joined along ``axis``; the
  gradient is the reduce-scatter of the pieces' gradients (each rank's
  piece gets the sum of every rank's), in fp32. It differs from
  ``mp_ops.gather``, whose gradient keeps only this rank's slice, which
  is right only when the work after the gather is replicated.
- :func:`sep_allreduce`: the sum over the group forward, the gradient
  unchanged (the whole sequence's loss from every rank's sum; each
  rank's backward then holds its own tokens' share of the gradient).
- :func:`sum_gradients_after_backward`: marks a model's outputs so that
  the end of their backward sums every parameter's gradient over the
  group (one fp32 all-reduce a bucket,
  ``collectives.bucketing.allreduce_sum_``): the parameters are
  replicated over sep and each rank's backward holds only its tokens'
  share. Gradients a parameter held before the backward
  (an accumulation) are set aside and added back after the sum.

Every function is the identity when the group is None or has one
member. :func:`sep_stats` counts this process's sep collectives by kind
(calls, bytes of the tensors handed in, and the seconds they held the
host less those of gloo's staging copies, which also wait for the
compute queued before them: what is left is the wait for the peers, as
``pipeline.pipeline_stats`` counts it). Nothing synchronizes the device
to count: on nccl a collective's seconds are its launch's."""
from __future__ import annotations

import time

import torch

from . import communication as C

__all__ = ["sep_degree", "ring_pass", "all_to_all", "seq_all_gather",
           "sep_allreduce", "sum_gradients_after_backward", "sep_stats",
           "reset_sep_stats"]

_KINDS = ("hop", "all_to_all", "all_gather", "reduce_scatter",
          "all_reduce", "grad_sum")
_STATS = {k: {"calls": 0, "bytes": 0, "seconds": 0.0} for k in _KINDS}
# the ring's p2p tags: hop t of a pass takes _HOP_TAG + 2t, its reverse
# _HOP_TAG + 2t + 1
_HOP_TAG = 7000


def sep_stats() -> dict:
    """The sep collectives since :func:`reset_sep_stats`, by kind
    (``hop``, ``all_to_all``, ``all_gather``, ``reduce_scatter``,
    ``all_reduce``, ``grad_sum``): ``{"calls", "bytes", "seconds"}``."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_sep_stats():
    for v in _STATS.values():
        v.update(calls=0, bytes=0, seconds=0.0)


def sep_degree(group) -> int:
    """The size of the sep ``group`` (1 without one)."""
    return group.nranks if group is not None else 1


def _active(group) -> bool:
    return group is not None and group.nranks > 1


def _timed(kind: str, t: torch.Tensor, fn, nbytes=None):
    """``fn()`` counted under ``kind`` with ``t``'s bytes (or
    ``nbytes``) and its host seconds less the staging copies' (module
    docstring)."""
    before = C.stage_stats()
    t0 = time.perf_counter()
    out = fn()
    after = C.stage_stats()
    copies = sum(after[k] - before[k] for k in ("d2h_s", "h2d_s"))
    s = _STATS[kind]
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size() if nbytes is None \
        else nbytes
    s["seconds"] += time.perf_counter() - t0 - copies
    return out


def _hop(x: torch.Tensor, group, tag: int, forward: bool) -> torch.Tensor:
    """``x`` to the next rank of the ring (the previous one when not
    ``forward``), the other neighbour's ``x`` in return."""
    S, r = group.nranks, group.rank
    nxt, prv = group.ranks[(r + 1) % S], group.ranks[(r - 1) % S]
    dst, src = (nxt, prv) if forward else (prv, nxt)
    x = x.contiguous()
    out = torch.empty_like(x)

    def run():
        for task in C.batch_isend_irecv(
                [C.P2POp(C.isend, x, dst, group, tag),
                 C.P2POp(C.irecv, out, src, group, tag)]):
            task.wait()
        return out
    return _timed("hop", x, run)


class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        pieces = [x.view_as(x)]
        for t in range(group.nranks - 1):
            pieces.append(_hop(pieces[-1], group, _HOP_TAG + 2 * t, True))
        return tuple(pieces)

    @staticmethod
    def backward(ctx, *grads):
        # piece t + 1 is hop t of piece t: its gradient goes back the
        # reverse hop and adds to piece t's
        acc = grads[-1]
        for t in range(len(grads) - 2, -1, -1):
            acc = grads[t] + _hop(acc, ctx.group, _HOP_TAG + 2 * t + 1,
                                  False)
        return acc, None


def ring_pass(x: torch.Tensor, group) -> tuple:
    """``(x, x of rank r - 1, ..., x of rank r - S + 1)``: the pieces
    this rank holds at each step of a pass of ``x`` around the ring of
    ``group`` (module docstring). The gradient takes the reverse hops."""
    if not _active(group):
        return (x,)
    return _RingPass.apply(x, group)


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int
         ) -> torch.Tensor:
    S = group.nranks
    if x.shape[split_axis] % S:
        raise ValueError(f"all_to_all: axis {split_axis} of a "
                         f"{tuple(x.shape)} tensor does not split into {S}")

    def run():
        got = C.alltoall_single(torch.stack(x.chunk(S, split_axis)),
                                group=group)
        return torch.cat(got.unbind(0), dim=concat_axis)
    return _timed("all_to_all", x, run)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _a2a(g, ctx.group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int
               ) -> torch.Tensor:
    """JAX's ``all_to_all(x, split_axis, concat_axis, tiled=True)`` over
    ``group`` (module docstring); the gradient is the inverse."""
    if not _active(group):
        return x
    return _AllToAll.apply(x, group, split_axis % x.dim(),
                           concat_axis % x.dim())


def _gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    def run():
        parts = []
        C.all_gather(parts, x.contiguous(), group=group)
        return torch.cat([p.to(x.device) for p in parts], dim=axis)
    return _timed("all_gather", x, run)


def _reduce_scatter(g: torch.Tensor, group, axis: int) -> torch.Tensor:
    """This rank's piece along ``axis`` of the sum over ``group`` of
    every rank's ``g``, summed in fp32."""
    S, r = group.nranks, group.rank
    parts = g.chunk(S, axis)

    def run():
        inp = torch.cat([p.reshape(-1).float() for p in parts])
        out = torch.empty(inp.numel() // S, dtype=torch.float32,
                          device=g.device)
        C._reduce_scatter_flat(out, inp, group).wait()
        return out.view(parts[r].shape).to(g.dtype)
    return _timed("reduce_scatter", g, run)


class _SeqAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.group, ctx.axis), \
            None, None


def seq_all_gather(x: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``axis`` in group-rank order; the
    gradient is the reduce-scatter of it (module docstring)."""
    if not _active(group):
        return x
    return _SeqAllGather.apply(x, group, axis % x.dim())


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (owned, contiguous) summed in place over ``group``."""
    return _timed("all_reduce", t,
                  lambda: C.all_reduce(t, op=C.ReduceOp.SUM, group=group))


class _SepAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sep_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x``; the gradient passes
    unchanged."""
    return _SepAllReduce.apply(x, group) if _active(group) else x


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over ``group`` outside autograd (the
    losses' sums and counts inside a fused head's forward)."""
    return _all_reduce(t, group) if _active(group) else t


class _GradSum:
    """The state of one model's end-of-backward sum (module docstring):
    armed by the first marked output a backward reaches, run once by the
    callback it queues on the backward engine."""

    def __init__(self, module, group):
        self.module, self.group = module, group
        self.held = None

    def begin(self):
        if self.held is not None:
            return
        self.held = {}
        for p in self.module.parameters():
            if p.grad is not None:
                self.held[p] = p.grad
                p.grad = None
        torch.autograd.Variable._execution_engine.queue_callback(self.finish)

    def finish(self):
        from .collectives.bucketing import allreduce_sum_
        held, self.held = self.held, None
        grads = [p.grad for p in self.module.parameters()
                 if p.grad is not None]
        if grads:
            _timed("grad_sum", grads[0],
                   lambda: allreduce_sum_(grads, self.group),
                   sum(g.numel() * g.element_size() for g in grads))
        for p, g in held.items():
            p.grad = g if p.grad is None else p.grad + g


class _MarkGradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, state):
        ctx.state = state
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.state.begin()
        return g, None


def sum_gradients_after_backward(out, state: _GradSum):
    """``out`` (a tensor, or a tuple or list of them) with every tensor
    that requires grad marked: the backward through any of them sums the
    parameters' gradients over the group once it has ended."""
    if isinstance(out, torch.Tensor):
        return _MarkGradSum.apply(out, state) if out.requires_grad else out
    if isinstance(out, (tuple, list)):
        return type(out)(sum_gradients_after_backward(t, state)
                         for t in out)
    return out
