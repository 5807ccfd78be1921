"""The model-parallel (mp) communication of a training forward, with
autograd.

The reference's ``fleet/layers/mpu/mp_ops.py`` pair and its relatives,
as ``torch.autograd.Function``\\ s over a process group (the mp group of
``fleet.init``, ``distributed.communication``). The JAX package has no
such functions: its layers carry partition specs and GSPMD inserts the
same collectives (``paddle_tpu/distributed/fleet/meta_parallel.py``).

- :func:`c_identity`: identity forward, all-reduce of the gradient
  backward. It goes in front of a column-split product, whose input is
  replicated and whose local product gives each rank a partial input
  gradient.
- :func:`mp_allreduce`: all-reduce forward, identity backward. It comes
  after a row-split product (the partial sums of the output) and after
  the masked lookup of a vocabulary-split embedding.
- :func:`split` / :func:`gather`: this rank's slice of a replicated
  tensor along an axis, and the concatenation of every rank's slice;
  each is the other's backward.
- :func:`vocab_parallel_embedding` and :func:`parallel_cross_entropy`:
  the lookup and the softmax cross-entropy over a vocabulary split in
  equal contiguous slices, rank r holding rows ``[r V/n, (r+1) V/n)``.

Every function is the identity (no collective, no autograd node) when
the group is None or has one member, so a model with no mp group runs
as it did. A sum's order is the group's own: gloo's ring, or the rank
order of the store route (JAX's ``_reduce_terms``); a sum of two terms
does not depend on its order. Reductions run in the tensor's dtype, as
XLA's all-reduce runs in its operand's.

:func:`mp_stats` counts this process's mp collectives (calls by kind,
bytes, and the seconds they held the host, the device synchronized on
either side so compute queued before them is not counted)."""
from __future__ import annotations

import time

import torch

from .. import communication as C

__all__ = ["c_identity", "mp_allreduce", "split", "gather",
           "vocab_parallel_embedding", "parallel_cross_entropy",
           "mp_degree", "mp_stats", "reset_mp_stats"]

_STATS = {"all_reduce": 0, "all_gather": 0, "bytes": 0, "seconds": 0.0}


def mp_stats() -> dict:
    """The mp collectives since :func:`reset_mp_stats`: ``all_reduce``
    and ``all_gather`` calls, the bytes of their tensors and the
    seconds they took."""
    return dict(_STATS)


def reset_mp_stats():
    _STATS.update(all_reduce=0, all_gather=0, bytes=0, seconds=0.0)


def mp_degree(group) -> int:
    return group.nranks if group is not None else 1


def _sync(t: torch.Tensor):
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _all_reduce(t: torch.Tensor, group, op=C.ReduceOp.SUM) -> torch.Tensor:
    """``t`` (contiguous, owned) all-reduced in place over ``group``."""
    _sync(t)
    t0 = time.perf_counter()
    C.all_reduce(t, op=op, group=group)
    _sync(t)
    _STATS["all_reduce"] += 1
    _STATS["bytes"] += t.numel() * t.element_size()
    _STATS["seconds"] += time.perf_counter() - t0
    return t


def _all_gather(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    """Every member's ``t`` concatenated along ``axis`` in group-rank
    order."""
    _sync(t)
    t0 = time.perf_counter()
    parts = []
    C.all_gather(parts, t.contiguous(), group=group)
    out = torch.cat([p.to(t.device) for p in parts], dim=axis)
    _sync(t)
    _STATS["all_gather"] += 1
    _STATS["bytes"] += t.numel() * t.element_size()
    _STATS["seconds"] += time.perf_counter() - t0
    return out


def _piece(t: torch.Tensor, group, axis: int) -> torch.Tensor:
    n, r = group.nranks, group.rank
    if t.shape[axis] % n:
        raise ValueError(f"axis {axis} of a {tuple(t.shape)} tensor does "
                         f"not split into {n} equal slices")
    k = t.shape[axis] // n
    return t.narrow(axis, r * k, k).contiguous()


class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _MPAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _piece(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.axis), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _all_gather(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.group, ctx.axis), None, None


def _active(group) -> bool:
    return group is not None and group.nranks > 1


def c_identity(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over ``group``."""
    return _CIdentity.apply(x, group) if _active(group) else x


def mp_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of every member's ``x``; the gradient
    passes through unchanged."""
    return _MPAllReduce.apply(x, group) if _active(group) else x


def split(x: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """This member's slice (group-rank order) of ``x`` along ``axis``;
    the gradient is the all-gather of the slices' gradients."""
    return _Split.apply(x, group, axis % x.dim()) if _active(group) else x


def gather(x: torch.Tensor, group, axis: int = -1) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``axis`` (group-rank
    order); the gradient is this member's slice of it."""
    return _Gather.apply(x, group, axis % x.dim()) if _active(group) \
        else x


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor,
                             group) -> torch.Tensor:
    """The rows of ``ids`` in a table split by row over ``group``
    (``weight`` this member's ``(V/n, D)`` slice): each member looks up
    the ids in its slice, zeros the others, and the members' results
    are summed (:func:`mp_allreduce`). Every id's row comes from one
    member and the rest add exact zeros, so the sum is the whole
    table's lookup bit for bit."""
    if not _active(group):
        return torch.nn.functional.embedding(ids, weight)
    rows = weight.shape[0]
    local = ids.long() - group.rank * rows
    outside = (local < 0) | (local >= rows)
    out = torch.nn.functional.embedding(local.masked_fill(outside, 0),
                                        weight)
    out = out.masked_fill(outside.unsqueeze(-1), 0.0)
    return mp_allreduce(out, group)


def parallel_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                           group, ignore_index: int = -100
                           ) -> torch.Tensor:
    """Per-token softmax cross-entropy (``reduction="none"``) over
    logits split along their last (class) axis over ``group``, this
    member holding classes ``[r C/n, (r+1) C/n)``: the max, then the sum
    of exponentials, then the label's logit, each all-reduced, so the
    loss equals ``cross_entropy`` over the whole logits. Computed in
    fp32; tokens whose label is ``ignore_index`` give 0. The max is a
    constant of the gradient (the log-sum-exp does not depend on it)."""
    x = logits.float()
    lab = label.long()
    if lab.dim() == x.dim():
        lab = lab.squeeze(-1)
    if not _active(group):
        from ...nn.functional import cross_entropy
        return cross_entropy(x, lab, ignore_index=ignore_index,
                             reduction="none")
    cols = x.shape[-1]
    m = _all_reduce(x.detach().amax(dim=-1).contiguous(), group,
                    C.ReduceOp.MAX)
    s = mp_allreduce(torch.exp(x - m.unsqueeze(-1)).sum(dim=-1), group)
    local = lab - group.rank * cols
    inside = (local >= 0) & (local < cols)
    picked = x.gather(-1, local.clamp(0, cols - 1).unsqueeze(-1)
                      ).squeeze(-1)
    tgt = mp_allreduce(torch.where(inside, picked, torch.zeros_like(picked)),
                       group)
    loss = torch.log(s) + m - tgt
    return torch.where(lab != ignore_index, loss, torch.zeros_like(loss))
