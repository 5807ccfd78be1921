"""Pipeline parallelism over the pp process group.

Counterpart of ``paddle_tpu/distributed/pipeline.py``, with its names.
The JAX package runs every stage in one XLA program: the stage weights
are stacked on a leading axis sharded over the ``"pp"`` mesh axis, and a
``lax.scan`` over ticks hands each activation to the next stage with a
``ppermute``. The port runs one stage a process: stage s is the rank at
coordinate s of fleet's pp process group (``fleet.init(pp_degree=S)``),
holds only its stage's parameters, and hands each microbatch's
activation to the next stage with a tagged send over the process group
(``communication.send``/``recv``; on gloo a CUDA tensor is staged
through pinned host memory).

The schedules are JAX's:

- :func:`pipeline_spmd` is FThenB: stage s runs microbatch m at tick
  m + s; a step is M forward ticks, then the M backward ticks in reverse
  order, T = M + S - 1 ticks each way (bubble (S-1)/(M+S-1)).
- :func:`pipeline_spmd_interleaved` is the interleaved (VPP) schedule:
  stage s holds V chunks, global chunks {s, S+s, ..., (V-1)S+s};
  microbatch m enters at tick (m//S)VS + m%S and makes V laps of the
  ring, one chunk a hop; T = MV + S - 1 (bubble (S-1)/(MV+S-1)). M must
  be a multiple of S, as in JAX.

A stage runs its work items (microbatch, hop) in tick order in the
forward and in reverse tick order in the backward, each item's backward
an explicit ``torch.autograd.backward`` of that item's output with the
gradient the next stage sent back. Every dependency of an item lies at
an earlier tick (forward) or a later one (backward), so the stages
never wait on each other in a cycle; the tags ((direction, hop,
microbatch)) keep one microbatch's tensor from being taken for
another's on gloo. On nccl, which ignores tags, the order alone pairs
them: both stages of a pair make its hops in the same tick order. The
whole schedule is one autograd node of the caller's
graph (``_PipelineFn``): ``loss.backward()`` on every rank runs the
backward schedule, so a training loop does not change.

A parameter's gradient is the sum of its items' gradients, added in the
backward's order (microbatches from last to first), so a stage's
gradients are bit-identical to those of one rank that runs the same
microbatches through the whole trunk in the same order (the schedule
with no group: one stage maps the microbatches in sequence).

Outputs live on the last stage. :func:`broadcast_from_last` gives the
last stage's value to every stage of the group (JAX's outputs are
replicated); its backward takes the last stage's gradient only (the
other stages hold replicas of one value), and on every other stage it
still runs that stage's backward schedule. :class:`PipelineParallel` is
``fleet.distributed_model``'s wrapper of a ``PipelineLayer``
(``fleet.meta_parallel``)."""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Sequence

import torch

from . import communication as C

__all__ = ["pipeline_spmd", "pipeline_spmd_interleaved",
           "split_microbatches", "merge_microbatches",
           "num_pipeline_stages", "pipeline_group", "microbatch_count",
           "broadcast_from_last", "broadcast_meta",
           "pipeline_stats", "reset_pipeline_stats", "PipelineParallel"]

_STATS = {"sends": 0, "recvs": 0, "bytes_sent": 0, "bytes_received": 0,
          "recv_wait_s": 0.0, "send_wait_s": 0.0, "broadcasts": 0,
          "broadcast_s": 0.0, "shared_allreduces": 0, "shared_s": 0.0}


def pipeline_stats() -> dict:
    """This rank's pipeline traffic since :func:`reset_pipeline_stats`:
    the hops sent and received and their bytes, the host's seconds
    waiting in receives and for the sends to be taken, and the
    broadcasts from the last stage and the shared-weight all-reduces
    with their seconds (:func:`_waited`). The schedule never
    synchronizes the device to time them. On nccl the host does not
    wait for a transfer, so its seconds are not the transfer's time."""
    return dict(_STATS)


def _waited(key: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its host seconds added to ``_STATS[key]``
    less those of gloo's staging copies, which also wait for the
    stage's queued compute (a copy to or from pinned memory ends when
    the stream has run up to it): what is left is the wait for the
    peers, and the copies count as compute."""
    before = C.stage_stats()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    after = C.stage_stats()
    copies = sum(after[k] - before[k] for k in ("d2h_s", "h2d_s"))
    _STATS[key] += time.perf_counter() - t0 - copies
    return out


def reset_pipeline_stats():
    for k in _STATS:
        _STATS[k] = 0.0 if k.endswith("_s") else 0


def pipeline_group(group=None):
    """``group``, else fleet's pp group (None without one)."""
    if group is not None:
        return group
    from .mesh import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_pipe_parallel_group() if hcg is not None else None


def num_pipeline_stages(group=None) -> int:
    """The degree of ``group`` (default fleet's pp group); 1 without
    one."""
    g = pipeline_group(group)
    return g.nranks if g is not None else 1


def microbatch_count(num_microbatches: int, batch: int) -> int:
    """JAX's clamp: the largest divisor of ``batch`` that is <=
    ``num_microbatches`` (a stage without the batch works out M from
    its size)."""
    m = max(1, min(int(num_microbatches), batch))
    while batch % m != 0:
        m -= 1
    return m


def split_microbatches(x: torch.Tensor, num_microbatches: int
                       ) -> torch.Tensor:
    """(b, ...) -> (M, b/M, ...), a view; M is
    :func:`microbatch_count`'s, as in JAX."""
    m = microbatch_count(num_microbatches, x.shape[0])
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def merge_microbatches(x_mb: torch.Tensor) -> torch.Tensor:
    return x_mb.reshape(x_mb.shape[0] * x_mb.shape[1], *x_mb.shape[2:])


def _items(S: int, V: int, M: int, s: int) -> list:
    """Stage ``s``'s work items (microbatch, hop) in tick order: JAX's
    interleaved tick math (``pipeline.py:212-219``), which at V = 1 is
    microbatch m at tick m + s. Hop k runs chunk k // S."""
    out = []
    for t in range(M * V + S - 1):
        r = (t - s) % S
        j = t - r
        if j < 0:
            continue
        q, k = divmod(j, V * S)
        m = S * q + r
        if m < M:
            out.append((m, k))
    return out


class _Run:
    """One call of a schedule on this stage: the forward over its items
    (the tensors each backward needs kept), then the backward."""

    def __init__(self, stage_fn, chunks, group, V, M, mb_shape, dtype,
                 device, remat, mb_extras, extras, finish=None):
        self.fn = stage_fn
        self.chunks = chunks            # V tuples of this stage's leaves
        self.group = group
        self.S = group.nranks if group is not None else 1
        self.s = group.rank if group is not None else 0
        self.V, self.M = V, M
        self.mb_shape, self.dtype, self.device = mb_shape, dtype, device
        self.remat = remat
        self.mb_extras = list(mb_extras)
        self.extras = tuple(extras)
        self.finish = finish
        self.saved = []
        self.flights = []

    # -- hops ---------------------------------------------------------------
    def _peer(self, delta):
        return self.group.ranks[(self.s + delta) % self.S]

    def _tag(self, direction, k, m, e=0):
        n = 1 + len(self.mb_extras)
        return ((direction * self.V * self.S + k) * self.M + m) * n + e

    def _send(self, t, delta, tag):
        t = t.detach().contiguous()
        self.flights.append(C.isend(t, self._peer(delta), self.group,
                                    tag=tag))
        _STATS["sends"] += 1
        _STATS["bytes_sent"] += t.numel() * t.element_size()

    def _recv(self, like, delta, tag):
        buf = torch.empty(like.shape, dtype=like.dtype, device=self.device)
        _waited("recv_wait_s", lambda: C.irecv(
            buf, self._peer(delta), self.group, tag=tag).wait())
        _STATS["recvs"] += 1
        _STATS["bytes_received"] += buf.numel() * buf.element_size()
        return buf

    def _drain(self):
        for fl in self.flights:
            _waited("send_wait_s", fl.wait)
        self.flights = []

    # -- the schedule -------------------------------------------------------
    def forward(self, x_mb, grad: bool):
        """Run this stage's items in tick order; the last stage returns
        the (M, mb, ...) outputs, the others None."""
        S, V, M = self.S, self.V, self.M
        last = V * S - 1
        like = torch.empty(self.mb_shape, dtype=self.dtype, device="meta")
        fn = self.fn
        if self.remat:
            def fn(*a):
                return torch.utils.checkpoint.checkpoint(
                    self.fn, *a, use_reentrant=False,
                    preserve_rng_state=False)
        outs = [None] * M
        for m, k in _items(S, V, M, self.s):
            if k == 0:
                x = x_mb[m]
                ex = [e[m] for e in self.mb_extras]
            else:
                x = self._recv(like, -1, self._tag(0, k, m))
                ex = [self._recv(e[m], -1, self._tag(0, k, m, i + 1))
                      for i, e in enumerate(self.mb_extras)]
            x = x.detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                y = fn(self.chunks[k // S], x, *ex, *self.extras)
            if k == last:
                outs[m] = y
            else:
                self._send(y, 1, self._tag(0, k + 1, m))
                for i, e in enumerate(ex):
                    self._send(e, 1, self._tag(0, k + 1, m, i + 1))
            if grad:
                self.saved.append((m, k, x, y))
        self._drain()
        if self.s != (last % S):
            return None
        return torch.stack([y.detach() for y in outs])

    def backward(self, dy_mb):
        """The items' backward in reverse tick order; returns the
        (M, mb, ...) gradient of the first stage's input (None
        elsewhere)."""
        S, V = self.S, self.V
        last = V * S - 1
        dx = [None] * self.M
        while self.saved:
            m, k, x, y = self.saved.pop()
            if k == last:
                dy = dy_mb[m]
            else:
                dy = self._recv(y, 1, self._tag(1, k, m))
            torch.autograd.backward(y, dy)
            if k > 0:
                self._send(x.grad, -1, self._tag(1, k - 1, m))
            else:
                dx[m] = x.grad
        self._drain()
        if self.s != 0:
            return None
        return torch.stack(dx)


class _PipelineFn(torch.autograd.Function):
    """The schedule as one node of the caller's graph: the forward runs
    the forward items (each its own graph over detached leaves of the
    stage's parameters), the backward runs the backward items and
    returns the input's gradient and the parameters' (each the sum of
    its items', in the backward's order)."""

    @staticmethod
    def forward(ctx, run, leaves, x_mb, *params):
        ctx.run, ctx.leaves = run, leaves
        out = run.forward(x_mb, grad=True)
        if out is None:         # a stage before the last: an anchor
            out = torch.empty(0, dtype=run.dtype, device=run.device)
        return out

    @staticmethod
    def backward(ctx, dy):
        run = ctx.run
        if run.finish is not None:
            torch.autograd.Variable._execution_engine.queue_callback(
                run.finish)
        dx = run.backward(dy if dy.numel() else None)
        grads = [_leaf_grad(ls, run.V) for ls in ctx.leaves]
        ctx.run = ctx.leaves = None
        return (None, None, dx, *grads)


def _leaf_grad(leaves, V):
    """A parameter's gradient from its leaves: the one leaf's, or the V
    chunks' stacked (None where no item reached them)."""
    gs = [lf.grad for lf in leaves]
    if any(g is None for g in gs):
        return None
    return torch.stack(gs) if V > 1 else gs[0]


def _schedule(stage_fn, stage_params, x, *, group, V, num_microbatches,
              shape, dtype, device, mb_extras=(), extras=(), remat=False,
              finish=None):
    """Run the schedule on this stage (module docstring). ``stage_params``
    are this stage's parameters: (V, ...) chunks each when ``V > 1``;
    ``x`` the (b, ...) batch on the first stage (None elsewhere),
    ``shape`` its shape on every stage. The batch runs in
    :func:`microbatch_count` microbatches, which the interleaved
    schedule needs to be a multiple of S (JAX's rules). Returns the
    (M, mb, ...) output on the last stage and, with a graph, an empty
    anchor on the others; ``finish`` runs at the end of the backward."""
    S = group.nranks if group is not None else 1
    M = microbatch_count(num_microbatches, shape[0])
    if V > 1 and M % S != 0:
        raise ValueError(
            f"interleaved schedule needs microbatches ({M}) divisible "
            f"by pp degree ({S}); pad the batch or change M")
    x_mb = split_microbatches(x, M) if x is not None else None
    mb_shape = (shape[0] // M,) + tuple(shape[1:])
    params = list(stage_params)
    grad = torch.is_grad_enabled() and (
        any(p.requires_grad for p in params)
        or (x_mb is not None and x_mb.requires_grad))
    # per parameter one detached leaf a chunk: the items' gradients add
    # up there, in the backward's order
    leaves = []
    for p in params:
        base = p.detach()
        ls = [base[v] for v in range(V)] if V > 1 else [base]
        leaves.append([lf.requires_grad_(p.requires_grad) for lf in ls])
    chunks = [tuple(ls[v] for ls in leaves) for v in range(V)]
    run = _Run(stage_fn, chunks, group, V, M, mb_shape, dtype, device,
               remat, mb_extras, extras, finish)
    if not grad:
        out = run.forward(x_mb, grad=False)
        return out if out is not None else \
            torch.empty(0, dtype=dtype, device=device)
    return _PipelineFn.apply(run, leaves, x_mb, *params)


def _as_list(stage_fn, stage_params):
    """``stage_params`` as a list, and ``stage_fn`` taking them in the
    caller's structure (one tensor, or a sequence), as JAX's takes its
    pytree."""
    if isinstance(stage_params, torch.Tensor):
        return (lambda params, *a: stage_fn(params[0], *a)), [stage_params]
    return stage_fn, list(stage_params)


def pipeline_spmd(stage_fn: Callable, stage_params,
                  x_mb: torch.Tensor, *, group=None,
                  mb_extras: Sequence[Any] = (), extras: Sequence[Any] = (),
                  remat: bool = False) -> torch.Tensor:
    """Run ``stage_fn`` as an S-stage FThenB pipeline over microbatches.

    ``stage_fn(params, x, *mb_extra_slices, *extras) -> y`` with
    ``y.shape == x.shape``; ``stage_params``: THIS stage's parameters
    (JAX's leaf ``[s]``), one tensor or a sequence of them (``params``
    has the same structure); ``x_mb``: the (M, mb, ...) input (read on the
    first stage; the others take its shape and dtype); ``mb_extras``:
    tensors with leading dim M, given to the first stage with their
    microbatch and sent along with its activation (not differentiated);
    ``extras``: given to every stage at every microbatch; ``remat``:
    each stage's body is recomputed per microbatch in the backward.
    ``group``: the pp group (default fleet's). With no group (or one of
    one rank) one stage maps every microbatch in sequence (JAX's S = 1
    path). Returns the (M, mb, ...) outputs: the last stage's, broadcast
    to every stage (:func:`broadcast_from_last`)."""
    group = pipeline_group(group)
    S = group.nranks if group is not None else 1
    if S == 1:
        group = None
    stage_fn, stage_params = _as_list(stage_fn, stage_params)
    x = merge_microbatches(x_mb)
    out = _schedule(stage_fn, stage_params,
                    x if group is None or group.rank == 0 else None,
                    group=group, V=1, num_microbatches=x_mb.shape[0],
                    shape=tuple(x.shape), dtype=x.dtype, device=x.device,
                    mb_extras=mb_extras, extras=extras, remat=remat)
    return out if group is None else broadcast_from_last(out, group)


def pipeline_spmd_interleaved(stage_fn: Callable, stage_params,
                              x_mb: torch.Tensor, *, group=None,
                              extras: Sequence[Any] = (),
                              remat: bool = False) -> torch.Tensor:
    """The interleaved (VPP) schedule (module docstring).
    ``stage_params``: this stage's parameters with leading dims (V, ...)
    — chunk v is global chunk vS + s (JAX's leaf ``[s]`` of its (S, V,
    ...) stacks); ``stage_fn(chunk_params, x, *extras)`` is
    shape-preserving. M must be a multiple of S. Without a group the
    chunks run in order on every microbatch."""
    group = pipeline_group(group)
    S = group.nranks if group is not None else 1
    stage_fn, stage_params = _as_list(stage_fn, stage_params)
    V = int(stage_params[0].shape[0])
    if any(p.shape[0] != V for p in stage_params):
        raise ValueError(f"interleaved stage parameters need a leading "
                         f"chunk dimension of {V}")
    x = merge_microbatches(x_mb)
    kw = dict(num_microbatches=x_mb.shape[0], shape=tuple(x.shape),
              dtype=x.dtype, device=x.device, extras=extras, remat=remat)
    if S == 1:
        def chunks_fn(params, h, *ex):
            for v in range(V):
                h = stage_fn(tuple(p[v] for p in params), h, *ex)
            return h
        return _schedule(chunks_fn, stage_params, x, group=None, V=1, **kw)
    out = _schedule(stage_fn, stage_params, x if group.rank == 0 else None,
                    group=group, V=V, **kw)
    return broadcast_from_last(out, group)


# ---------------------------------------------------------------------------
# the last stage's values on every stage
# ---------------------------------------------------------------------------

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
_HEADER = 10        # dtype, ndim, up to 8 dimensions


def broadcast_meta(t, group, stage: int):
    """The (shape, dtype) of stage ``stage``'s ``t`` on every stage of
    ``group`` (``t`` None elsewhere): a small broadcast, from which the
    other stages build their buffers."""
    head = torch.zeros(_HEADER, dtype=torch.int64)
    if t is not None:
        if t.dim() > _HEADER - 2:
            raise ValueError(f"a {t.dim()}-D tensor has too many dimensions "
                             "for the pipeline's broadcasts")
        head[0], head[1] = _DTYPES.index(t.dtype), t.dim()
        head[2:2 + t.dim()] = torch.tensor(t.shape)
    C.broadcast(head, src=group.ranks[stage], group=group)
    shape = tuple(int(d) for d in head[2:2 + int(head[1])])
    return shape, _DTYPES[int(head[0])]


class _FromLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        last = group.nranks - 1
        ctx.is_last = group.rank == last
        ctx.anchor = (tuple(t.shape), t.dtype, t.device)

        def bcast():
            shape, dtype = broadcast_meta(t if ctx.is_last else None,
                                          group, last)
            if ctx.is_last:
                out = t.detach().clone(memory_format=torch.contiguous_format)
            else:
                out = torch.empty(shape, dtype=dtype, device=t.device)
            C.broadcast(out, src=group.ranks[last], group=group)
            return out
        out = _waited("broadcast_s", bcast)
        _STATS["broadcasts"] += 1
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.is_last:
            return g, None
        shape, dtype, device = ctx.anchor
        return torch.zeros(shape, dtype=dtype, device=device), None


def broadcast_from_last(t: torch.Tensor, group=None) -> torch.Tensor:
    """The last stage's ``t``, on every stage of ``group`` (default
    fleet's pp group); on the other stages ``t`` is their anchor (the
    schedule's empty output, or any tensor of their graph). The backward
    takes the last stage's gradient; the other stages' replicas pass a
    zero gradient to their anchor, which runs their backward schedule.
    With no group, ``t`` itself."""
    group = pipeline_group(group)
    if group is None or group.nranks == 1:
        return t
    return _FromLast.apply(t, group)


def sync_shared_gradients(shared):
    """Sum each shared parameter's gradient over the stages that hold it
    (Paddle's shared-layer all-reduce): ``shared`` is a list of
    (parameters, group). The schedule's backward queues it to run once
    the backward of the whole step has ended on this rank."""
    for params, group in shared:
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            _waited("shared_s", C.all_reduce, p.grad, group=group)
            _STATS["shared_allreduces"] += 1


# ---------------------------------------------------------------------------
# Fleet API wrapper
# ---------------------------------------------------------------------------

class PipelineParallel(torch.nn.Module):
    """``fleet.distributed_model``'s wrapper of a ``PipelineLayer``: it
    holds the layer (split by stage under a pp group) and drives a
    training step with ``train_batch``: the layer's forward over the
    schedule (microbatches from ``strategy.pipeline_configs
    ["accumulate_steps"]``, as in JAX), ``loss_fn`` on the last stage,
    the backward schedule, the optimizer's step. The loss is returned on
    every stage (the last stage's, broadcast)."""

    def __init__(self, layers, hcg=None, strategy=None, **kwargs):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._loss_fn = getattr(layers, "loss_fn", None)
        if strategy is not None and \
                getattr(layers, "num_microbatches", None) is None:
            acc = int(getattr(strategy, "pipeline_configs", {})
                      .get("accumulate_steps", 1))
            if acc > 1:
                layers.num_microbatches = acc

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def _require_loss_fn(self):
        if self._loss_fn is None:
            raise ValueError(
                "PipelineLayer was built without loss_fn; pipeline "
                "training needs it (PipelineLayer(..., loss_fn=...))")
        return self._loss_fn

    def forward_backward_pipeline(self, data, scaler=None):
        """Forward, the loss on the last stage and the backward; the
        loss (broadcast to every stage)."""
        x, y = data
        loss_fn = self._require_loss_fn()
        loss = self._layers.forward_loss(x, y, loss_fn)
        loss.backward()
        return loss.detach()

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        loss = self.forward_backward_pipeline(tuple(data), scaler)
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, state_dict, *a, **k):
        return self._layers.load_state_dict(state_dict, *a, **k)

    set_state_dict = load_state_dict
