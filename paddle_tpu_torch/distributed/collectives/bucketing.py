"""Gradient bucketing: coalesce many small syncs into few big ones.

Counterpart of ``paddle_tpu/distributed/collectives/bucketing.py``.

- ``build_buckets``: greedy, order-preserving, size-targeted.
- The eager half: ``bucketed_allreduce_gradients`` flattens each bucket
  of gradients into one fp32 tensor, all-reduces it once over
  ``communication`` (on the store transport that turns O(parameters)
  rendezvous rounds into O(buckets); on gloo one host staging a bucket),
  takes the mean and copies each slice back in its gradient's dtype
  (``allreduce_mean_``, which the group-sharded step's ``os`` level
  runs too). Concatenation never reassociates one element's sum, so
  fp32 gradients get the values of the per-tensor path bit for bit;
  bf16 ones are summed in fp32 and rounded once.
- The in-graph half: :class:`BucketedGradSync`, the optimizer's
  ``_grad_sync`` hook (:func:`attach_grad_sync`). In JAX it syncs inside
  ``shard_map``, where the mesh axes are bound, and is the identity
  elsewhere. The port's counterpart of a bound ``shard_map`` is the
  per-shard list of its in-program collectives (``collectives``): a
  list of per-shard gradient dicts, in mesh linear order over ``axes``,
  is synced bucket by bucket through ``hier_all_reduce`` (or
  ``quantized_all_reduce``) and meaned; a plain dict comes back
  unchanged. It runs on the device alone (no host read), so a CUDA
  graph can capture it.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

__all__ = ["build_buckets", "BucketedGradSync",
           "bucketed_allreduce_gradients", "attach_grad_sync",
           "allreduce_mean_", "allreduce_sum_"]


def build_buckets(named_sizes: Sequence[Tuple[str, int]],
                  bucket_bytes: int = 25 << 20,
                  elem_bytes: int = 4) -> List[List[str]]:
    """Greedy size-targeted bucketing, order-preserving.

    ``named_sizes``: (name, element_count) in sync order. A tensor
    larger than the target gets its own bucket; buckets are never
    empty."""
    target = max(int(bucket_bytes), 1)
    buckets: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for name, n in named_sizes:
        nbytes = int(n) * elem_bytes
        if cur and cur_bytes + nbytes > target:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _group_n(group) -> int:
    from ..parallel import ParallelEnv
    if group is not None and getattr(group, "nranks", 0):
        return group.nranks
    return max(ParallelEnv().world_size, 1)


# buckets a sync keeps in flight on the gloo and nccl routes (each its
# own fused buffer; gloo spreads them over its loopback devices)
IN_FLIGHT = 4


def allreduce_mean_(tensors, group=None, bucket_bytes: Optional[int] = None):
    """Mean all-reduce of ``tensors`` in place over ``group`` (the world
    by default): one fp32 all-reduce per size-targeted bucket
    (``collective_config().bucket_bytes`` by default), up to
    ``IN_FLIGHT`` of them at a time. Each element's sum is the one the
    per-tensor path takes."""
    _allreduce_buckets_(tensors, group, bucket_bytes, _group_n(group))


def allreduce_sum_(tensors, group=None, bucket_bytes: Optional[int] = None):
    """Sum all-reduce of ``tensors`` in place over ``group``, bucketed as
    :func:`allreduce_mean_` (the sequence-parallel gradients' sum,
    ``distributed.sep_ops``)."""
    _allreduce_buckets_(tensors, group, bucket_bytes, 1)


def _allreduce_buckets_(tensors, group, bucket_bytes, n: int):
    """The bucketed all-reduce of ``tensors`` in place over ``group``,
    each sum divided by ``n``."""
    from .. import communication as C
    from . import collective_config

    if bucket_bytes is None:
        bucket_bytes = collective_config().bucket_bytes
    ts = [t for t in tensors if t.numel() > 0]
    if not ts:
        return
    pending = collections.deque()

    def finish():
        task, fused, grads = pending.popleft()
        task.wait()
        if n > 1:
            fused /= n
        off = 0
        for g in grads:
            sz = g.numel()
            g.copy_(fused[off:off + sz].view(g.shape))
            off += sz

    for bucket in build_buckets([(i, t.numel()) for i, t in enumerate(ts)],
                                bucket_bytes):
        grads = [ts[i] for i in bucket]
        fused = torch.cat([g.reshape(-1).float() for g in grads])
        pending.append((C.all_reduce(fused, op=C.ReduceOp.SUM, group=group,
                                     sync_op=False), fused, grads))
        if len(pending) >= IN_FLIGHT:
            finish()
    while pending:
        finish()


def bucketed_allreduce_gradients(parameter_list, group=None,
                                 bucket_bytes: Optional[int] = None):
    """Mean all-reduce of every ``p.grad`` over the data-parallel group
    (the world by default), one fp32 all-reduce per size-targeted
    bucket. Parameters of a group-sharded optimizer are skipped: its
    step reduces their gradients (``distributed.sharding``)."""
    from ...profiler import RecordEvent
    from ..sharding import not_sharded

    params = [p for p in not_sharded(parameter_list)
              if isinstance(p, torch.Tensor) and p.grad is not None
              and p.grad.numel() > 0]
    if not params:
        return
    with RecordEvent("collectives::grad_sync[eager,buckets]"):
        allreduce_mean_([p.grad for p in params], group, bucket_bytes)


def _shard_count(axes, mesh) -> Dict[str, int]:
    """The sizes of ``axes`` in ``mesh`` (empty without a mesh)."""
    if mesh is None:
        return {}
    sizes = mesh.shape
    for a in axes:
        if a not in sizes:
            raise ValueError(f"axis {a!r} not in mesh axes {tuple(sizes)}")
    return {a: sizes[a] for a in axes}


class BucketedGradSync:
    """In-graph gradient sync: mean all-reduce over the mesh ``axes`` in
    size-targeted buckets (JAX's). The optimizer calls it as ``grads =
    hook(grads)`` at the top of ``step()`` (before clipping, the DDP
    order). ``grads`` is a list of per-shard ``{name: grad}`` dicts in
    mesh linear order over ``axes`` (one per device of the axes, each on
    its device): every dict comes back holding the mean. A plain dict
    (no shard list: nothing is bound) comes back unchanged. A list whose
    length is that of only some of the axes raises JAX's ValueError; the
    mean's divisor is the list's length, with or without a registered
    mesh (JAX's regression: a flat plan of size 1 turned the mean into a
    sum). With ``compress="int8"`` and ``error_bound`` set, each bucket
    takes the fp32 result where its runtime bound exceeds the budget."""

    def __init__(self, axes=("dp",), bucket_bytes: Optional[int] = None,
                 compress: Optional[str] = "__config__",
                 hierarchy: Optional[str] = None, mesh=None):
        from . import collective_config
        cfg = collective_config()
        self.axes = tuple(axes) if isinstance(axes, (tuple, list)) \
            else (axes,)
        self.bucket_bytes = int(bucket_bytes if bucket_bytes is not None
                                else cfg.bucket_bytes)
        self.compress = cfg.compress if compress == "__config__" \
            else compress
        self.error_bound = cfg.error_bound
        self.quant_bucket_size = cfg.quant_bucket_size
        self.hierarchy = hierarchy
        self.mesh = mesh

    def _plan(self, n: int):
        """The hierarchy plan over the axes; without a mesh a flat plan
        of the list's length."""
        from ..mesh import get_current_mesh
        from .hierarchical import HierarchyPlan, plan_hierarchy
        mesh = self.mesh if self.mesh is not None else get_current_mesh()
        sizes = _shard_count(self.axes, mesh)
        if not sizes:
            return HierarchyPlan(self.axes, None, None, 1, n)
        total = int(np.prod(list(sizes.values())))
        if n != total:
            for k in range(1, len(self.axes)):
                for bound in itertools.combinations(self.axes, k):
                    if int(np.prod([sizes[a] for a in bound])) == n:
                        raise ValueError(
                            f"BucketedGradSync over axes {self.axes}: only "
                            f"{bound} are bound in this shard list ({n} "
                            f"shards) — attach the hook with the axes the "
                            f"step actually maps over")
            raise ValueError(f"{n} shards for axes {self.axes} of "
                             f"{total} devices")
        return plan_hierarchy(self.axes, mesh, self.hierarchy)

    def __call__(self, grads):
        if isinstance(grads, dict) or not grads:
            return grads          # nothing bound: not ours to sync
        from ...profiler import RecordEvent
        from .hierarchical import hier_all_reduce
        from .quantized import quantized_all_reduce
        n = len(grads)
        plan = self._plan(n)
        first = grads[0]
        names = [k for k, g in first.items()
                 if g is not None and g.numel() > 0]
        out = [dict(g) for g in grads]
        int8 = self.compress == "int8"
        with RecordEvent(f"collectives::grad_sync[{plan.mode}"
                         f"{',int8' if int8 else ''},buckets]"):
            for bucket in build_buckets(
                    [(k, first[k].numel()) for k in names],
                    self.bucket_bytes):
                fused = [torch.cat([g[k].reshape(-1).float()
                                    for k in bucket]) for g in grads]
                if int8 and self.error_bound is not None:
                    q, b = quantized_all_reduce(
                        fused, plan, self.quant_bucket_size,
                        return_error_bound=True)
                    f = hier_all_reduce(fused, plan)
                    red = [torch.where(b.to(qi.device) <= self.error_bound,
                                       qi, fi) for qi, fi in zip(q, f)]
                elif int8:
                    red = quantized_all_reduce(fused, plan,
                                               self.quant_bucket_size)
                else:
                    red = hier_all_reduce(fused, plan)
                for s, r in enumerate(red):
                    r = r / n
                    off = 0
                    for k in bucket:
                        g = grads[s][k]
                        sz = g.numel()
                        out[s][k] = r[off:off + sz].view(g.shape) \
                            .to(g.dtype)
                        off += sz
        return out


def attach_grad_sync(optimizer, axes=("dp",), **kw):
    """Install a :class:`BucketedGradSync` as the optimizer's
    ``_grad_sync`` hook. Returns the hook, or None when the config flag
    is off and ``force`` was not passed (then a stale bucketed hook from
    an earlier call is cleared, and a user's own hook is left alone)."""
    force = kw.pop("force", False)
    from . import collective_config
    if not (force or collective_config().bucketed_grad_sync):
        if isinstance(getattr(optimizer, "_grad_sync", None),
                      BucketedGradSync):
            optimizer._grad_sync = None
        return None
    hook = BucketedGradSync(axes=axes, **kw)
    optimizer._grad_sync = hook
    return hook
