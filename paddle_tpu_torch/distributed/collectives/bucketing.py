"""Gradient bucketing, eager half: coalesce many small syncs into few
big ones.

Counterpart of the eager part of
``paddle_tpu/distributed/collectives/bucketing.py``: ``build_buckets``
(greedy, order-preserving, size-targeted) and
``bucketed_allreduce_gradients``, which flattens each bucket of
gradients into one fp32 tensor, all-reduces it once over
``communication`` (on the store transport that turns O(parameters)
rendezvous rounds into O(buckets); on gloo one host staging a bucket),
takes the mean and copies each slice back in its gradient's dtype.
Concatenation never reassociates one element's sum, so fp32 gradients
get the values of the per-tensor path bit for bit; bf16 ones are summed
in fp32 and rounded once."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["build_buckets", "bucketed_allreduce_gradients"]


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


def bucketed_allreduce_gradients(parameter_list, group=None,
                                 bucket_bytes: Optional[int] = None):
    """Mean all-reduce of every ``p.grad`` over the data-parallel group
    (the world by default), one fp32 all-reduce per size-targeted
    bucket (``collective_config().bucket_bytes`` by default)."""
    from .. import communication as C
    from ..parallel import ParallelEnv
    from ...profiler import RecordEvent
    from . import collective_config

    if bucket_bytes is None:
        bucket_bytes = collective_config().bucket_bytes
    params = [p for p in parameter_list
              if isinstance(p, torch.Tensor) and p.grad is not None
              and p.grad.numel() > 0]
    if not params:
        return
    if group is not None and getattr(group, "nranks", 0):
        n = group.nranks
    else:
        n = max(ParallelEnv().world_size, 1)
    sizes = [(i, p.grad.numel()) for i, p in enumerate(params)]
    with RecordEvent("collectives::grad_sync[eager,buckets]"):
        for bucket in build_buckets(sizes, bucket_bytes):
            grads = [params[i].grad for i in bucket]
            fused = torch.cat([g.reshape(-1).float() for g in grads])
            C.all_reduce(fused, op=C.ReduceOp.SUM, group=group)
            if n > 1:
                fused /= n
            off = 0
            for g in grads:
                sz = g.numel()
                g.copy_(fused[off:off + sz].view(g.shape))
                off += sz
