"""Fleet's eager gradient sync (``paddle_tpu/distributed/fleet/utils.py``
``fused_allreduce_gradients``), for manual loops: forward,
``backward()``, ``fused_allreduce_gradients(params)``, ``opt.step()``."""
from __future__ import annotations

import torch

__all__ = ["fused_allreduce_gradients"]


def fused_allreduce_gradients(parameter_list, hcg=None, group=None,
                              bucket_bytes=None):
    """Mean all-reduce of every parameter's gradient over the data-
    parallel group (``hcg.get_data_parallel_group()`` where ``hcg``
    gives one, else ``group``, else the world). One ``all_reduce`` a
    gradient, in its dtype; with ``bucket_bytes`` set, or the
    collectives config's ``bucketed_grad_sync`` on, one fp32
    ``all_reduce`` a size-targeted bucket instead
    (``collectives.bucketed_allreduce_gradients``). Parameters of a
    group-sharded optimizer are skipped: its step reduces them."""
    from .. import communication as C
    from ..collectives import bucketed_allreduce_gradients, \
        collective_config
    from ..parallel import ParallelEnv
    from ..sharding import not_sharded

    if hcg is not None and group is None:
        get = getattr(hcg, "get_data_parallel_group", None)
        if callable(get):
            group = get()
    if bucket_bytes is not None or collective_config().bucketed_grad_sync:
        return bucketed_allreduce_gradients(
            parameter_list, group=group, bucket_bytes=bucket_bytes)
    n = group.nranks if group is not None and getattr(group, "nranks", 0) \
        else max(ParallelEnv().world_size, 1)
    for p in not_sharded(parameter_list):
        if not isinstance(p, torch.Tensor) or p.grad is None:
            continue
        C.all_reduce(p.grad, op=C.ReduceOp.SUM, group=group)
        if n > 1:
            p.grad /= n
