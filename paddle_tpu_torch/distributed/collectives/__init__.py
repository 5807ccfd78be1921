"""Hierarchical and quantized collectives over a mesh of devices.

Counterpart of ``paddle_tpu/distributed/collectives``: the HiCCL-style
decomposition of a collective over two mesh levels
(:mod:`.hierarchical`) and the EQuARX int8 all-reduce with its error
bound (:mod:`.quantized`), configured by :class:`CollectiveConfig`.

In the JAX package the ``hier_*`` primitives run inside ``shard_map``,
where each device holds its own value and the mesh axis names are bound.
The port drives every shard from one controller, so an in-program
collective takes the list of per-shard tensors in mesh linear-index
order over the plan's axes (each on its shard's device) and returns the
list each shard holds afterwards. A gather is a copy into each shard's
device, so it is exact; a sum adds in one fixed order that the plan
sets, the same on every shard. The host-level :func:`all_reduce`,
:func:`all_gather` and :func:`reduce_scatter` take stacked per-device
contributions and return the global result, as JAX's do.

The eager half of the JAX package's gradient bucketing
(:mod:`.bucketing`: ``build_buckets``, ``bucketed_allreduce_gradients``)
syncs the gradients of a data-parallel job over ``communication``. The
in-graph ``BucketedGradSync``/``attach_grad_sync`` and the comms
microbench are not part of this module yet (``ROADMAP.md`` A.6 (c))."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from ...utils.flags import env_bool

__all__ = [
    "CollectiveConfig", "collective_config", "set_collective_config",
    "configure",
    "HierarchyPlan", "plan_hierarchy",
    "hier_all_reduce", "hier_all_gather", "hier_reduce_scatter",
    "all_reduce", "all_gather", "reduce_scatter",
    "quantized_all_reduce", "int8_error_bound",
    "build_buckets", "bucketed_allreduce_gradients",
]


@dataclasses.dataclass
class CollectiveConfig:
    """Knobs for the collectives (JAX's fields and checks).

    - ``hierarchy``: "auto" decomposes over two mesh levels when the
      collective spans >= 2 axes of degree > 1; "flat" never does.
    - ``compress``: None (fp32) or "int8" (per-bucket-scaled int8
      payload, fp32 accumulation).
    - ``quant_bucket_size``: elements per int8 scale bucket.
    - ``bucket_bytes``: the gradient bucketer's target (the reference
      DataParallel's ``comm_buffer_size`` is 25 MB).
    - ``bucketed_grad_sync``: ``fleet.utils.fused_allreduce_gradients``
      syncs bucket by bucket (default off, or
      ``PT_COLLECTIVES_BUCKETED_SYNC=1``); it changes how many
      collectives run, not the values of fp32 gradients.

    JAX's ``error_bound`` budgets the in-graph int8 grad sync, which is
    not ported (``ROADMAP.md`` A.6 (c)).
    """
    hierarchy: str = "auto"                 # "auto" | "flat"
    compress: Optional[str] = None          # None | "int8"
    quant_bucket_size: int = 512
    bucket_bytes: int = 25 << 20
    bucketed_grad_sync: bool = dataclasses.field(
        default_factory=lambda: env_bool("PT_COLLECTIVES_BUCKETED_SYNC"))

    def __post_init__(self):
        if self.hierarchy not in ("auto", "flat"):
            raise ValueError(
                f"hierarchy must be 'auto' or 'flat', got "
                f"{self.hierarchy!r}")
        if self.compress not in (None, "int8"):
            raise ValueError(
                f"compress must be None or 'int8', got {self.compress!r}")
        if self.quant_bucket_size < 1:
            raise ValueError("quant_bucket_size must be >= 1")


_CONFIG = CollectiveConfig()


def collective_config() -> CollectiveConfig:
    return _CONFIG


def set_collective_config(cfg: CollectiveConfig) -> CollectiveConfig:
    global _CONFIG
    prev, _CONFIG = _CONFIG, cfg
    return prev


@contextlib.contextmanager
def configure(**kw):
    """Scoped config override: ``with collectives.configure(
    compress="int8", hierarchy="flat"): ...``"""
    prev = set_collective_config(dataclasses.replace(_CONFIG, **kw))
    try:
        yield _CONFIG
    finally:
        set_collective_config(prev)


from .hierarchical import (HierarchyPlan, plan_hierarchy,          # noqa: E402
                           hier_all_reduce, hier_all_gather,
                           hier_reduce_scatter,
                           all_reduce, all_gather, reduce_scatter)
from .quantized import quantized_all_reduce, int8_error_bound      # noqa: E402
from .bucketing import build_buckets, bucketed_allreduce_gradients  # noqa: E402
