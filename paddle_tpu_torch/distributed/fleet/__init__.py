"""Fleet's training-loop utilities (``fleet.utils``). The rest of the JAX
package's ``fleet`` (``init``, ``DistributedStrategy``,
``distributed_model``/``distributed_optimizer``, the meta-parallel
layers, ``recompute``) comes with ``ROADMAP.md`` A.6 (d) and (e)."""
from . import utils                                        # noqa: F401

__all__ = ["utils"]
