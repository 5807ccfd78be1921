"""Program-level switches of the port.

Counterpart of ``paddle_tpu/passes/__init__.py`` ``fusion_enabled``
alone: the jaxpr pass pipeline has no counterpart here (PyTorch runs
eagerly), but the switch it reads also routes ``nn.functional.
cross_entropy`` to the fused softmax cross-entropy rows. In the port it
decides only for CPU tensors: on a CUDA tensor ``cross_entropy`` always
launches the kernels."""
from __future__ import annotations

from ..utils.flags import env_flag

__all__ = ["fusion_enabled"]


def fusion_enabled() -> bool:
    """Default-off switch for the reduction-fusion fast paths
    (``PT_FUSION_PASSES=1`` turns them on). Read at call time, so a
    caller can A/B without re-importing."""
    return env_flag("PT_FUSION_PASSES")
