from .fused_ce import (fused_linear_cross_entropy,
                       parallel_fused_linear_cross_entropy)

__all__ = ["fused_linear_cross_entropy", "parallel_fused_linear_cross_entropy"]
