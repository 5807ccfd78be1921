from .common import Embedding, LayerNorm, Linear
from .norm import RMSNorm

__all__ = ["Embedding", "LayerNorm", "Linear", "RMSNorm"]
