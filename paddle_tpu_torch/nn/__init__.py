from . import utils
from .common import Embedding, LayerNorm, Linear
from .norm import RMSNorm
# the clip classes live on the optimizer module; paddle exposes them under
# nn as well, as the JAX package does
from ..optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,
                         ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Embedding", "LayerNorm", "Linear", "RMSNorm", "utils"]
