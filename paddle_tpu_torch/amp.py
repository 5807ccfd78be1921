"""Mixed precision for the port.

Counterpart of ``paddle_tpu/amp/__init__.py`` ``decorate``: at level O2
every floating parameter becomes the low dtype (RMSNorm weights
included; only BatchNorm and LayerNorm keep theirs), and the optimizer
keeps fp32 masters (``multi_precision``). Buffers such as the RoPE
tables are not parameters and stay as they are."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["decorate"]

_EXCLUDED = (nn.modules.batchnorm._BatchNorm, nn.LayerNorm)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """Cast the models' parameters in place (the Parameter objects stay
    the same, so an optimizer built on them keeps working) and turn on
    the optimizers' fp32 masters. Returns what it was given, as the JAX
    ``decorate`` does."""
    d = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            excluded = {id(p) for sub in m.modules()
                        if isinstance(sub, _EXCLUDED)
                        for p in sub.parameters(recurse=False)}
            for p in m.parameters():
                if id(p) not in excluded and p.is_floating_point():
                    p.data = p.data.to(d)
    if optimizers is None:
        return models
    opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
        else [optimizers]
    for opt in opt_list:
        opt._multi_precision = True
    return models, optimizers
