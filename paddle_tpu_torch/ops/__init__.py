"""Kernel wrappers of the port.

Each wrapper runs its hand-written CUDA kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor, and counts its kernel launches in
a plain integer attribute (``rms_norm.launches``,
``flash_attention_fwd.launches``, ...; :func:`launch_counts` lists them
all). There is no fallback: on a CUDA
tensor the wrapper launches or raises.

:func:`plain_versions` is the one explicit exception, for comparisons:
inside it every wrapper computes its plain version on any device, so a
caller can hold a kernel's result against the plain one on the same
CUDA inputs. It launches nothing and counts nothing. :func:`plain_as`
sets the choice for a block whatever the enclosing scope: a recomputed
forward repeats the choice of the forward it repeats."""
from __future__ import annotations

import contextlib

__all__ = ["plain_versions", "plain_as", "plain_active", "reset_launch_counts",
           "launch_counts", "add_launch_counts"]

_plain_depth = 0


@contextlib.contextmanager
def plain_versions():
    """Run every wrapper's plain PyTorch version, whatever the device."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


@contextlib.contextmanager
def plain_as(active: bool):
    """Run the plain versions inside the block if ``active``, else the
    kernels, whatever the enclosing scope says."""
    global _plain_depth
    saved, _plain_depth = _plain_depth, int(active)
    try:
        yield
    finally:
        _plain_depth = saved


def plain_active() -> bool:
    return _plain_depth > 0


def _wrappers():
    from .decode_layer import decode_layer, decode_layer_int8
    from .flash_attention import (flash_attention_bwd_dkv,
                                  flash_attention_bwd_dq,
                                  flash_attention_fwd)
    from .fused import (fused_adamw, fused_rope, rms_norm, rms_norm_bwd,
                        rms_norm_residual)
    from .moe_dispatch import moe_gather
    from .paged_attention import (paged_attention_decode,
                                  paged_attention_decode_int8)
    from .weight_only import weight_only_matmul
    from .xent import xent_bwd, xent_fwd
    return {"rms_norm": rms_norm,
            "paged_attention_decode": paged_attention_decode,
            "paged_attention_decode_int8": paged_attention_decode_int8,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd_dq": flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd_dkv,
            "rope": fused_rope,
            "adamw": fused_adamw,
            "xent_fwd": xent_fwd,
            "xent_bwd": xent_bwd,
            "moe_gather": moe_gather,
            "rms_norm_residual": rms_norm_residual,
            "decode_layer": decode_layer,
            "decode_layer_int8": decode_layer_int8,
            "rms_norm_bwd": rms_norm_bwd,
            "weight_only_gemm": weight_only_matmul}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def add_launch_counts(deltas: dict):
    """Add ``{name: n}`` to the wrappers' counts: a replayed CUDA graph
    adds the launches it captured (``graphs``)."""
    wrappers = _wrappers()
    for name, n in deltas.items():
        wrappers[name].launches += n
