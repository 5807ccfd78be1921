"""Activation recompute (``paddle_tpu/distributed/fleet/
utils_recompute.py``): ``recompute`` over ``torch.utils.checkpoint``.

The forward of ``function`` runs without keeping its intermediates; the
backward runs it again and differentiates that. ``use_reentrant`` and
``preserve_rng_state`` are ``checkpoint``'s. ``policy`` selects what is
kept after all (JAX's ``jax.checkpoint`` policy): ``"selective"`` keeps
the products without batch dimensions (JAX's
``dots_with_no_batch_dims_saveable``), the ``CheckpointPolicy`` of the
stacked Llama trunk's selective recompute (``models.llama.
_save_products``); a callable is taken as a ``CheckpointPolicy``
function ``(ctx, op, *args, **kwargs)``. A policy needs
``use_reentrant=False``.

JAX's eager mode calls ``function`` straight through (its tape keeps
the residuals) and only its compiled step recomputes; the port's
autograd is eager, so the port always recomputes. The values and
gradients are the same."""
from __future__ import annotations

import functools

from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

__all__ = ["recompute", "recompute_sequential"]

def _policy_fn(policy):
    if callable(policy):
        return policy
    if policy == "selective":
        from ...models.llama import _save_products
        return _save_products
    raise ValueError(f"policy={policy!r}: expected None, a "
                     "CheckpointPolicy function or 'selective'")


def recompute(function, *args, use_reentrant=True, preserve_rng_state=True,
              policy=None, **kwargs):
    """``function(*args, **kwargs)``, its intermediates recomputed in the
    backward (module docstring)."""
    kw = dict(use_reentrant=use_reentrant,
              preserve_rng_state=preserve_rng_state)
    if policy is not None:
        if use_reentrant:
            raise ValueError("a recompute policy needs use_reentrant=False")
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _policy_fn(policy))
    return checkpoint(function, *args, **kw, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Run ``functions`` in order on ``args[0]``, recomputing segments of
    ``len(functions) // segments`` of them (at least one);
    ``ctx``: ``{"segments": n}`` or n, as JAX's."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else ctx
    funcs = list(functions)
    size = max(1, len(funcs) // segments)

    def segment(fs):
        def run(x):
            for f in fs:
                x = f(x)
            return x
        return run

    x = args[0]
    for s in range(0, len(funcs), size):
        x = recompute(segment(funcs[s:s + size]), x, **kwargs)
    return x
