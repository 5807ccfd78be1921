"""Cross-rank program-consistency checking.

Counterpart of ``paddle_tpu/distributed/consistency.py``. The hang it
turns into an error: two ranks running different programs (other flags,
environment or data shapes) and then waiting forever in a collective.
Every rank fingerprints the program it is about to run and compares the
fingerprints through the job's store before stepping."""
from __future__ import annotations

import hashlib
import os
import time
from typing import Optional

from ..utils.flags import env_int

__all__ = ["program_fingerprint", "check_program_consistency",
           "ConsistencyError"]


class ConsistencyError(RuntimeError):
    pass


def _describe(val) -> str:
    import torch
    if isinstance(val, torch.Tensor):
        return (f"{val.dtype} {tuple(val.shape)} {tuple(val.stride())} "
                f"{val.device.type}")
    if isinstance(val, (tuple, list)):
        return "(" + ", ".join(_describe(v) for v in val) + ")"
    return repr(val) if isinstance(val, (int, float, bool)) else ""


def program_fingerprint(fn, *example_args) -> str:
    """SHA-256 of the ATen program ``fn`` runs on ``example_args``.

    JAX's hashes the lowered StableHLO. Here ``make_fx`` records ``fn``
    on fake tensors of the arguments' shapes, with the hand-written
    kernels' wrappers running their plain PyTorch versions so that each
    kernel appears as the ATen ops it computes. The hashed text holds,
    node by node, the op, its arguments (other nodes by name, scalars by
    value) and its value's dtype, shape, strides and device type
    (``cuda``, not the card's index: rank 0 on ``cuda:0`` and rank 1 on
    ``cuda:1`` run one program). Weights' values are not hashed, only
    their shapes and dtypes: two ranks holding other weights run the
    same program. So the fingerprints of two ranks differ exactly when
    their programs do: another op, order, constant, shape or dtype."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from .. import ops

    with ops.plain_versions():
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*example_args)
    lines = [f"{n.op} {n.target} {n.args} {n.kwargs} "
             f"{_describe(n.meta.get('val'))}" for n in gm.graph.nodes]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def check_program_consistency(fingerprint: str, store=None,
                              rank: Optional[int] = None,
                              world_size: Optional[int] = None,
                              key: str = "consistency/program",
                              timeout: float = 60.0) -> bool:
    """Publish this rank's fingerprint and compare it with every rank's.
    Raises ConsistencyError naming the diverging ranks instead of letting
    the job hang in a collective."""
    if rank is None:
        rank = env_int("PADDLE_TRAINER_ID", 0)
    if world_size is None:
        world_size = env_int("PADDLE_TRAINERS_NUM", 1)
    if world_size <= 1:
        return True
    if store is None:
        from ..core.native_api import TCPStore
        host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
        store = TCPStore(host, int(port), world_size=world_size,
                         timeout=timeout)
    store.set(f"{key}/{rank}", fingerprint)
    mismatched = []
    deadline = time.monotonic() + timeout
    for r in range(world_size):
        # poll, don't block: TCPStore.get waits forever on a missing key,
        # which would turn "rank r never got here" into exactly the hang
        # this check exists to prevent
        while not store.check(f"{key}/{r}"):
            if time.monotonic() > deadline:
                raise ConsistencyError(
                    f"rank {r} did not publish a program fingerprint "
                    f"within {timeout:.0f}s — it likely crashed before "
                    "tracing or diverged in setup.")
            time.sleep(0.02)
        other = store.get(f"{key}/{r}").decode()
        if other != fingerprint:
            mismatched.append((r, other[:12]))
    if mismatched:
        raise ConsistencyError(
            f"rank {rank} traced program {fingerprint[:12]} but "
            f"rank(s) {[r for r, _ in mismatched]} traced "
            f"{[h for _, h in mismatched]} — the job would hang at the "
            "first collective. Check per-rank env/flags/data shapes.")
    return True
