"""Counter-based random numbers that match ``jax.random`` bit for bit.

The JAX package samples with threefry2x32 keys: ``PRNGKey(seed)``, a
``split`` at admission and one per decode step, and
``jax.random.categorical`` (Gumbel-max). This module is the same
generator in plain torch integer ops, so a seeded sampled request gives
the same stream in both packages. It follows JAX 0.9 with
``jax_threefry_partitionable`` on (its default) and 64-bit types off:

- threefry2x32: 20 rounds in five groups of four rotations, the key
  schedule ``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)`` injected after each group;
- ``split(key, n)`` hashes the counters ``(0, i)``, i < n; the new keys
  are the two output words of each counter;
- ``random_bits(key, shape)`` hashes ``(0, i)`` over the flat shape and
  returns the two words XORed;
- ``uniform``: ``(bits >> 9) | 0x3F800000`` read as fp32, minus 1, then
  ``max(minval, u * (maxval - minval) + minval)``;
- ``gumbel = -log(-log(uniform(tiny, 1)))``;
- ``categorical = argmax(logits + gumbel)``.

uint32 values are held in int64 tensors, masked with ``& 0xFFFFFFFF``
after every add and shift, so every op runs on the tensors' own device
(the CPU or the GPU). Keys are ``(..., 2)`` int64 tensors; every function
is vectorised over the leading dimensions of its keys.

The stateful stream of ``paddle_tpu/framework.py``: :func:`seed` sets
the global key, :func:`split_key` splits the key in use (the innermost
:func:`rng_context`'s, else the global one) and returns the new subkey,
keeping the other half, and :func:`rng_context` makes a key the one in
use for its body (the fleet RNG tracker's named streams)."""
from __future__ import annotations

from typing import Sequence, Union

import contextlib
import threading

import numpy as np
import torch

__all__ = ["prng_key", "split", "random_bits", "uniform", "gumbel",
           "categorical", "threefry2x32", "seed", "split_key",
           "rng_context"]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 hash of counter words (x1, x2) under key words
    (k1, k2): int64 tensors holding uint32 values, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed
    wraps to 32 bits, so the key is ``(0, seed mod 2**32)``. A (2,)
    int64 tensor."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def _hash_counts(keys: torch.Tensor, n: int):
    """Both output words of the counters (0, i), i < n, under every key:
    (..., n) each."""
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2**32 counters per key")
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2],
                        torch.zeros_like(lo), lo)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of every key: (..., 2) -> (..., num, 2)."""
    b1, b2 = _hash_counts(keys, num)
    return torch.stack([b1, b2], dim=-1)


def _shape(shape: Union[int, Sequence[int]]):
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) of every key: (..., 2)
    -> (..., *shape) int64 holding uint32 values."""
    shape = _shape(shape)
    n = 1
    for s in shape:
        n *= s
    b1, b2 = _hash_counts(keys, n)
    return (b1 ^ b2).reshape(*keys.shape[:-1], *shape)


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in fp32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval) and clamped
    below at minval."""
    bits = random_bits(keys, shape)
    one = 0x3F800000                          # the bits of 1.0f
    floats = ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span in fp32 on the host, passed as scalars
    # (exact in fp32): no device tensor and no host-to-device copy, so a
    # CUDA graph can capture the draw
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp_min(floats * float(span) + float(lo), float(lo))


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in fp32."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: keys (..., 2),
    fp32 logits (..., V) -> (...,) int64, the Gumbel-max draw."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


# -- the stateful stream ----------------------------------------------------

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
        _STATE.key = prng_key(0)
    return _STATE.stack


def seed(n: int) -> None:
    """The global key becomes ``prng_key(n)`` (``paddle.seed``)."""
    _stack()
    _STATE.key = prng_key(n)


def split_key() -> torch.Tensor:
    """One fresh subkey: the key in use is split in two, the first half
    kept as the key in use and the second returned (JAX's
    ``framework.split_key``)."""
    stack = _stack()
    key = stack[-1] if stack else _STATE.key
    key, sub = split(key)
    if stack:
        stack[-1] = key
    else:
        _STATE.key = key
    return sub


@contextlib.contextmanager
def rng_context(key: torch.Tensor):
    """``key`` is the key in use inside the body; on exit the previous
    one is in use again, as it was."""
    stack = _stack()
    stack.append(key)
    try:
        yield
    finally:
        stack.pop()
