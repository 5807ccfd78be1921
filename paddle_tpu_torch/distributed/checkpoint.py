"""Crash-safe file writes: the port's own copy of the atomic helpers of
``paddle_tpu/distributed/checkpoint.py`` (``atomic_write``,
``atomic_savez``, ``atomic_json_dump``), which the serving snapshots
and the flight recorder write through. The sharded checkpoint itself
(``save_state_dict``/``load_state_dict``, reshard-on-load, async save)
comes with ``ROADMAP.md`` A.6."""
from __future__ import annotations

import json
import os

import numpy as np

__all__ = ["atomic_write", "atomic_savez", "atomic_json_dump"]


def _fsync_dir(dirname: str):
    """fsync a directory so a just-renamed entry is durable; a
    filesystem that refuses directory fds degrades to content-only
    durability."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, write_fn, mode: str = "wb"):
    """Crash-safe file write: ``write_fn(f)`` goes to a same-directory
    temp file which is fsynced and ``os.replace``d over ``path``, and
    the parent directory is fsynced after the rename — a reader sees
    either the old complete file or the new complete file, never a torn
    write, and a failed write leaves no temp file behind."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_savez(path: str, arrays: dict):
    """``np.savez`` through :func:`atomic_write` (an npz is
    self-contained, so tmp+rename makes the whole file atomic)."""
    atomic_write(path, lambda f: np.savez(f, **arrays))


def atomic_json_dump(path: str, obj):
    atomic_write(path, lambda f: json.dump(obj, f), mode="w")
