"""The port's native host runtime: the shared-memory ring that carries
the DataLoader's batches from its forked workers.

Counterpart of ``paddle_tpu/core/__init__.py`` (``load_native``,
``native_available``) and of the ``ShmQueue`` façade of
``paddle_tpu/core/native_api.py`` (copied) for the ring part of its C
library: the port
keeps its own copy of that code in ``csrc/shm_ring.cc`` and builds it
with ``g++`` at first use (never at import) into
``paddle_tpu_torch/_build/``, under a name that carries a digest of the
source and the flags, loaded with ``ctypes``. As in the JAX package, a
machine without a compiler keeps every feature: ``ShmQueue`` then runs
over a ``multiprocessing`` queue and ``native_available()`` is False.
The JAX core's host tracer and ``TCPStore`` are not ported yet
(``ROADMAP.md`` A.3 and A.6)."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.build import BUILD_DIR, CSRC

__all__ = ["load_native", "native_available", "ShmQueue"]

_SRC = CSRC / "shm_ring.cc"
_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_error = None


def lib_path():
    h = hashlib.sha1(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"shm_ring-{h.hexdigest()[:12]}.so"


def _build(out):
    # per-pid temp name: concurrent first-use builds must not interleave
    # writes into one file
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=180)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def load_native():
    """The ring's library (built first if needed), or None where it
    cannot be built or loaded."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            out = lib_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            _build_error = e
            return None
        lib.pt_shmq_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.pt_shmq_create.restype = ctypes.c_void_p
        lib.pt_shmq_open.argtypes = [ctypes.c_char_p]
        lib.pt_shmq_open.restype = ctypes.c_void_p
        lib.pt_shmq_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_uint64, ctypes.c_int]
        lib.pt_shmq_push.restype = ctypes.c_int
        lib.pt_shmq_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_uint64, ctypes.c_int]
        lib.pt_shmq_pop.restype = ctypes.c_int64
        lib.pt_shmq_size.argtypes = [ctypes.c_void_p]
        lib.pt_shmq_size.restype = ctypes.c_uint64
        lib.pt_shmq_close.argtypes = [ctypes.c_void_p]
        lib.pt_shmq_close.restype = None
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


class ShmQueue:
    """Cross-process byte-message ring in POSIX shared memory. The
    DataLoader puts pickled (or raw numpy) batches through this with one
    memcpy each way, instead of re-pickling over a pipe."""

    def __init__(self, name: str, capacity: int = 64 << 20,
                 create: bool = True):
        self.name = name if name.startswith("/") else "/" + name
        self._lib = load_native()
        self._h = None
        self._py = None
        self._capacity = capacity
        self._buf = None           # reusable receive buffer
        if self._lib is not None:
            if create:
                self._h = self._lib.pt_shmq_create(self.name.encode(),
                                                   capacity)
            else:
                self._h = self._lib.pt_shmq_open(self.name.encode())
            if self._h is None:
                raise OSError(f"shm queue {self.name!r} unavailable")
        else:
            # fallback: multiprocessing queue has the same interface shape
            import multiprocessing
            self._py = multiprocessing.Queue()

    @property
    def is_native(self):
        return self._h is not None

    def put(self, data: bytes, timeout: Optional[float] = None):
        if self._h is not None:
            rc = self._lib.pt_shmq_push(
                self._h, data, len(data),
                -1 if timeout is None else int(timeout * 1000))
            if rc == -2:
                raise ValueError(
                    f"message of {len(data)} bytes exceeds queue capacity")
            if rc != 0:
                raise TimeoutError("shm queue push timed out")
        else:
            import queue as _q
            try:
                self._py.put(data, timeout=timeout)
            except _q.Full:
                raise TimeoutError("shm queue push timed out") from None

    def get(self, timeout: Optional[float] = None) -> bytes:
        if self._h is not None:
            # one message can be at most capacity bytes; reuse the
            # buffer, left uninitialised (zeroing capacity bytes, 32 MiB
            # for the DataLoader, would cost more than a batch's copy)
            if self._buf is None:
                self._buf = np.empty(self._capacity, np.uint8)
            buf = self._buf.ctypes.data
            n = self._lib.pt_shmq_pop(
                self._h, buf, self._capacity,
                -1 if timeout is None else int(timeout * 1000))
            if n == -1:
                raise TimeoutError("shm queue pop timed out")
            if n == -2:
                raise ValueError(
                    "message exceeded this handle's capacity "
                    f"({self._capacity}B) and was dropped — open both ends "
                    "with the same capacity")
            return ctypes.string_at(buf, n)   # the message's bytes only
        import queue as _q
        try:
            return self._py.get(timeout=timeout)
        except _q.Empty:
            raise TimeoutError("shm queue pop timed out") from None

    def qsize_bytes(self) -> int:
        if self._h is not None:
            return int(self._lib.pt_shmq_size(self._h))
        return -1

    def close(self):
        if self._h is not None:
            self._lib.pt_shmq_close(self._h)
            self._h = None
