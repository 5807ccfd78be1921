"""The port's native host runtime: the shared-memory ring that carries
the DataLoader's batches from its forked workers, the host span tracer
under ``profiler.RecordEvent``, and the TCP store that the ranks of a
job rendezvous through.

Counterpart of ``paddle_tpu/core/__init__.py`` (``load_native``,
``native_available``) and of the ``ShmQueue`` façade of
``paddle_tpu/core/native_api.py`` (copied); its ``NativeTracer``,
``TCPStore`` and ``MasterDaemon`` façades are the port's
``core/native_api.py``. The JAX package builds one C
library for its ring, tracer and TCP store; the port keeps its own
copy of each part in a source of its own (``csrc/shm_ring.cc``,
``csrc/host_tracer.cc``, ``csrc/tcp_store.cc``) and builds it with ``g++`` at first use (never
at import) into ``paddle_tpu_torch/_build/``, under a name that carries
a digest of the source and the flags, loaded with ``ctypes``. As in the
JAX package, a machine without a compiler keeps every feature:
``ShmQueue`` then runs over a ``multiprocessing`` queue and
``native_available()`` is False, the tracer keeps its events in a
Python list, and the store's server and clients speak JAX's pickle
frames over Python sockets."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.build import BUILD_DIR, CSRC

__all__ = ["load_native", "load_host_tracer", "load_tcp_store",
           "native_available", "ShmQueue"]

# library name -> its source under csrc/
_SOURCES = {"shm_ring": "shm_ring.cc", "host_tracer": "host_tracer.cc",
            "tcp_store": "tcp_store.cc"}
_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]

_libs = {}
_lib_lock = threading.Lock()
_build_errors = {}


def lib_path(name: str = "shm_ring"):
    src = CSRC / _SOURCES[name]
    h = hashlib.sha1(" ".join(_FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _build(name, out):
    # per-pid temp name: concurrent first-use builds must not interleave
    # writes into one file
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(CSRC / _SOURCES[name]), "-o",
                        str(tmp)], check=True, capture_output=True,
                       timeout=180)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _load(name, bind):
    """Library ``name`` (built first if needed) with ``bind`` applied
    to declare its functions, or None where it cannot be built or
    loaded."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lib_lock:
        if name in _libs:
            return _libs[name]
        if name in _build_errors:
            return None
        try:
            out = lib_path(name)
            if not out.exists():
                _build(name, out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError) as e:
            _build_errors[name] = e
            return None
        bind(lib)
        _libs[name] = lib
        return lib


def _bind_ring(lib):
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


def _bind_tracer(lib):
    lib.pt_trace_enable.argtypes = [ctypes.c_int]
    lib.pt_trace_enable.restype = None
    lib.pt_trace_enabled.argtypes = []
    lib.pt_trace_enabled.restype = ctypes.c_int
    for fn in (lib.pt_trace_begin, lib.pt_trace_instant):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = None
    lib.pt_trace_end.argtypes = []
    lib.pt_trace_end.restype = None
    lib.pt_trace_counter.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.pt_trace_counter.restype = None
    lib.pt_trace_event_count.argtypes = []
    lib.pt_trace_event_count.restype = ctypes.c_int64
    lib.pt_trace_clear.argtypes = []
    lib.pt_trace_clear.restype = None
    lib.pt_trace_dump.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.pt_trace_dump.restype = ctypes.c_int


def _bind_store(lib):
    lib.pt_store_server_start.argtypes = [ctypes.c_int]
    lib.pt_store_server_start.restype = ctypes.c_void_p
    lib.pt_store_server_port.argtypes = [ctypes.c_void_p]
    lib.pt_store_server_port.restype = ctypes.c_int
    lib.pt_store_server_stop.argtypes = [ctypes.c_void_p]
    lib.pt_store_server_stop.restype = None
    lib.pt_store_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                            ctypes.c_int]
    lib.pt_store_client_connect.restype = ctypes.c_void_p
    lib.pt_store_set.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.pt_store_set.restype = ctypes.c_int
    lib.pt_store_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.pt_store_get.restype = ctypes.c_int
    lib.pt_store_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_int64]
    lib.pt_store_add.restype = ctypes.c_int64
    for fn in (lib.pt_store_wait, lib.pt_store_delete, lib.pt_store_check):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        fn.restype = ctypes.c_int
    lib.pt_store_client_close.argtypes = [ctypes.c_void_p]
    lib.pt_store_client_close.restype = None


def load_native():
    """The ring's library (built first if needed), or None where it
    cannot be built or loaded."""
    return _load("shm_ring", _bind_ring)


def load_host_tracer():
    """The host tracer's library (built first if needed), or None where
    it cannot be built or loaded."""
    return _load("host_tracer", _bind_tracer)


def load_tcp_store():
    """The TCP store's library (built first if needed), or None where it
    cannot be built or loaded."""
    return _load("tcp_store", _bind_store)


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
