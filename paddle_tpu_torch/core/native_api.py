"""ctypes façades over the port's native host tracer
(``csrc/host_tracer.cc``) and TCP store (``csrc/tcp_store.cc``), each
with a pure-Python path: the port's own copy of ``NativeTracer``,
``global_tracer``, ``MasterDaemon`` and ``TCPStore`` of
``paddle_tpu/core/native_api.py`` (its ``ShmQueue`` is in
``core/__init__.py``).

``NativeTracer`` mirrors the host-tracer half of the reference's
profiler: spans go into per-thread native buffers when the library
builds and loads, else into an in-process Python list; either way
:meth:`NativeTracer.dump` writes the same chrome-trace event
structure.

``TCPStore`` is the rendezvous key-value store of a job
(``set/get/add/wait/check/delete_key/barrier``) and ``MasterDaemon`` its
server, which rank 0 hosts. The native server and client speak the JAX
package's wire protocol byte for byte; where the library cannot be built
both sides fall back, as in JAX, to a threaded Python server and client
that speak JAX's pickle frames. So a client of either package works
against a daemon of the other, native with native and Python with
Python. ``is_native`` says which one a daemon or client runs."""
from __future__ import annotations

import ctypes
import json
import pickle
import socket
import socketserver
import threading
import time
from typing import Optional

from . import load_host_tracer, load_tcp_store

__all__ = ["NativeTracer", "global_tracer", "MasterDaemon", "TCPStore"]


class NativeTracer:
    """Host span tracer. Native per-thread buffers when the
    ``host_tracer`` library builds and loads (``is_native``), otherwise
    an in-process Python list. Thread-safe."""

    def __init__(self):
        self._lib = load_host_tracer()
        self._py_events = []
        self._py_lock = threading.Lock()
        self._enabled = False

    @property
    def is_native(self):
        return self._lib is not None

    def enable(self, on: bool = True):
        self._enabled = on
        if self._lib is not None:
            self._lib.pt_trace_enable(1 if on else 0)

    def begin(self, name: str):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_begin(name.encode())
        else:
            with self._py_lock:
                self._py_events.append(("B", name, time.perf_counter_ns()))

    def end(self):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_end()
        else:
            with self._py_lock:
                self._py_events.append(("E", None, time.perf_counter_ns()))

    def instant(self, name: str):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_instant(name.encode())
        else:
            with self._py_lock:
                self._py_events.append(("i", name, time.perf_counter_ns()))

    def counter(self, name: str, value: int):
        if not self._enabled:
            return
        if self._lib is not None:
            self._lib.pt_trace_counter(name.encode(), int(value))
        else:
            with self._py_lock:
                self._py_events.append(
                    ("C", name, time.perf_counter_ns(), int(value)))

    def event_count(self) -> int:
        if self._lib is not None:
            return int(self._lib.pt_trace_event_count())
        with self._py_lock:
            return len(self._py_events)

    def clear(self):
        if self._lib is not None:
            self._lib.pt_trace_clear()
        with self._py_lock:
            self._py_events.clear()

    def dump(self, path: str, pid: int = 0):
        """Write chrome://tracing JSON."""
        if self._lib is not None:
            rc = self._lib.pt_trace_dump(path.encode(), pid)
            if rc != 0:
                raise OSError(f"trace dump to {path!r} failed")
            return
        events, stack = [], []
        with self._py_lock:
            for ev in self._py_events:
                if ev[0] == "B":
                    stack.append(ev)
                elif ev[0] == "E" and stack:
                    _, name, t0 = stack.pop()
                    events.append({"ph": "X", "name": name,
                                   "ts": t0 / 1e3,
                                   "dur": (ev[2] - t0) / 1e3,
                                   "pid": pid, "tid": 0})
                elif ev[0] == "i":
                    events.append({"ph": "i", "name": ev[1],
                                   "ts": ev[2] / 1e3, "pid": pid,
                                   "tid": 0, "s": "t"})
                elif ev[0] == "C":
                    events.append({"ph": "C", "name": ev[1],
                                   "ts": ev[2] / 1e3, "pid": pid,
                                   "args": {"value": ev[3]}})
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


_global_tracer: Optional[NativeTracer] = None


def global_tracer() -> NativeTracer:
    global _global_tracer
    if _global_tracer is None:
        _global_tracer = NativeTracer()
    return _global_tracer


# ---------------------------------------------------------------------------
# TCPStore
# ---------------------------------------------------------------------------

class _PyStoreServer:
    """Threaded key-value server speaking JAX's pickle frames (a u32
    length, then ``pickle((op, key, value))``; the reply a u32 length
    and a pickled value): the server of a machine where the native
    library cannot be built."""

    def __init__(self, port):
        kv, cv = {}, threading.Condition()

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    try:
                        head = self.rfile.read(4)
                        if len(head) < 4:
                            return
                        n = int.from_bytes(head, "little")
                        op, key, val = pickle.loads(self.rfile.read(n))
                    except (EOFError, ConnectionError, OSError):
                        return
                    if op == "set":
                        with cv:
                            kv[key] = val
                            cv.notify_all()
                        resp = b"ok"
                    elif op in ("get", "wait"):
                        with cv:
                            cv.wait_for(lambda: key in kv)
                            resp = kv[key] if op == "get" else b"ok"
                    elif op == "add":
                        with cv:
                            cur = int.from_bytes(kv.get(key, b"\0" * 8),
                                                 "little", signed=True)
                            cur += val
                            kv[key] = cur.to_bytes(8, "little", signed=True)
                            cv.notify_all()
                            resp = kv[key]
                    elif op == "check":
                        with cv:
                            resp = b"\1" if key in kv else b"\0"
                    elif op == "delete":
                        with cv:
                            kv.pop(key, None)
                        resp = b"ok"
                    else:
                        return
                    out = pickle.dumps(resp)
                    try:
                        self.wfile.write(len(out).to_bytes(4, "little")
                                         + out)
                    except (ConnectionError, OSError):
                        return

        socketserver.ThreadingTCPServer.allow_reuse_address = True
        self.server = socketserver.ThreadingTCPServer(("0.0.0.0", port),
                                                      Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def stop(self):
        self.server.shutdown()
        self.server.server_close()


class MasterDaemon:
    """The store's server, hosted by rank 0 (``port=0`` binds a free
    port; ``port`` then says which). Native where the library builds,
    else the Python server."""

    def __init__(self, port: int = 0):
        lib = load_tcp_store()
        self._native = None
        self._py = None
        if lib is not None:
            self._native = lib.pt_store_server_start(port)
            if self._native is None:
                raise OSError(f"cannot bind store server on port {port}")
            self.port = int(lib.pt_store_server_port(self._native))
        else:
            self._py = _PyStoreServer(port)
            self.port = self._py.port
        self.is_native = lib is not None

    def stop(self):
        if self._native is not None:
            load_tcp_store().pt_store_server_stop(self._native)
            self._native = None
        if self._py is not None:
            self._py.stop()
            self._py = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class TCPStore:
    """Client of a :class:`MasterDaemon` (``is_master=True`` starts the
    daemon first, on ``port``). ``get`` and ``wait`` block until the key
    exists; ``add`` is atomic on the server; ``barrier`` makes
    ``world_size`` clients meet, and is reusable."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 60.0):
        self.world_size = world_size
        self._daemon = None
        if is_master:
            self._daemon = MasterDaemon(port)
            port = self._daemon.port
        self.host, self.port = host, port
        lib = load_tcp_store()
        self._lib = lib
        self._h = None
        self._sock = None
        try:
            ip = socket.gethostbyname(host)
        except OSError:
            ip = host
        if lib is not None:
            self._h = lib.pt_store_client_connect(
                ip.encode(), port, int(timeout * 1000))
            if self._h is None:
                raise ConnectionError(
                    f"cannot reach store at {host}:{port}")
        else:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    self._sock = socket.create_connection((ip, port),
                                                          timeout=timeout)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            # get/wait block on the server until the key is set: no
            # timeout on the replies
            self._sock.settimeout(None)
            self._sock_lock = threading.Lock()

    @property
    def is_native(self) -> bool:
        return self._h is not None

    # -- the Python client's framing --
    def _py_call(self, op, key, val=None):
        msg = pickle.dumps((op, key, val))
        with self._sock_lock:
            self._sock.sendall(len(msg).to_bytes(4, "little") + msg)
            head = self._sock.recv(4, socket.MSG_WAITALL)
            if len(head) < 4:
                raise ConnectionError("store connection closed")
            n = int.from_bytes(head, "little")
            buf = bytearray()
            while len(buf) < n:
                part = self._sock.recv(n - len(buf))
                if not part:
                    raise ConnectionError("store connection closed")
                buf += part
        return pickle.loads(bytes(buf))

    def set(self, key: str, value):
        if isinstance(value, str):
            value = value.encode()
        if self._h is not None:
            value = bytes(value)
            rc = self._lib.pt_store_set(self._h, key.encode(), value,
                                        len(value))
            if rc != 0:
                raise ConnectionError("store set failed")
        else:
            self._py_call("set", key, bytes(value))

    def get(self, key: str) -> bytes:
        if self._h is not None:
            size = 1 << 16
            while True:
                buf = ctypes.create_string_buffer(size)
                n = self._lib.pt_store_get(self._h, key.encode(), buf,
                                           len(buf))
                if n < 0:
                    raise ConnectionError("store get failed")
                if n <= len(buf):
                    return buf.raw[:n]
                # the value outgrew the buffer (it may grow again before
                # the next fetch): fetch again into one twice its size
                size = n * 2
        return self._py_call("get", key)

    def add(self, key: str, delta: int) -> int:
        if self._h is not None:
            r = self._lib.pt_store_add(self._h, key.encode(), int(delta))
            if r == -(2 ** 63):
                raise ConnectionError("store add failed")
            return int(r)
        return int.from_bytes(self._py_call("add", key, int(delta)),
                              "little", signed=True)

    def wait(self, key: str):
        if self._h is not None:
            if self._lib.pt_store_wait(self._h, key.encode()) != 0:
                raise ConnectionError("store wait failed")
        else:
            self._py_call("wait", key)

    def check(self, key: str) -> bool:
        if self._h is not None:
            return self._lib.pt_store_check(self._h, key.encode()) == 1
        return self._py_call("check", key) == b"\1"

    def delete_key(self, key: str):
        if self._h is not None:
            if self._lib.pt_store_delete(self._h, key.encode()) != 0:
                raise ConnectionError("store delete failed")
        else:
            self._py_call("delete", key)

    def barrier(self, name: str = "_barrier"):
        """All ``world_size`` clients meet; a generation counter makes the
        barrier reusable."""
        arrived = self.add(f"{name}/cnt", 1)
        gen = (arrived - 1) // self.world_size
        if arrived % self.world_size == 0:
            self.set(f"{name}/gen{gen}", b"1")
        self.wait(f"{name}/gen{gen}")

    def close(self):
        if self._h is not None:
            self._lib.pt_store_client_close(self._h)
            self._h = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        if self._daemon is not None:
            self._daemon.stop()
            self._daemon = None
