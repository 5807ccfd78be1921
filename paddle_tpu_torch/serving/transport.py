"""Fleet wire transports: the port's own copy of
``paddle_tpu/serving/transport.py`` — the 3-method ``Transport``
interface, the deterministic in-process queue transport, and a REAL
network transport over localhost TCP sockets. The frame format and the
delivery semantics are the JAX package's.

The fleet's failure-domain contract needs a wire that can actually
fail the way networks fail — torn writes, flipped bits, dropped
connections, lost acks — so recovery code is exercised against real
kernel socket buffers, not a python deque. :class:`SocketTransport`
provides that while staying CPU-lane testable and deterministic under
the ``utils.faults`` schedule:

- **Length-framed messages with a CRC32 trailer.** One frame =
  ``magic | seq | src_len | payload_len | src | payload | crc32``
  (all integers big-endian; the CRC covers every preceding byte). A
  receiver that sees a bad magic or CRC discards the frame and drops
  the connection WITHOUT acking — corruption is detected at the wire,
  never adopted into an arena.
- **Per-(src, dst) monotonic sequence numbers** ride the frame header.
  Within one connection a duplicate seq is dropped at the receiver;
  across a reconnect the receiver cannot know what the old connection
  delivered, so a retransmitted frame is delivered AGAIN — the
  transport is **at-least-once**, and exactly-once is restored one
  layer up by ``DecodeWorker.adopt()``'s (rid, payload seq) dedup.
- **Stop-and-wait acks with per-send wall-clock timeouts.** ``send``
  returns only after the receiver acked the frame's seq (or raises
  :class:`TransportError` after the retry budget); each attempt is
  bounded by ``io_timeout_s`` of wall clock.
- **Reconnect with exponential backoff** (``base * 2^attempt`` plus
  seeded jitter) around every transient wire failure,
  after which the SAME frame — same seq — is retransmitted.
- **Pumped writes** (a deliberate difference from the JAX transport,
  whose blocking ``sendall`` stalls on any frame larger than the kernel's
  socket buffers, since the receiver is serviced by the same thread): a
  frame is written in non-blocking pieces with the destination endpoint
  drained between them, so frames of any size move.

Every endpoint of this transport lives in one process (the fleet's),
so the receive side is serviced inline: ``send`` pumps the
destination endpoint while waiting for its ack, and ``recv`` pumps
before popping. The bytes still genuinely traverse a kernel TCP
socket — partial delivery, coalescing and connection teardown are
real, which is the point.

Deterministic fault sites (``utils.faults``), all in the send path so
call counts are schedule-stable:

- ``fleet.transport``      — refuse the send before any bytes move
  (fires in BOTH transports).
- ``transport.partial_write`` — write only a prefix of the frame, then
  drop the connection (torn write; receiver discards the partial).
- ``transport.corrupt``    — flip one payload byte; the receiver's CRC
  check discards the frame and the sender retransmits.
- ``transport.disconnect`` — drop the connection after the full frame
  is written but BEFORE the ack is read (ack loss; the retransmit
  delivers a duplicate the adopt layer must dedup).
"""
from __future__ import annotations

import socket
import struct
import time
import zlib
from collections import deque
from typing import Dict, Optional

import numpy as np

from ..observability import metrics as _om
from ..utils import faults

__all__ = ["InProcessTransport", "SocketTransport", "Transport",
           "TransportError", "fetch_endpoint"]

#: suffix of a worker's prefix-fetch receive queue. Fetch RESPONSES
#: (serving/prefix_cache.py) travel the same transport as handoffs but
#: on a per-worker side channel, so a bulk fetch payload can never
#: interleave into — or stall behind — the worker's handoff stream.
FETCH_ENDPOINT_SUFFIX = "#fetch"


def fetch_endpoint(worker: str) -> str:
    """Transport endpoint name of ``worker``'s prefix-fetch channel."""
    return worker + FETCH_ENDPOINT_SUFFIX

# transport metric families (registered at import; no-ops until
# metrics.enable()/PT_METRICS)
_M_SENDS = _om.counter("pt_transport_sends_total",
                       "frames successfully sent and acked")
_M_RESENDS = _om.counter("pt_transport_resends_total",
                         "frame retransmissions after a wire failure")
_M_RECONNECTS = _om.counter("pt_transport_reconnects_total",
                            "outgoing connections re-established")
_M_CRC_DROPS = _om.counter("pt_transport_crc_drops_total",
                           "received frames discarded on a bad "
                           "magic/CRC")
_M_DUP_FRAMES = _om.counter("pt_transport_dup_frames_total",
                            "received frames dropped as same-connection "
                            "duplicates")


class TransportError(RuntimeError):
    """A send that could not be delivered within the retry budget.
    The fleet's resilience layer treats it as TRANSIENT (retry /
    breaker), same as an :class:`~paddle_tpu_torch.utils.faults.
    InjectedFault` — the wire being down is an operational failure,
    not a programming error."""


class Transport:
    """Wire interface between fleet workers. ``send`` must raise on
    failure (the fleet's retry/breaker machinery wraps it); ``recv``
    returns the next payload for ``dst`` or None. Implementations must
    preserve per-destination FIFO order of successful sends — adoption
    order is part of the deterministic replay contract. Delivery is
    allowed to be at-least-once: the adopt layer dedups on
    (rid, payload seq)."""

    def send(self, dst: str, data: bytes):
        raise NotImplementedError

    def recv(self, dst: str) -> Optional[bytes]:
        raise NotImplementedError

    def pending(self) -> int:
        raise NotImplementedError

    def drop_endpoint(self, dst: str):
        """Tear down ``dst``'s receive side (its worker is dead):
        undelivered payloads are dropped — the fleet redrives them from
        its own records, never from the dead worker's queue. A later
        send/recv under the same name (a migrated successor)
        re-creates the endpoint fresh."""

    def close(self):
        """Release every OS resource the transport holds."""


class InProcessTransport(Transport):
    """Deterministic in-process transport: per-destination FIFO queues
    of real byte strings (payloads cross an actual serialize/
    deserialize boundary, so wire size and dtype fidelity are measured,
    not assumed). The ``fleet.transport`` fault site fires in ``send``
    BEFORE the payload is enqueued — a retry never double-delivers."""

    def __init__(self):
        self._queues: Dict[str, deque] = {}
        self.sends = 0
        self.bytes_sent = 0

    def send(self, dst: str, data: bytes):
        faults.fault_point("fleet.transport")
        self._queues.setdefault(dst, deque()).append(bytes(data))
        self.sends += 1
        self.bytes_sent += len(data)

    def recv(self, dst: str) -> Optional[bytes]:
        q = self._queues.get(dst)
        return q.popleft() if q else None

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def drop_endpoint(self, dst: str):
        self._queues.pop(dst, None)


# ---------------------------------------------------------------------------
# the socket transport
# ---------------------------------------------------------------------------

_MAGIC = b"PTF1"
_ACK_MAGIC = b"PTA1"
# magic(4) | seq(u64) | src_len(u16) | payload_len(u32)
_HDR = struct.Struct(">4sQHI")
_ACK = struct.Struct(">4sQ")
_CRC = struct.Struct(">I")


class _Endpoint:
    """One destination's receive side: a listening socket plus every
    accepted connection's read buffer and last-delivered seq."""

    def __init__(self):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(8)
        self.listener.setblocking(False)
        self.port = self.listener.getsockname()[1]
        self.conns: list = []           # [(sock, bytearray, {src: seq})]
        self.rx: deque = deque()        # delivered payload byte strings

    def close(self):
        for sock, _buf, _seen in self.conns:
            try:
                sock.close()
            except OSError:
                pass
        self.conns = []
        try:
            self.listener.close()
        except OSError:
            pass


class SocketTransport(Transport):
    """Localhost-TCP transport (see the module docstring for the frame
    format and delivery semantics). ``src`` names the sending endpoint
    (one fleet = one sender); receive endpoints are created lazily per
    destination name on first use.

    Counters (host attributes, mirrored into the ``pt_transport_*``
    metric families): ``sends`` (acked), ``resends``, ``reconnects``,
    ``crc_drops``, ``dup_frames``, ``bytes_sent`` (acked frames'
    payload bytes)."""

    def __init__(self, src: str = "fleet", *,
                 io_timeout_s: float = 5.0,
                 retry_attempts: int = 4,
                 retry_backoff_s: float = 0.005,
                 retry_jitter: float = 0.25,
                 seed: int = 0):
        if retry_attempts < 0:
            raise ValueError(
                f"retry_attempts={retry_attempts}; must be >= 0")
        self.src = src
        self.io_timeout_s = float(io_timeout_s)
        self.retry_attempts = int(retry_attempts)
        self.retry_backoff_s = float(retry_backoff_s)
        self.retry_jitter = float(retry_jitter)
        self._rng = np.random.RandomState(seed)
        self._endpoints: Dict[str, _Endpoint] = {}
        self._out: Dict[str, socket.socket] = {}
        self._seq: Dict[str, int] = {}       # per-dst (src is fixed)
        self.sends = 0
        self.resends = 0
        self.reconnects = 0
        self.crc_drops = 0
        self.dup_frames = 0
        self.bytes_sent = 0
        self._closed = False

    # -- endpoint / connection plumbing ------------------------------------
    def _endpoint(self, name: str) -> _Endpoint:
        if self._closed:
            raise TransportError("transport is closed")
        ep = self._endpoints.get(name)
        if ep is None:
            ep = _Endpoint()
            self._endpoints[name] = ep
        return ep

    def _backoff_s(self, attempt: int) -> float:
        return self.retry_backoff_s * (2.0 ** attempt) \
            * (1.0 + self.retry_jitter
               * float(self._rng.random_sample()))

    def _connect(self, dst: str) -> socket.socket:
        sock = self._out.get(dst)
        if sock is not None:
            return sock
        port = self._endpoint(dst).port
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(self.io_timeout_s)
        try:
            sock.connect(("127.0.0.1", port))
        except OSError as e:
            sock.close()
            raise TransportError(
                f"connect to {dst!r} (127.0.0.1:{port}) failed: {e}")
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._out[dst] = sock
        return sock

    def _drop_out(self, dst: str):
        sock = self._out.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    # -- receive side (serviced inline: every endpoint is in-process) ------
    def _service(self, name: str):
        """Accept pending connections for ``name`` and drain every
        complete frame into its rx queue, acking each accepted frame.
        Non-blocking: returns once no more progress can be made."""
        ep = self._endpoints.get(name)
        if ep is None:
            return
        while True:                     # accept everything waiting
            try:
                conn, _addr = ep.listener.accept()
            except (BlockingIOError, OSError):
                break
            conn.setblocking(False)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ep.conns.append((conn, bytearray(), {}))
        live = []
        for conn, buf, seen in ep.conns:
            eof = False
            while True:
                try:
                    chunk = conn.recv(1 << 20)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    eof = True
                    break
                if not chunk:
                    eof = True
                    break
                buf.extend(chunk)
            bad = self._parse_frames(ep, conn, buf, seen)
            if bad or eof:              # torn/corrupt stream: drop the
                try:                    # connection; the sender
                    conn.close()        # retransmits on a fresh one
                except OSError:
                    pass
                continue
            live.append((conn, buf, seen))
        ep.conns = live

    def _parse_frames(self, ep: _Endpoint, conn, buf: bytearray,
                      seen: Dict[str, int]) -> bool:
        """Consume complete frames from ``buf``; returns True when the
        stream is corrupt (bad magic/CRC) and must be dropped."""
        while True:
            if len(buf) < _HDR.size:
                return False
            magic, seq, src_len, payload_len = _HDR.unpack_from(buf, 0)
            if magic != _MAGIC:
                self.crc_drops += 1
                _M_CRC_DROPS.inc()
                return True
            total = _HDR.size + src_len + payload_len + _CRC.size
            if len(buf) < total:
                return False
            (crc,) = _CRC.unpack_from(buf, total - _CRC.size)
            with memoryview(buf) as view:    # one copy: the payload's
                ok = zlib.crc32(view[:total - _CRC.size]) \
                    & 0xFFFFFFFF == crc
                if ok:
                    start = _HDR.size + src_len
                    src = bytes(view[_HDR.size:start]).decode("utf-8")
                    payload = bytes(view[start:total - _CRC.size])
            if not ok:
                self.crc_drops += 1
                _M_CRC_DROPS.inc()
                return True
            del buf[:total]
            if seq <= seen.get(src, 0):
                # same-connection duplicate (stop-and-wait never sends
                # these, but the wire contract tolerates them)
                self.dup_frames += 1
                _M_DUP_FRAMES.inc()
            else:
                seen[src] = seq
                ep.rx.append(payload)
            try:                        # ack even duplicates — the ack
                conn.sendall(_ACK.pack(_ACK_MAGIC, seq))  # is what the
            except OSError:             # sender is starved of
                return True
        return False

    # -- send --------------------------------------------------------------
    def _frame(self, dst: str, data: bytes) -> bytes:
        seq = self._seq.get(dst, 0) + 1
        self._seq[dst] = seq
        src_b = self.src.encode("utf-8")
        head = _HDR.pack(_MAGIC, seq, len(src_b), len(data)) + src_b
        crc = zlib.crc32(data, zlib.crc32(head)) & 0xFFFFFFFF
        return b"".join((head, data, _CRC.pack(crc)))

    def send(self, dst: str, data: bytes):
        """Deliver ``data`` to ``dst`` with at-least-once semantics;
        raises :class:`TransportError` after the retry budget. The
        frame (and its seq) is built ONCE — every retry retransmits
        the identical bytes."""
        faults.fault_point("fleet.transport")
        self._endpoint(dst)             # receive side must exist
        frame = self._frame(dst, data)
        seq = self._seq[dst]
        last = ""
        for attempt in range(self.retry_attempts + 1):
            if attempt > 0:
                self.resends += 1
                _M_RESENDS.inc()
                time.sleep(self._backoff_s(attempt - 1))
            try:
                sock = self._connect(dst)
            except TransportError as e:
                last = str(e)
                continue
            try:
                self._write_frame(dst, sock, frame)
                self._await_ack(dst, sock, seq)
            except (TransportError, OSError) as e:
                last = f"{type(e).__name__}: {e}"
                self._drop_out(dst)
                self.reconnects += 1
                _M_RECONNECTS.inc()
                continue
            self.sends += 1
            self.bytes_sent += len(data)
            _M_SENDS.inc()
            return
        raise TransportError(
            f"send to {dst!r} (seq {seq}) failed after "
            f"{self.retry_attempts + 1} attempts: {last}")

    def _write_frame(self, dst: str, sock: socket.socket, frame: bytes):
        if faults.should_fire("transport.partial_write"):
            # torn write: a prefix reaches the kernel, then the
            # connection dies — the receiver discards the partial frame
            self._send_pumped(dst, sock, frame[:max(1, len(frame) // 2)])
            raise TransportError("injected partial write")
        if faults.should_fire("transport.corrupt"):
            # one flipped payload byte; the receiver's CRC catches it
            corrupt = bytearray(frame)
            corrupt[_HDR.size + len(self.src) + 1] ^= 0xFF
            self._send_pumped(dst, sock, corrupt)
            return
        self._send_pumped(dst, sock, frame)

    def _send_pumped(self, dst: str, sock: socket.socket, data):
        """Write ``data`` without blocking on a full socket buffer: the
        receive side lives in this process, so while the kernel's buffers
        are full the destination endpoint is serviced (drained into its
        connection buffer) between writes. A frame larger than the
        buffers (a KV handoff at 7B is hundreds of MB) would otherwise
        block ``sendall`` until the timeout, which the JAX transport
        does. Times out after ``io_timeout_s`` without progress."""
        view = memoryview(data)
        deadline = time.perf_counter() + self.io_timeout_s
        sock.setblocking(False)
        try:
            while view:
                try:
                    n = sock.send(view[:1 << 20])
                except (BlockingIOError, InterruptedError):
                    n = 0
                if n:
                    view = view[n:]
                    deadline = time.perf_counter() + self.io_timeout_s
                    continue
                self._service(dst)
                if time.perf_counter() > deadline:
                    raise TransportError(
                        f"write stalled for {self.io_timeout_s}s")
        finally:
            sock.settimeout(self.io_timeout_s)

    def _await_ack(self, dst: str, sock: socket.socket, seq: int):
        """Pump the destination endpoint (in-process receive side)
        until our seq is acked, bounded by the per-send wall clock."""
        if faults.should_fire("transport.disconnect"):
            # ack loss: the frame is already on the wire (the receiver
            # will deliver it) but the sender never learns — the
            # retransmit produces the duplicate adopt() must dedup
            raise TransportError("injected disconnect before ack")
        deadline = time.perf_counter() + self.io_timeout_s
        buf = bytearray()
        sock.setblocking(False)
        try:
            while True:
                self._service(dst)
                try:
                    chunk = sock.recv(4096)
                    if not chunk:
                        raise TransportError(
                            "connection closed before ack (frame "
                            "refused or receiver dropped it)")
                    buf.extend(chunk)
                except (BlockingIOError, InterruptedError):
                    pass
                while len(buf) >= _ACK.size:
                    magic, got = _ACK.unpack_from(buf, 0)
                    del buf[:_ACK.size]
                    if magic != _ACK_MAGIC:
                        raise TransportError("bad ack magic")
                    if got == seq:
                        return
                    # acks for older retransmitted seqs can linger on a
                    # reused connection; skip them
                if time.perf_counter() > deadline:
                    raise TransportError(
                        f"ack timeout after {self.io_timeout_s}s")
                time.sleep(0.0005)
        finally:
            sock.settimeout(self.io_timeout_s)

    # -- receive / lifecycle ----------------------------------------------
    def recv(self, dst: str) -> Optional[bytes]:
        ep = self._endpoints.get(dst)
        if ep is None:
            self._endpoint(dst)
            return None
        self._service(dst)
        return ep.rx.popleft() if ep.rx else None

    def pending(self) -> int:
        for name in list(self._endpoints):
            self._service(name)
        return sum(len(ep.rx) for ep in self._endpoints.values())

    def drop_endpoint(self, dst: str):
        ep = self._endpoints.pop(dst, None)
        if ep is not None:
            ep.close()
        self._drop_out(dst)
        self._seq.pop(dst, None)

    def close(self):
        for name in list(self._endpoints):
            self.drop_endpoint(name)
        for dst in list(self._out):
            self._drop_out(dst)
        self._closed = True

    def stats(self) -> dict:
        return {"sends": self.sends, "resends": self.resends,
                "reconnects": self.reconnects,
                "crc_drops": self.crc_drops,
                "dup_frames": self.dup_frames,
                "bytes_sent": self.bytes_sent}
