"""Eager collectives and point-to-point communication.

Counterpart of ``paddle_tpu/distributed/communication.py``, over torch
tensors: a collective updates its tensor in place (``copy_``, so the
tensor keeps its device, dtype and storage) where the JAX one replaces
the value of its ``Tensor``.

Every call takes one of four routes, decided by the group and the state
of the process, never by a failure:

- ``"local"``: one process and no process group; a world collective is
  the identity (JAX's single-process shortcut).
- ``"gloo"`` or ``"nccl"``: a world collective once ``init_parallel_env``
  has started ``torch.distributed`` (JAX takes ``multihost_utils`` once
  ``jax.distributed`` is up). ``nccl`` runs on the card's tensors;
  ``gloo`` runs on host memory, so a CUDA tensor is staged through a
  pinned host copy and back (:func:`stage_stats` keeps the seconds of
  each part and the bytes).
- ``"store"``: subset groups (so that non-members need not take
  part), ``gather``, and world collectives and point-to-point ops of a
  multi-process job that has no process group. Once the process group
  is up, ``send``/``recv`` and their async forms take its route (gloo
  or nccl), since its world holds both peers of any group. On gloo and
  the store a receive only takes a message of its own tag; torch's nccl
  backend ignores tags, so there the sends and receives between two
  ranks must be made in the same order. The store's ops ride the job's
  ``TCPStore`` (``PADDLE_MASTER``; rank 0 hosts the daemon) as JAX's
  ``RAW0``/``BF16`` npy frames under JAX's keys, so a JAX rank and a port
  rank exchange through one store.

:func:`route_counts` counts the calls by op and route. A reduction over
the store sums the members' parts in rank order, as JAX's
``_reduce_terms``; a gloo or NCCL ring sums in its own order, so an fp32
reduction agrees with JAX's within rounding, not bit for bit. Every
member of a collective still receives the same bits. ``reduce_scatter``
and ``scatter`` gather everything and keep their part (O(world) traffic,
as JAX's eager ones); so does ``alltoall`` on the store, while on gloo
and nccl it is one ``all_to_all_single``, each member sending each other
member only its part."""
from __future__ import annotations

import collections
import dataclasses
import io
import pickle
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..utils.flags import env_float, env_int, env_str

__all__ = ["ReduceOp", "Group", "all_reduce", "all_gather",
           "all_gather_object", "reduce_scatter", "broadcast", "scatter",
           "gather", "reduce", "alltoall", "alltoall_single",
           "global_scatter", "global_gather", "send", "recv",
           "barrier", "new_group", "get_group", "destroy_process_group",
           "wait", "stream", "P2POp", "batch_isend_irecv", "isend", "irecv",
           "Task", "route_counts", "stage_stats", "reset_counters"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    def __init__(self, ranks, gid=0, name=None):
        self.ranks = list(ranks)
        self.id = gid
        self.name = name or f"group_{gid}"

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return len(self.ranks)

    @property
    def rank(self):
        pid = _my_rank()
        return self.ranks.index(pid) if pid in self.ranks else -1

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return _my_rank() in self.ranks

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_GROUPS: dict = {}
_NEXT_GID = [1]


def _pg_up() -> bool:
    return torch.distributed.is_available() \
        and torch.distributed.is_initialized()


def _my_rank() -> int:
    """The launch contract's rank first (``PADDLE_TRAINER_ID``), as JAX's
    ``_my_rank``; else the process group's; else 0."""
    return env_int("PADDLE_TRAINER_ID",
                   torch.distributed.get_rank() if _pg_up() else 0)


def _world_size() -> int:
    return env_int("PADDLE_TRAINERS_NUM",
                   torch.distributed.get_world_size() if _pg_up() else 1)


def _world():
    if 0 not in _GROUPS:
        _GROUPS[0] = Group(list(range(_world_size())), 0, "world")
    return _GROUPS[0]


def new_group(ranks=None, backend=None, timeout=None):
    """A communication group over ``ranks``. Ids come from a counter of
    this process: every rank must call ``new_group`` in the same order,
    as in the reference, so that ids agree across the job."""
    gid = _NEXT_GID[0]
    _NEXT_GID[0] += 1
    g = Group(sorted(ranks) if ranks is not None
              else list(range(_world_size())), gid)
    _GROUPS[gid] = g
    return g


def get_group(gid=0):
    return _GROUPS.get(gid, _world())


def destroy_process_group(group=None):
    """Drop ``group`` from the registry; with no group, end the sends
    still in flight, drop every group, close the store connection (rank
    0's daemon with it), reset the
    sequence counters (a job started again begins in lock-step with its
    peers) and destroy ``init_parallel_env``'s process group."""
    global _STORE
    if group is not None and group.id in _GROUPS and group.id != 0:
        del _GROUPS[group.id]
        return
    if _pg_up():
        _reap_sends(every=True)
    _GROUPS.clear()
    with _STORE_LOCK:
        if _STORE is not None:
            _STORE.close()
        _STORE = None
    with _SEQ_LOCK:
        _SEND_SEQ.clear()
        _RECV_SEQ.clear()
        _COLL_SEQ.clear()
    _NEXT_GID[0] = 1
    from . import parallel
    parallel._shutdown()


def _val(t) -> torch.Tensor:
    return t if isinstance(t, torch.Tensor) \
        else torch.as_tensor(np.asarray(t))


def _single_process() -> bool:
    return _world_size() == 1


def _is_world(group) -> bool:
    return group is None or group.id == 0 or \
        sorted(group.ranks) == list(range(_world_size()))


# --------------------------------------------------------------------------
# routes and their counters
# --------------------------------------------------------------------------

_ROUTES: dict = collections.defaultdict(collections.Counter)
_STAGE = {"calls": 0, "bytes": 0, "d2h_s": 0.0, "transport_s": 0.0,
          "h2d_s": 0.0}


def route_counts() -> dict:
    """``{op: {route: calls}}`` since the last :func:`reset_counters`."""
    return {op: dict(c) for op, c in _ROUTES.items()}


def stage_stats() -> dict:
    """The gloo route's host staging of CUDA tensors since the last
    :func:`reset_counters`: calls, bytes staged each way, and seconds
    spent copying to the host, in the transport and copying back."""
    return dict(_STAGE)


def reset_counters():
    _ROUTES.clear()
    _STAGE.update(calls=0, bytes=0, d2h_s=0.0, transport_s=0.0, h2d_s=0.0)


def _route(group) -> str:
    if _is_world(group):
        if _pg_up():
            return str(torch.distributed.get_backend())
        if _single_process():
            return "local"
    return "store"


def _note(op: str, route: str) -> str:
    _ROUTES[op][route] += 1
    return route


def _stage_in(tensors, staged: bool) -> list:
    """``tensors`` (contiguous) or, ``staged``, their pinned host copies
    (the copies counted and timed as the gloo route's staging)."""
    if not staged:
        return [t.contiguous() for t in tensors]
    t0 = time.perf_counter()
    xs = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        xs.append(h)
        _STAGE["bytes"] += h.numel() * h.element_size()
    _STAGE["calls"] += 1
    _STAGE["d2h_s"] += time.perf_counter() - t0
    return xs


def _to_device(dst: torch.Tensor, src: torch.Tensor):
    """``dst.copy_(src)``; the copy back of a staged result is timed."""
    if src is dst:
        return dst
    t0 = time.perf_counter()
    dst.copy_(src)
    if dst.is_cuda and not src.is_cuda:
        _STAGE["h2d_s"] += time.perf_counter() - t0
    return dst


class _Flight:
    """A collective of the process group in flight (the gloo or nccl
    route, ``async_op=True``): ``wait()`` ends it and copies its results
    into the caller's tensors (from their pinned host copies on the gloo
    route); the wait counts as the transport's time there."""

    def __init__(self, work, pairs, staged, finish):
        self._work = work
        self._pairs = pairs
        self._staged = staged
        self._finish = finish

    def wait(self):
        if self._work is None:
            return True
        t0 = time.perf_counter()
        self._work.wait()
        if self._staged:
            _STAGE["transport_s"] += time.perf_counter() - t0
        for dst, src in self._pairs:
            _to_device(dst, src)
        if self._finish is not None:
            self._finish()
        self._work, self._pairs, self._finish = None, (), None
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _start(route, ins, outs, launch, inplace=False, finish=None):
    """Start ``launch(*xs)`` (a ``torch.distributed`` call with
    ``async_op=True``) over the inputs ``ins`` and the outputs ``outs``
    (``inplace``: the inputs are the outputs); on the gloo route CUDA
    tensors travel through pinned host copies (outputs as empty pinned
    buffers). Returns the :class:`_Flight`, whose ``wait()`` copies the
    results back and then runs ``finish()``. The one path of every
    process-group collective: a synchronous op is ``_start(...).wait()``."""
    ins, outs = list(ins), list(outs)
    staged = route == "gloo" and any(t.is_cuda for t in ins + outs)
    hin = _stage_in(ins, staged)
    if inplace:
        hout = hin
    elif staged:
        hout = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in outs]
    else:
        hout = [t.contiguous() for t in outs]
    work = launch(*hin) if inplace else launch(*hin, *hout)
    targets = ins if inplace else outs
    return _Flight(work, [(d, h) for d, h in zip(targets, hout)
                          if d is not h], staged, finish)


def _start_all_gather(route, outs, mine):
    """``torch.distributed.all_gather`` of ``mine`` into ``outs`` (one
    tensor a rank), started."""
    return _start(route, [mine], outs, lambda i, *o: torch.distributed
                  .all_gather(list(o), i, async_op=True))


def _reduce_scatter_flat(out, inp, group=None):
    """``out`` (1-D) = this member's 1/n of the sum of every member's
    ``inp`` (1-D, n times ``out``), started: the returned task's
    ``wait()`` ends it. The gloo and nccl routes run
    ``reduce_scatter_tensor``; the store route all-reduces and keeps
    this member's part; one process copies."""
    route = _note("reduce_scatter_tensor", _route(group))
    if route in ("gloo", "nccl"):
        return _start(route, [inp], [out], lambda i, o: torch.distributed
                      .reduce_scatter_tensor(o, i, async_op=True))
    if route == "store":
        all_reduce(inp, group=group)
    n = out.numel()
    me = _me(group) if route == "store" else 0
    out.copy_(inp[me * n:(me + 1) * n])
    return Task()


def _all_gather_flat(outs, mine, group=None):
    """Every member's 1-D ``mine`` into ``outs`` (one tensor a member,
    in group-rank order), started: the returned task's ``wait()`` ends
    it."""
    route = _note("all_gather", _route(group))
    if route in ("gloo", "nccl"):
        return _start_all_gather(route, outs, mine)
    for o, p in zip(outs, _gather_parts(mine, group, "allgather", route)):
        o.copy_(p)
    return Task()


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.AVG: "SUM", ReduceOp.MAX: "MAX",
              ReduceOp.MIN: "MIN", ReduceOp.PROD: "PRODUCT"}


# --------------------------------------------------------------------------
# store transport (p2p, subset groups, gather)
# --------------------------------------------------------------------------

class _LocalStore:
    """In-process store with ``TCPStore``'s semantics, used when the
    world is one process (self-sends, and members of a group driven from
    threads in tests)."""

    def __init__(self):
        self._d: dict = {}
        self._cv = threading.Condition()

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        with self._cv:
            self._d[key] = bytes(value)
            self._cv.notify_all()

    def get(self, key):
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._d, timeout=60):
                raise TimeoutError(f"store get timed out on {key!r}")
            return self._d[key]

    def wait(self, key):
        with self._cv:
            if not self._cv.wait_for(lambda: key in self._d, timeout=60):
                raise TimeoutError(f"store wait timed out on {key!r}")

    def add(self, key, delta):
        with self._cv:
            cur = int.from_bytes(self._d.get(key, b"\0" * 8), "little",
                                 signed=True)
            cur += int(delta)
            self._d[key] = cur.to_bytes(8, "little", signed=True)
            self._cv.notify_all()
            return cur

    def check(self, key):
        with self._cv:
            return key in self._d

    def delete_key(self, key):
        with self._cv:
            self._d.pop(key, None)

    def close(self):
        pass


_STORE = None
_STORE_LOCK = threading.Lock()


def _get_store():
    """The job's ``TCPStore`` at ``PADDLE_MASTER`` (rank 0 hosts it),
    connected at first use; an in-process store when the world is one
    process. A multi-process job without ``PADDLE_MASTER`` raises."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is not None:
            return _STORE
        master = env_str("PADDLE_MASTER", "") or None
        if _single_process() or not master:
            if not _single_process():
                raise RuntimeError(
                    "point-to-point and subset-group communication needs "
                    "the TCPStore rendezvous: launch with python -m "
                    "paddle_tpu_torch.distributed.launch (it sets "
                    "PADDLE_MASTER) or set PADDLE_MASTER=host:port")
            _STORE = _LocalStore()
            return _STORE
        from ..core.native_api import TCPStore
        host, port = master.rsplit(":", 1)
        _STORE = TCPStore(host, int(port), is_master=_my_rank() == 0,
                          world_size=_world_size())
        return _STORE


def _pack(t) -> bytes:
    """JAX's frame: ``RAW0`` + the npy file of the value, or ``BF16`` +
    the npy file of its bits as uint16."""
    t = _val(t).detach().cpu().contiguous()
    buf = io.BytesIO()
    if t.dtype == torch.bfloat16:
        np.save(buf, t.view(torch.int16).numpy().view(np.uint16))
        return b"BF16" + buf.getvalue()
    np.save(buf, t.numpy())
    return b"RAW0" + buf.getvalue()


def _unpack(data: bytes) -> torch.Tensor:
    """The host tensor of a :func:`_pack` frame (either package's)."""
    tag, body = data[:4], data[4:]
    a = np.load(io.BytesIO(body))
    if not a.flags.writeable:
        a = a.copy()
    if tag == b"BF16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


_SEND_SEQ: dict = {}
_RECV_SEQ: dict = {}
_SEQ_LOCK = threading.Lock()


class Task:
    """Async handle of ``isend``/``irecv`` (``task.wait()``)."""

    def __init__(self, thread: Optional[threading.Thread] = None,
                 result_box: Optional[list] = None):
        self._thread = thread
        self._box = result_box

    def wait(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("p2p task did not complete")
            self._thread = None
        if self._box and isinstance(self._box[0], BaseException):
            raise self._box[0]
        return True

    def is_completed(self):
        return self._thread is None or not self._thread.is_alive()


def _p2p_route() -> str:
    """The route of a point-to-point op: the process group's backend
    once ``init_parallel_env`` started it (its world holds both peers,
    whatever group namespaces the exchange), else the store."""
    return str(torch.distributed.get_backend()) if _pg_up() else "store"


def _p2p_start(route, tensor, peer, tag, receive):
    """Start a send of ``tensor`` to GLOBAL rank ``peer`` (or a receive
    into it) on the process group, tagged ``tag``: a :class:`_Flight`
    whose ``wait()`` ends it. On gloo a CUDA tensor travels through a
    pinned host copy (counted and timed as the collectives' staging);
    the copy lives until the flight ends."""
    staged = route == "gloo" and tensor.is_cuda
    if receive:
        if staged:
            buf = torch.empty(tensor.shape, dtype=tensor.dtype,
                              pin_memory=True)
        else:
            buf = tensor if tensor.is_contiguous() else \
                torch.empty_like(tensor,
                                 memory_format=torch.contiguous_format)
        work = torch.distributed.irecv(buf, src=peer, tag=tag)
        return _Flight(work, [(tensor, buf)], staged, None)
    [buf] = _stage_in([tensor], staged)
    work = torch.distributed.isend(buf, dst=peer, tag=tag)
    return _Flight(work, [], staged, lambda: buf)


def _p2p_key(gid, src, dst, tag, seqs):
    """The store key of the next message from ``src`` to ``dst`` under
    ``tag``: JAX's ``p2p/{gid}/{src}->{dst}/{seq}`` for tag 0, the tag
    in the key otherwise; sequence numbers count per (group, pair,
    tag)."""
    with _SEQ_LOCK:
        seq = seqs.get((gid, src, dst, tag), 0)
        seqs[(gid, src, dst, tag)] = seq + 1
    mid = f"t{tag}/" if tag else ""
    return f"p2p/{gid}/{src}->{dst}/{mid}{seq}"


# sends of ``send`` on the process group still in flight (their private
# copies with them), ended as they complete and all at
# ``destroy_process_group``
_PENDING_SENDS: list = []


def _reap_sends(every: bool = False):
    keep = []
    for fl in _PENDING_SENDS:
        if every or fl.is_completed():
            fl.wait()
        else:
            keep.append(fl)
    _PENDING_SENDS[:] = keep


def send(tensor, dst=0, group=None, sync_op=True, tag=0):
    """Send ``tensor`` to GLOBAL rank ``dst``; ``group`` only namespaces
    the exchange. Once the process group is up the send is the group's
    (``torch.distributed.isend``); otherwise it rides the store, where
    per-(group, src, dst, tag) sequence numbers match repeated sends to
    their receives in order. On gloo and the store a receive never takes
    a message of another ``tag``; on nccl, which ignores tags, the sends
    and receives of a pair must be made in the same order. Either way
    the call returns once the message is handed over, before its receive
    starts (a store set never waits; on the process group a private copy
    travels: the pinned host copy of a CUDA tensor that gloo stages,
    else a clone), so two ranks may each send, then receive, and the
    caller may reuse the tensor at once; ``sync_op=False`` returns the
    process group's flight instead (its ``wait()`` ends the transfer;
    the tensor must not change before)."""
    v = _val(tensor)
    route = _note("send", _p2p_route())
    if route != "store":
        if not sync_op:
            return _p2p_start(route, v, dst, tag, receive=False)
        _reap_sends()
        staged = route == "gloo" and v.is_cuda
        _PENDING_SENDS.append(_p2p_start(
            route, v if staged else v.clone(), dst, tag, receive=False))
        return None
    _warn_if_bulk(v, "send")
    store = _get_store()
    key = _p2p_key(group.id if group else 0, _my_rank(), dst, tag,
                   _SEND_SEQ)
    store.set(key, _pack(v))
    return None if sync_op else Task()


def recv(tensor, src=0, group=None, sync_op=True, tag=0):
    """Receive the matching :func:`send` from GLOBAL rank ``src`` into
    ``tensor`` (its device and dtype; the shapes must agree); on the
    store route with no tensor, the received host tensor. On the process
    group the receive needs its tensor, and ``sync_op=False`` returns
    the flight whose ``wait()`` fills it."""
    route = _note("recv", _p2p_route())
    if route != "store":
        if not isinstance(tensor, torch.Tensor):
            raise ValueError("recv over the process group needs the tensor "
                             "to receive into (its shape and dtype)")
        fl = _p2p_start(route, tensor, src, tag, receive=True)
        if not sync_op:
            return fl
        fl.wait()
        return tensor
    store = _get_store()
    key = _p2p_key(group.id if group else 0, src, _my_rank(), tag,
                   _RECV_SEQ)
    store.wait(key)
    v = _unpack(store.get(key))
    store.delete_key(key)
    if not isinstance(tensor, torch.Tensor):
        return v
    if tuple(tensor.shape) != tuple(v.shape):
        raise ValueError(f"recv from rank {src}: a {tuple(v.shape)} "
                         f"value for a {tuple(tensor.shape)} tensor")
    tensor.copy_(v)
    return tensor


def _async(fn, *args, **kw):
    box = [None]

    def run():
        try:
            box[0] = fn(*args, **kw)
        except BaseException as e:  # surfaced in Task.wait
            box[0] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return Task(t, box)


def isend(tensor, dst=0, group=None, tag=0):
    """:func:`send` started: the process group's flight, or a thread
    over the store; ``wait()`` ends it."""
    if _pg_up():
        return send(tensor, dst, group, sync_op=False, tag=tag)
    return _async(send, tensor, dst, group, tag=tag)


def irecv(tensor, src=0, group=None, tag=0):
    if _pg_up():
        return recv(tensor, src, group, sync_op=False, tag=tag)
    return _async(recv, tensor, src, group, tag=tag)


@dataclasses.dataclass
class P2POp:
    op: object
    tensor: object
    peer: int
    group: object = None
    tag: int = 0


def batch_isend_irecv(p2p_op_list):
    """Start a batch of P2POps concurrently; returns their tasks. Sends
    first (neither a store set nor a process group's send waits for its
    receive to start), then receives: the deadlock-free order for
    symmetric exchanges."""
    for p in p2p_op_list:
        if p.op not in (send, isend, recv, irecv):
            raise ValueError(
                f"P2POp.op must be send/isend/recv/irecv, got {p.op}")
    tasks = []
    for p in p2p_op_list:
        if p.op in (send, isend):
            tasks.append(isend(p.tensor, p.peer, p.group, tag=p.tag))
    for p in p2p_op_list:
        if p.op in (recv, irecv):
            tasks.append(irecv(p.tensor, p.peer, p.group, tag=p.tag))
    return tasks


_COLL_SEQ: dict = {}


def _coll_round(group, op_name, me) -> int:
    # keyed per member rank: counters advance in lock-step across members
    # whether they live in separate processes or threads of one process
    with _SEQ_LOCK:
        k = (group.id, op_name, me)
        seq = _COLL_SEQ.get(k, 0)
        _COLL_SEQ[k] = seq + 1
        return seq


_BULK_WARNED_OPS: set = set()


def _warn_if_bulk(value, op_name):
    """Size guard of the store transport, a control-plane path (npy
    frames through the TCP store, O(world) per member):

    - ``PT_EAGER_COLLECTIVE_WARN_MB`` (default 1): the threshold in MB;
    - ``PT_EAGER_COLLECTIVE_GUARD``: ``warn`` (default, once per op
      name and process), ``error`` (raise RuntimeError) or ``off``."""
    mode = env_str("PT_EAGER_COLLECTIVE_GUARD", "warn")
    if mode == "off":
        return
    nbytes = _val(value).numel() * _val(value).element_size()
    try:
        limit_mb = env_float("PT_EAGER_COLLECTIVE_WARN_MB", 1.0)
    except ValueError:      # a malformed knob must not break the call
        limit_mb = 1.0
    if nbytes <= limit_mb * 1e6:
        return
    msg = (f"eager {op_name} of {nbytes / 1e6:.1f} MB rides the host "
           "TCP store (control-plane transport, O(world) per member); "
           "for bulk data use a world collective of the process group "
           "(init_parallel_env: gloo or nccl). Set PT_EAGER_COLLECTIVE_"
           "GUARD=error to raise, =off to silence, or "
           "PT_EAGER_COLLECTIVE_WARN_MB to tune the threshold")
    if mode == "error":
        raise RuntimeError(msg)
    if op_name not in _BULK_WARNED_OPS:
        _BULK_WARNED_OPS.add(op_name)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _store_gather(value, group, op_name):
    """Every member contributes ``value``; the members' values as host
    tensors in ``group.ranks`` order. The last reader cleans up."""
    _warn_if_bulk(value, op_name)
    store = _get_store()
    me = group.rank
    rnd = _coll_round(group, op_name, me)
    if me < 0:
        raise RuntimeError(
            f"rank {_my_rank()} called {op_name} on {group} it is not a "
            f"member of")
    base = f"coll/{group.id}/{op_name}/{rnd}"
    store.set(f"{base}/{me}", _pack(value))
    outs = []
    for r in range(group.nranks):
        key = f"{base}/{r}"
        store.wait(key)
        outs.append(_unpack(store.get(key)))
    done = store.add(f"{base}/done", 1)
    if done == group.nranks:
        for r in range(group.nranks):
            store.delete_key(f"{base}/{r}")
        store.delete_key(f"{base}/done")
    return outs


def _reduce_terms(op, parts):
    """JAX's ``_reduce_terms``: the parts combined in rank order."""
    out = parts[0]
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        for p in parts[1:]:
            out = out + p
        return out / len(parts) if op == ReduceOp.AVG else out
    fn = {ReduceOp.MAX: torch.maximum, ReduceOp.MIN: torch.minimum,
          ReduceOp.PROD: torch.mul}[op]
    for p in parts[1:]:
        out = fn(out, p)
    return out


def _gather_parts(v, group, op_name, route):
    """Every member's ``v`` in group-rank order, on ``v``'s device."""
    if route == "local":
        return [v]
    if route == "store":
        return [p.to(v.device) for p in
                _store_gather(v, group or _world(), op_name)]
    outs = [torch.empty_like(v)
            for _ in range(torch.distributed.get_world_size())]
    _start_all_gather(route, outs, v).wait()
    return outs


def _me(group) -> int:
    return group.rank if group is not None and not _is_world(group) \
        else _my_rank()


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place. ``sync_op=False`` on the gloo or nccl route starts the
    collective and returns a task whose ``wait()`` ends it (several may
    be in flight, each on its own buffer); on the other routes the call
    completes and returns a finished task."""
    v = _val(tensor)
    route = _note("all_reduce", _route(group))
    if route == "local":
        return tensor if sync_op else Task()
    if route == "store":
        parts = _store_gather(v, group or _world(), f"allreduce_{op}")
        tensor.copy_(_reduce_terms(op, parts))
        return tensor if sync_op else Task()
    n = torch.distributed.get_world_size()
    fl = _start(route, [v], [], lambda x: torch.distributed.all_reduce(
        x, op=getattr(torch.distributed.ReduceOp, _TORCH_OPS[op]),
        async_op=True), inplace=True,
        finish=(lambda: tensor.copy_(tensor / n))
        if op == ReduceOp.AVG else None)
    if not sync_op:
        return fl
    fl.wait()
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    v = _val(tensor)
    route = _note("all_gather", _route(group))
    tensor_list.extend(_gather_parts(v, group, "allgather", route))
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    route = _note("all_gather_object", _route(group))
    if route == "local":
        object_list.append(obj)
        return object_list
    if route != "store":
        outs = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(outs, obj)
        object_list.extend(outs)
        return object_list
    data = torch.from_numpy(np.frombuffer(pickle.dumps(obj),
                                          dtype=np.uint8).copy())
    rows = _store_gather(data, group or _world(), "allgather_obj")
    object_list.extend(pickle.loads(r.numpy().tobytes()) for r in rows)
    return object_list


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    g = group or _world()
    route = _note("reduce_scatter", _route(group))
    if route == "local":
        tensor.copy_(_val(tensor_list[0]))
        return tensor
    stacked = torch.stack([_val(t) for t in tensor_list])
    parts = _gather_parts(stacked, g, f"reducescatter_{op}", route)
    tensor.copy_(_reduce_terms(op, parts)[_me(group)])
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    v = _val(tensor)
    route = _note("broadcast", _route(group))
    if route == "local":
        return tensor
    if route != "store":
        _start(route, [v], [], lambda x: torch.distributed.broadcast(
            x, src, async_op=True), inplace=True).wait()
        return tensor
    # src is the GLOBAL rank (reference semantics)
    g = group or _world()
    parts = _store_gather(v, g, "broadcast")
    idx = g.get_group_rank(src)
    if idx < 0:
        raise ValueError(f"broadcast src={src} is not a member of {g}")
    tensor.copy_(parts[idx])
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    all_reduce(tensor, op, group, sync_op)  # reduce-to-all covers reduce
    return tensor


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """``tensor`` of every member into ``gather_list`` on rank ``dst``;
    the others leave ``gather_list`` as it is. Always over the store
    (as JAX's)."""
    g = group or _world()
    route = "local" if _single_process() and _is_world(group) else "store"
    _note("gather", route)
    v = _val(tensor)
    if route == "local":
        if gather_list is not None:
            gather_list.append(v.clone())
        return gather_list
    parts = _store_gather(v, g, "gather")
    idx = g.get_group_rank(dst)
    if idx < 0:
        raise ValueError(f"gather dst={dst} is not a member of {g}")
    if _me(group) == idx and gather_list is not None:
        gather_list.extend(p.to(v.device) for p in parts)
    return gather_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    g = group or _world()
    route = _note("scatter", _route(group))
    if route == "local":
        if tensor_list:
            tensor.copy_(_val(tensor_list[0]))
        return tensor
    stacked = torch.stack([_val(t) for t in tensor_list]) if tensor_list \
        else torch.zeros((g.nranks,) + tuple(tensor.shape),
                         dtype=tensor.dtype, device=tensor.device)
    if route != "store":
        _start(route, [stacked], [], lambda x: torch.distributed.broadcast(
            x, src, async_op=True), inplace=True).wait()
        tensor.copy_(stacked[_my_rank()])
        return tensor
    parts = _store_gather(stacked, g, "scatter")
    idx = g.get_group_rank(src)
    if idx < 0:
        raise ValueError(f"scatter src={src} is not a member of {g}")
    tensor.copy_(parts[idx][g.rank])
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    """``in_tensor_list[j]`` (one tensor a member, of one shape) to
    member j; ``out_tensor_list`` gets member j's tensor for this member,
    in group-rank order. On gloo and nccl one ``all_to_all_single``
    moves each part once; the store gathers every member's list."""
    g = group or _world()
    if out_tensor_list is None:
        out_tensor_list = []
    route = _note("alltoall", _route(group))
    if route == "local":
        out_tensor_list.extend(_val(t).clone() for t in in_tensor_list)
        return out_tensor_list
    stacked = torch.stack([_val(t) for t in in_tensor_list])
    if route in ("gloo", "nccl"):
        got = torch.empty_like(stacked)
        _start(route, [stacked], [got], lambda i, o: torch.distributed
               .all_to_all_single(o, i, async_op=True)).wait()
        out_tensor_list.extend(got.unbind(0))
        return out_tensor_list
    rows = _gather_parts(stacked, g, "alltoall", route)
    me = _me(group)
    out_tensor_list.extend(r[me] for r in rows)
    return out_tensor_list


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    g = group or _world()
    n = 1 if (_single_process() and _is_world(group)) else g.nranks
    parts = torch.chunk(_val(in_tensor), n)
    if len(parts) != n:
        raise ValueError(f"alltoall_single: dim 0 of "
                         f"{tuple(_val(in_tensor).shape)} does not split "
                         f"into {n} parts")
    res = torch.cat(alltoall(list(parts), group=group))
    if out_tensor is not None:
        out_tensor.copy_(res)
        return out_tensor
    return res


def global_scatter(x, local_count, global_count, group=None, sync_op=True):
    """MoE expert exchange (the reference's ``global_scatter``): ``x``'s
    rows are grouped by GLOBAL expert id, ``local_count[i]`` rows for
    expert ``i``; rank r owns experts [r*e_per, (r+1)*e_per). Each rank
    receives the rows for ITS experts from every rank, ordered
    (local_expert, src_rank). A ragged exchange over
    ``all_gather_object``."""
    g = group or _world()
    lc = [int(v) for v in np.asarray(_host(local_count)).reshape(-1)]
    xv = _val(x)
    nranks = 1 if (_single_process() and _is_world(group)) else g.nranks
    if len(lc) % nranks:
        raise ValueError(
            f"local_count length {len(lc)} not divisible by world size "
            f"{nranks}")
    e_per = len(lc) // nranks
    offs = np.cumsum([0] + lc)
    if offs[-1] != xv.shape[0]:
        raise ValueError(
            f"sum(local_count)={offs[-1]} != rows of x {xv.shape[0]}")
    blocks = [xv[offs[i]:offs[i + 1]].cpu() for i in range(len(lc))]
    if nranks == 1:
        return torch.cat(blocks).to(xv.device) if blocks else xv
    gathered = []
    all_gather_object(gathered, blocks, group=g)
    me = _me(group)
    out = [gathered[r][me * e_per + i_local]
           for i_local in range(e_per) for r in range(nranks)]
    return (torch.cat(out) if out else xv[:0].cpu()).to(xv.device)


def global_gather(x, local_count, global_count, group=None, sync_op=True):
    """Inverse of :func:`global_scatter`: rows grouped (local_expert,
    src_rank), ``global_count[i_local*nranks + r]`` of them from rank
    ``r``, go back to their source ranks in the sender's
    global-expert-id grouping (``local_count``)."""
    g = group or _world()
    gc = [int(v) for v in np.asarray(_host(global_count)).reshape(-1)]
    lc = [int(v) for v in np.asarray(_host(local_count)).reshape(-1)]
    xv = _val(x)
    nranks = 1 if (_single_process() and _is_world(group)) else g.nranks
    if len(lc) != len(gc):
        raise ValueError(
            f"local_count length {len(lc)} != global_count length "
            f"{len(gc)} (both must cover all E experts)")
    if len(gc) % nranks:
        raise ValueError(
            f"global_count length {len(gc)} not divisible by world size "
            f"{nranks}")
    e_per = len(gc) // nranks
    offs = np.cumsum([0] + gc)
    if offs[-1] != xv.shape[0]:
        raise ValueError(
            f"sum(global_count)={offs[-1]} != rows of x {xv.shape[0]}")
    blocks = [xv[offs[i]:offs[i + 1]].cpu() for i in range(len(gc))]
    if nranks == 1:
        return torch.cat(blocks).to(xv.device) if blocks else xv
    gathered = []
    all_gather_object(gathered, blocks, group=g)
    me = _me(group)
    out = []
    for i in range(len(lc)):
        owner, i_local = divmod(i, e_per)
        out.append(gathered[owner][i_local * nranks + me])
    return (torch.cat(out) if out else xv[:0].cpu()).to(xv.device)


def _host(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else v


def barrier(group=None):
    route = _note("barrier", _route(group))
    if route == "local":
        return
    if route != "store":
        torch.distributed.barrier()
        return
    _store_gather(torch.zeros((), dtype=torch.int32), group or _world(),
                  "barrier")


def wait(tensor, group=None, use_calc_stream=True):
    """Wait until the work queued on ``tensor``'s card is done."""
    v = _val(tensor)
    if v.is_cuda:
        torch.cuda.synchronize(v.device)


class stream:
    """``paddle.distributed.stream.*``: the same ops."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    broadcast = staticmethod(broadcast)
    alltoall = staticmethod(alltoall)
    send = staticmethod(send)
    recv = staticmethod(recv)
