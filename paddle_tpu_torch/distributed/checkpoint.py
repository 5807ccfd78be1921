"""Distributed checkpoint with reshard-on-load, async save and
region-wise (bounded-memory) load, and the crash-safe file writes.

Counterpart of ``paddle_tpu/distributed/checkpoint.py``, with its
on-disk layout, so a directory written by either package loads in the
other:

- one ``shard_{rank}.npz`` a rank (the rank in the process group, JAX's
  process index), holding the rank's pieces as ``{key}__{rank}``;
- ``metadata.json``: ``{key: {"kind": "tensor", "shape", "dtype",
  "shards": [{"array", "index", "file"}]}}`` (or ``{"kind": "scalar",
  "value"}``), merged from every rank through ``all_gather_object`` and
  written last, atomically, by the coordinator;
- bf16 stored as raw ``|V2`` words, the dtype restored from the
  metadata.

What a rank writes: the region of a :class:`~paddle_tpu_torch.
distributed.sharding.ShardedTensor` (a sharded slot, a stage-3
parameter at rest, an mp slice of ``convert.jax_state_dict``: its
first holder only), and a plain tensor whole on the coordinator only
(JAX writes a replicated array's replica 0 once). Nested dicts flatten
to dotted keys. ``load_state_dict`` fills the target dict's tensors in
place, resharding: each rank reads only the saved pieces overlapping
its target region (a ``ShardedTensor``'s region, else the whole
tensor), assembles each region once, and its largest host buffer is
one target region, never the global tensor (``_last_load_stats``): the
saved pieces are memory-mapped, so only their overlapping pages are
read.

``async_save=True`` copies the device regions to the host now, gathers
the metadata on the main thread (a collective, in order with the
step's), and writes the files on a thread; ``wait_async_save()`` joins
the writes.

Differences from the JAX package, for a job of several processes:

- **The commit point is ordered across ranks.** JAX's npz path relies on
  the writes being ordered within one process. Here every rank's shard
  file lands before the coordinator writes ``metadata.json``: a barrier
  on the group (sync saves), or the job's TCP store (the writer threads
  of async saves: each rank's thread sets a key after its shard is
  written and the coordinator's waits for all). A rank that dies
  between its shard and the metadata leaves the directory without
  ``metadata.json`` (a previous checkpoint elsewhere stays loadable).
  A save into a directory that holds a checkpoint first joins this
  process's unfinished async writes there, and the coordinator removes
  the old ``metadata.json`` before the metadata gather, which no rank
  passes before any shard is written: a save cut short there leaves no
  metadata to load a mix of old and new shards by.
- ``load_state_dict`` also sets a scalar of the target dict (``@step``)
  from the saved value; JAX leaves scalars as they are.
- ``backend="tensorstore"`` is not ported (``ROADMAP.md`` A.6: the
  machine with the card has no ``tensorstore``): it raises.

The crash-safe writes (``atomic_write``, ``atomic_savez``,
``atomic_json_dump``) are the serving snapshots' and the flight
recorder's too."""
from __future__ import annotations

import json
import os
import struct
import threading
import zipfile
from typing import Optional

import numpy as np
import torch

__all__ = ["save_state_dict", "load_state_dict", "wait_async_save",
           "AsyncSaveHandle", "atomic_write", "atomic_savez",
           "atomic_json_dump"]


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


# ---------------------------------------------------------------------------
# save_state_dict / load_state_dict
# ---------------------------------------------------------------------------

_ASYNC: list = []
# the most recent load's largest host buffer (tests read it)
_last_load_stats = {"max_buffer_bytes": 0}
_SAVES = {"n": 0}       # saves this process started (store keys)


def _leaf_items(state_dict, prefix=""):
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaf_items(v, key)
        else:
            yield key, v, state_dict, k


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host snapshot of ``t`` as numpy (a copy: later steps may write
    the tensor); bf16 as raw ``|V2`` words, as JAX's npz stores it."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


class AsyncSaveHandle:
    def __init__(self, thread: threading.Thread, path: str = ""):
        self._thread = thread
        self.path = path
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None):
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in progress")
        if self._error is not None:
            raise self._error


def wait_async_save():
    """Join every outstanding async checkpoint write (call before a
    relaunch, and before reading the directory)."""
    while _ASYNC:
        _ASYNC.pop().result()


def _group_of(process_group):
    from . import communication as C
    return process_group, C._me(process_group), \
        (process_group.nranks if process_group is not None
         else C._world_size())


def _barrier(group):
    """Every member's shard is written (sync saves): a barrier on the
    group."""
    from . import communication as C
    C.barrier(group)


def _store_commit_wait(tag: str, rank: int, n: int, coordinator: int):
    """The async saves' barrier, from a writer thread: this rank's key
    in the job's TCP store (a connection of the thread's own), and on
    the coordinator a wait for every member's."""
    from ..core.native_api import TCPStore
    from ..utils.flags import env_str
    host, port = env_str("PADDLE_MASTER", "").rsplit(":", 1)
    store = TCPStore(host, int(port))
    try:
        store.set(f"{tag}/{rank}", b"1")
        if rank == coordinator:
            for r in range(n):
                store.wait(f"{tag}/{r}")
            for r in range(n):
                store.delete_key(f"{tag}/{r}")
    finally:
        store.close()


def save_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, async_save=False,
                    backend="npz"):
    """Write this rank's pieces of ``state_dict`` and, on the
    coordinator once every rank's file is written, the merged metadata
    (module docstring). ``async_save=True`` returns an
    :class:`AsyncSaveHandle` after the host snapshot and the metadata
    gather; the files are written on a thread."""
    if backend != "npz":
        raise NotImplementedError(
            f"save_state_dict(backend={backend!r}): only the npz backend "
            "is ported; the tensorstore backend waits on ROADMAP.md A.6 "
            "(the machine with the card has no tensorstore)")
    from . import communication as C
    from .sharding import ShardedTensor
    group, rank, n = _group_of(process_group)
    os.makedirs(path, exist_ok=True)
    for h in [h for h in _ASYNC if h.path == os.path.abspath(path)]:
        _ASYNC.remove(h)
        h.result()
    if rank == coordinator_rank:      # the old commit point goes first
        old = os.path.join(path, "metadata.json")
        if os.path.exists(old):
            os.remove(old)
            _fsync_dir(path)
    fname = f"shard_{rank}.npz"
    meta, arrays = {}, {}
    for key, v, _, _ in _leaf_items(state_dict):
        if isinstance(v, ShardedTensor):
            local, index, gshape = v.local, v.region, list(v.shape)
            # an unsharded region is replicated: the coordinator writes
            # it; a region several ranks hold, its first holder
            mine = (v.dim is not None and v.replica == 0) \
                or rank == coordinator_rank
        elif isinstance(v, (torch.Tensor, np.ndarray)):
            local = torch.as_tensor(v)
            gshape = list(local.shape)
            index = [[0, d] for d in gshape]
            mine = rank == coordinator_rank
        else:
            meta[key] = {"kind": "scalar", "value": v}
            continue
        shards = []
        if mine:
            aid = f"{key}__{rank}"
            arrays[aid] = _to_host(local)
            shards.append({"array": aid, "index": index, "file": fname})
        meta[key] = {"kind": "tensor", "shape": gshape,
                     "dtype": _dtype_name(local.dtype), "shards": shards}
    # the gather is a collective: on the main thread, in order with the
    # step's collectives, and after the coordinator's removal of the old
    # metadata; only the file writes go to the thread
    metas = [meta]
    if n > 1:
        metas = []
        C.all_gather_object(metas, meta, group=group)
    merged: dict = {}
    for m in metas:
        for k, info in m.items():
            if k not in merged:
                merged[k] = info
            elif info["kind"] == "tensor":
                merged[k]["shards"].extend(info["shards"])
    tag = None
    if async_save and n > 1:
        C._get_store()           # the job's store is up (rank 0 hosts it)
        _SAVES["n"] += 1
        tag = (f"pt_ckpt/{unique_id or os.path.abspath(path)}/"
               f"{_SAVES['n']}")

    def write(handle=None):
        try:
            atomic_savez(os.path.join(path, fname), arrays)
            if n > 1:
                if tag is None:
                    _barrier(group)
                else:
                    _store_commit_wait(tag, rank, n, coordinator_rank)
            if rank == coordinator_rank:
                atomic_json_dump(os.path.join(path, "metadata.json"),
                                 merged)
        except BaseException as e:     # surfaced by handle.result()
            if handle is None:
                raise
            handle._error = e

    if not async_save:
        write()
        return None
    thread = threading.Thread(target=lambda: write(handle), daemon=True)
    handle = AsyncSaveHandle(thread, os.path.abspath(path))
    thread.start()
    _ASYNC.append(handle)
    return handle


def _np_dtype(name: str) -> np.dtype:
    """The numpy storage dtype of a saved dtype name (bf16: uint16
    words)."""
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


class _ShardFile:
    """One ``shard_{rank}.npz``: each member as a read-only memory map
    where it is stored uncompressed (``np.savez``'s layout), so reading
    a region touches only its pages and no host buffer holds a whole
    saved piece; a compressed member is read whole."""

    def __init__(self, path: str):
        self.path = path
        self.zf = zipfile.ZipFile(path)

    def __getitem__(self, name: str) -> np.ndarray:
        info = self.zf.getinfo(name + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with self.zf.open(info) as f:
                return np.lib.format.read_array(f)
        with open(self.path, "rb") as f:
            f.seek(info.header_offset)
            head = f.read(30)
            name_len, extra_len = struct.unpack("<HH", head[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = np.lib.format.read_array_header_1_0 \
                if version == (1, 0) else \
                np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read_header(f)
            offset = f.tell()
        if int(np.prod(shape)) == 0:
            return np.empty(shape, dtype)
        return np.memmap(self.path, dtype=dtype, mode="r", offset=offset,
                         shape=shape, order="F" if fortran else "C")

    def close(self):
        self.zf.close()


def _read_piece(npz, s, want: np.dtype) -> np.ndarray:
    """One saved piece as ``want`` (npz keeps bf16 as raw ``|V2``
    words: a view restores them)."""
    data = np.asarray(npz[s["array"]])
    if data.dtype != want and data.dtype.itemsize == want.itemsize \
            and data.dtype.kind == "V":
        data = data.view(want)
    return data


def _assemble_region(region, shards, shard_data, saved: np.dtype):
    """One target region as a host buffer, filled from every saved piece
    that overlaps it."""
    buf = np.zeros([b - a for a, b in region], dtype=saved)
    _last_load_stats["max_buffer_bytes"] = max(
        _last_load_stats["max_buffer_bytes"], buf.nbytes)
    for s in shards:
        inter = [(max(a, sa), min(b, sb))
                 for (a, b), (sa, sb) in zip(region, s["index"])]
        if any(a >= b for a, b in inter):
            continue
        data = _read_piece(shard_data(s["file"]), s, saved)
        src = tuple(slice(a - sa, b - sa)
                    for (a, b), (sa, _) in zip(inter, s["index"]))
        dst = tuple(slice(a - ra, b - ra)
                    for (a, b), (ra, _) in zip(inter, region))
        buf[dst] = data[src]
    return buf


def _to_tensor(buf: np.ndarray, saved_name: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(buf))
    return t.view(torch.bfloat16) if saved_name == "bfloat16" else t


def load_state_dict(state_dict, path, process_group=None,
                    coordinator_rank=0, unique_id=None, offload=False):
    """Fill ``state_dict``'s tensors in place from ``path``, resharding
    to each target: a ``ShardedTensor`` gets its region, a tensor the
    whole value, converted to the target's dtype; a scalar leaf takes
    the saved value. Keys missing from the checkpoint are left as they
    are."""
    from .sharding import ShardedTensor
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    cache: dict = {}
    _last_load_stats["max_buffer_bytes"] = 0

    def shard_data(fname):
        if fname not in cache:
            cache[fname] = _ShardFile(os.path.join(path, fname))
        return cache[fname]

    try:
        for key, v, parent, k in _leaf_items(state_dict):
            info = meta.get(key)
            if info is None:
                continue
            if info["kind"] != "tensor":
                if not isinstance(v, (torch.Tensor, ShardedTensor)):
                    parent[k] = info["value"]
                continue
            gshape = tuple(info["shape"])
            if isinstance(v, ShardedTensor):
                target, reg = v.local, v.region
                if v.shape != gshape:
                    raise ValueError(f"{key}: saved {gshape}, target "
                                     f"{v.shape}")
            elif isinstance(v, torch.Tensor):
                target, reg = v, [[0, d] for d in gshape]
                if tuple(v.shape) != gshape:
                    raise ValueError(f"{key}: saved {gshape}, target "
                                     f"{tuple(v.shape)}")
            else:
                continue
            buf = _assemble_region(reg, info["shards"], shard_data,
                                   _np_dtype(info["dtype"]))
            with torch.no_grad():
                target.copy_(_to_tensor(buf, info["dtype"]).to(
                    target.dtype))
    finally:
        for z in cache.values():
            z.close()
