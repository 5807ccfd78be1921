"""Durable fleet control plane: write-ahead journal, checkpoint
manifests, and a disk spill tier for evicted prefix chains. The port's
counterpart of ``paddle_tpu/serving/durability.py``; the bytes on disk
are the JAX package's, so either package replays the other's directory.

Every failure domain of the fleet before this one (snapshot/restore,
leases and redrive, below-min repair) assumes the fleet *process*
survives: router registries, ship/dedup records, the prefix directory
and fleet-durable results live in its memory, so a kill of the whole
process loses every stream in flight. This module makes the control
plane itself durable:

- :class:`WriteAheadJournal` — an fsync'd append-only segment of
  control-plane transitions (submit, ship with its rng key and seq,
  adopt, heartbeat progress high-water marks, terminal rows, scale
  actions). A frame is a big-endian header ``magic|seq|payload_len``,
  a JSON payload (sorted keys, ``(",", ":")`` separators) and a CRC32
  trailer over header and payload: the same record gives the same
  bytes in both packages. Replay walks frames until the first short or
  CRC-bad one, TRUNCATES the torn tail with a warning, and returns every
  intact record. The ``journal.write`` / ``journal.torn_tail`` fault
  sites cover both edges.
- Checkpoint manifests — ``Fleet.checkpoint`` snapshots every live
  worker's Server (npz files in the JAX schema and dtypes, which both
  packages restore), then commits the fleet's registries, topology and
  flight ring by renaming a ``manifest-<epoch>.json`` into place
  (:func:`write_manifest`, through ``distributed.checkpoint
  .atomic_json_dump``, which fsyncs the file and its parent directory).
  The rename is the commit point; :func:`load_latest_manifest` walks
  epochs newest first and discards torn or invalid manifests with a
  warning. ``checkpoint.commit`` fires the instant before the rename.
- :class:`PrefixSpillStore` — watermark-evicted prefix chains land on
  disk as ``pt-kv-fetch`` payload bytes (the serializer and CRC of the
  fleet's fetch path, so a spilled int8 chain stays codes and scales).
  Extraction reads the index without touching hit counts or LRU order
  (a spill must not change which block the eviction that follows it
  picks); the arena rows are copied from the device to the host in the
  tick that evicts them. Reads verify the CRC, compare tokens (a
  collision is a miss, never a wrong block) and fire ``spill.read``;
  any failure is a miss and the requester prefills locally, bit for
  bit the same. An LRU byte cap bounds the tier.

Replay is idempotent under the one crash window the commit order leaves
open (manifest N committed, journal N not yet rotated): progress records
only EXTEND a stream's token high-water mark, terminals are first write
wins, and topology records are set operations.
"""
from __future__ import annotations

import json
import os
import struct
import time
import warnings
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..distributed.checkpoint import atomic_json_dump
from ..observability import metrics as _om
from ..utils import faults
from .handoff import FETCH_FORMAT, KVHandoff, decode_handoff, encode_handoff
from .prefix_cache import leaf_specs, payload_rows

__all__ = ["JOURNAL_MAGIC", "MANIFEST_FORMAT", "PrefixSpillStore",
           "WriteAheadJournal", "extract_chain", "journal_path",
           "list_epochs", "load_latest_manifest", "manifest_path",
           "slice_prefix_payload", "snapshot_path", "write_manifest"]

# durability metric families (JAX's names, registered at import; no-ops
# until metrics.enable() / PT_METRICS)
_M_J_APPENDS = _om.counter("pt_journal_appends_total",
                           "control-plane records appended to the "
                           "write-ahead journal")
_M_J_BYTES = _om.counter("pt_journal_bytes_total",
                         "bytes fsync'd into write-ahead journal "
                         "segments")
_M_J_REPLAYS = _om.counter("pt_journal_replays_total",
                           "journal records replayed during recovery")
_M_J_TORN = _om.counter("pt_journal_torn_tails_total",
                        "torn/CRC-bad journal tails truncated at "
                        "replay")
_M_CKPT_COMMITS = _om.counter("pt_checkpoint_commits_total",
                              "coordinated fleet checkpoints committed "
                              "(manifest renamed into place)")
_M_CKPT_RECOVERIES = _om.counter("pt_checkpoint_recoveries_total",
                                 "cold-start fleet recoveries from a "
                                 "durability directory")
_M_SPILL_WRITES = _om.counter("pt_prefix_spill_writes_total",
                              "evicted prefix chains spilled to disk")
_M_SPILL_HITS = _om.counter("pt_prefix_spill_hits_total",
                            "prefix fetches served from the disk "
                            "spill tier")
_M_SPILL_MISSES = _om.counter("pt_prefix_spill_misses_total",
                              "spill-tier reads that fell back "
                              "(fault/CRC/collision/pool-full)")

# ---------------------------------------------------------------------------
# write-ahead journal
# ---------------------------------------------------------------------------

#: ``>4sQI`` header (magic | record seq | payload length), JSON payload,
#: then a ``>I`` CRC32 trailer over header and payload.
JOURNAL_MAGIC = b"PTJ1"
_HDR = struct.Struct(">4sQI")
_CRC = struct.Struct(">I")
#: a corrupt header must not make replay attempt a multi-GB read before
#: the CRC catches it
_MAX_PAYLOAD = 64 * 1024 * 1024


def _frame(seq: int, payload: bytes) -> bytes:
    head = _HDR.pack(JOURNAL_MAGIC, seq, len(payload))
    return head + payload + _CRC.pack(zlib.crc32(head + payload))


class WriteAheadJournal:
    """One fsync'd append-only journal segment.

    ``append`` frames a JSON record, fires ``journal.write`` BEFORE any
    byte touches the file (an injected failure leaves the segment clean
    for the retry), writes, flushes and fsyncs. ``journal.torn_tail``
    instead writes half a frame and raises: the on-disk artifact of a
    crash mid-append, which :meth:`replay` truncates with a warning. A
    half frame followed by a retried full copy makes replay roll back to
    the half frame's boundary and LOSE the records after it — consistent
    but lossy, as a real torn tail is; recovery redrives the lost
    streams under the same ids."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self.appends = 0
        self.bytes_written = 0
        self.append_s = 0.0            # host seconds inside append()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")
        self._seq = 0
        if self._f.tell():
            # recovery continues a segment: the seq goes on past its
            # intact records
            records, _ = self.replay(path, truncate=False)
            self._seq = len(records)

    def empty(self) -> bool:
        return self._f.tell() == 0

    @property
    def seq(self) -> int:
        return self._seq

    def append(self, record: dict) -> int:
        """Frame and fsync one record; returns its seq. Raises
        ``InjectedFault`` from an armed ``journal.write`` (before any
        byte: retryable) or ``journal.torn_tail`` (after half a frame:
        the crash artifact)."""
        faults.fault_point("journal.write")
        t0 = time.perf_counter()
        payload = json.dumps(record, separators=(",", ":"),
                             sort_keys=True).encode("utf-8")
        frame = _frame(self._seq, payload)
        if faults.should_fire("journal.torn_tail"):
            self._f.write(frame[:max(1, len(frame) // 2)])
            self._f.flush()
            os.fsync(self._f.fileno())
            raise faults.InjectedFault(
                "injected fault at journal.torn_tail")
        self._f.write(frame)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self._seq += 1
        self.appends += 1
        self.bytes_written += len(frame)
        self.append_s += time.perf_counter() - t0
        if _om.enabled():
            _M_J_APPENDS.inc()
            _M_J_BYTES.inc(len(frame))
        return self._seq - 1

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass                # interpreter teardown: best effort

    @staticmethod
    def replay(path: str, truncate: bool = True
               ) -> Tuple[List[dict], bool]:
        """Every intact record of a segment; returns ``(records,
        torn)``. The first short, CRC-bad or out-of-sequence frame ends
        the walk: what follows it is a torn tail, warned about and (by
        default) truncated off the file, so the reopened segment appends
        from a clean boundary."""
        if not os.path.exists(path):
            return [], False
        with open(path, "rb") as f:
            blob = f.read()
        records: List[dict] = []
        off = 0
        torn = False
        while off < len(blob):
            if off + _HDR.size > len(blob):
                torn = True
                break
            magic, seq, plen = _HDR.unpack_from(blob, off)
            end = off + _HDR.size + plen + _CRC.size
            if magic != JOURNAL_MAGIC or plen > _MAX_PAYLOAD \
                    or seq != len(records) or end > len(blob):
                torn = True
                break
            body = blob[off:off + _HDR.size + plen]
            (crc,) = _CRC.unpack_from(blob, off + _HDR.size + plen)
            if crc != zlib.crc32(body):
                torn = True
                break
            try:
                records.append(json.loads(
                    body[_HDR.size:].decode("utf-8")))
            except ValueError:
                torn = True
                break
            off = end
        if torn:
            warnings.warn(
                f"journal {os.path.basename(path)}: torn tail at byte "
                f"{off} ({len(blob) - off} bytes discarded after "
                f"{len(records)} intact records)", RuntimeWarning,
                stacklevel=2)
            _M_J_TORN.inc()
            if truncate:
                with open(path, "r+b") as f:
                    f.truncate(off)
                    f.flush()
                    os.fsync(f.fileno())
        return records, torn


# ---------------------------------------------------------------------------
# checkpoint manifests
# ---------------------------------------------------------------------------

MANIFEST_FORMAT = "pt-fleet-manifest"
MANIFEST_VERSION = 1


def journal_path(dirname: str, epoch: int) -> str:
    return os.path.join(dirname, f"journal-{epoch:08d}.log")


def manifest_path(dirname: str, epoch: int) -> str:
    return os.path.join(dirname, f"manifest-{epoch:08d}.json")


def snapshot_path(dirname: str, epoch: int, worker: str) -> str:
    return os.path.join(dirname, f"ckpt-{epoch:08d}-{worker}.npz")


def list_epochs(dirname: str, prefix: str) -> List[int]:
    """Epochs present for ``prefix`` (``'manifest'``/``'journal'``),
    ascending."""
    out = []
    for name in os.listdir(dirname):
        if not name.startswith(prefix + "-"):
            continue
        stem = name[len(prefix) + 1:].split(".", 1)[0]
        if stem.isdigit():
            out.append(int(stem))
    return sorted(set(out))


def write_manifest(dirname: str, epoch: int, manifest: dict) -> str:
    """Commit a checkpoint manifest atomically: the rename inside
    ``atomic_json_dump`` IS the commit point. ``checkpoint.commit``
    fires the instant before it (every snapshot written, nothing
    committed)."""
    path = manifest_path(dirname, epoch)
    doc = dict(manifest, format=MANIFEST_FORMAT,
               version=MANIFEST_VERSION, epoch=int(epoch))
    faults.fault_point("checkpoint.commit")
    atomic_json_dump(path, doc)
    if _om.enabled():
        _M_CKPT_COMMITS.inc()
    return path


def load_latest_manifest(dirname: str
                         ) -> Tuple[Optional[int], Optional[dict]]:
    """The newest VALID manifest. A torn or invalid one is skipped with
    a warning, falling back to the previous epoch."""
    if not os.path.isdir(dirname):
        return None, None
    for epoch in reversed(list_epochs(dirname, "manifest")):
        path = manifest_path(dirname, epoch)
        try:
            with open(path, "r") as f:
                doc = json.load(f)
            if doc.get("format") != MANIFEST_FORMAT:
                raise ValueError(f"bad format {doc.get('format')!r}")
            if int(doc.get("version", -1)) > MANIFEST_VERSION:
                raise ValueError(
                    f"manifest version {doc.get('version')} is newer "
                    f"than this build supports ({MANIFEST_VERSION})")
            return epoch, doc
        except (OSError, ValueError) as e:
            warnings.warn(
                f"discarding invalid checkpoint manifest "
                f"{os.path.basename(path)}: {e}", RuntimeWarning,
                stacklevel=2)
    return None, None


# ---------------------------------------------------------------------------
# disk spill tier for evicted prefix chains
# ---------------------------------------------------------------------------

def _chain_block_ids(manager, tokens, n_blocks: int
                     ) -> Optional[List[int]]:
    """Walk ``tokens``'s digest chain through the manager's index
    WITHOUT the side effects of ``match_prefix`` (no ref acquire, no hit
    count, no LRU move). Safe because the fleet tick is single-threaded:
    nothing evicts between this walk and the row copy."""
    bs = manager.block_size
    parent = b""
    out: List[int] = []
    for j in range(n_blocks):
        chunk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
        if len(chunk) < bs:
            return None
        digest = manager.hash_fn(parent, chunk)
        entry = manager._index.get(digest)
        if entry is None or entry[1] != chunk:
            return None
        out.append(entry[0])
        parent = digest
    return out


def extract_chain(engine, tokens, n_blocks: int,
                  source: str = "") -> Optional[KVHandoff]:
    """Side-effect-free twin of ``prefix_cache.extract_prefix``: a
    ``pt-kv-fetch`` payload (``skip=0``) of blocks ``[0, n_blocks)`` of
    ``tokens``'s chain, the arena rows read on the device and copied to
    the host at storage dtype (bf16 as ``|V2`` words). The meta has the
    fetch's shape, so ``adopt_prefix`` takes a spilled payload as it
    takes a live fetch. A tensor-parallel engine's payload carries its
    per-shard chunks and ``src_tp_degree`` (JAX's, through
    ``prefix_cache.payload_rows``)."""
    bs = engine.kv_block_size
    blocks = _chain_block_ids(engine.manager, tokens, n_blocks)
    if blocks is None:
        return None
    arrays: Dict[str, np.ndarray] = {
        "tokens": np.asarray(tokens[:n_blocks * bs], np.int32)}
    src_tp = payload_rows(engine, arrays, blocks)
    meta = {
        "format": FETCH_FORMAT, "kind": "prefix",
        "n_blocks": int(n_blocks), "skip": 0,
        "block_size": int(bs), "kv_int8": bool(engine.kv_int8),
        "leaf_specs": leaf_specs(engine.backend),
        "src_tp_degree": int(src_tp),
        "source": {"worker": source, "spilled": True},
    }
    return KVHandoff(meta=meta, arrays=arrays)


def slice_prefix_payload(h: KVHandoff, n_local: int) -> KVHandoff:
    """Re-skip a stored ``skip=0`` spill payload for a requester that
    already holds ``n_local`` chain blocks: drop the covered rows (axis
    0, the block axis of every leaf) and stamp ``skip=n_local`` so
    ``adopt_prefix`` allocates only the rest. The CRC is not restamped:
    it was verified against the whole stored payload before slicing."""
    if n_local <= 0:
        return h
    meta = dict(h.meta, skip=int(n_local))
    meta.pop("crc32", None)
    arrays = {}
    for name, a in h.arrays.items():
        arrays[name] = a if name == "tokens" else a[n_local:]
    return KVHandoff(meta=meta, arrays=arrays)


class PrefixSpillStore:
    """LRU-capped disk tier for watermark-evicted prefix chains.

    Files are raw ``encode_handoff`` bytes (npz + ``__meta__`` + CRC,
    the wire format at storage dtype) named
    ``spill-<depth>-<digest>.kv``, so the index rebuilds from a directory
    listing alone. Writes drop the oldest entries past ``max_bytes``;
    reads refresh recency. Every read re-verifies the payload CRC and the
    caller compares the stored chain's tokens: any failure is a MISS,
    never a wrong block."""

    FILE_PREFIX = "spill-"
    FILE_SUFFIX = ".kv"

    def __init__(self, dirname: str, max_bytes: int = 1 << 28):
        self.dir = dirname
        self.max_bytes = int(max_bytes)
        self.writes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.write_s = 0.0            # host seconds in put()'s writes
        self.read_s = 0.0             # host seconds in read()
        os.makedirs(dirname, exist_ok=True)
        # digest hex -> (depth, file size); insertion order is the LRU
        self._index: "OrderedDict[str, Tuple[int, int]]" = OrderedDict()
        for name in sorted(os.listdir(dirname)):
            if not (name.startswith(self.FILE_PREFIX)
                    and name.endswith(self.FILE_SUFFIX)):
                continue
            stem = name[len(self.FILE_PREFIX):-len(self.FILE_SUFFIX)]
            depth_s, _, hexd = stem.partition("-")
            if not depth_s.isdigit() or not hexd:
                continue
            size = os.path.getsize(os.path.join(dirname, name))
            self._index[hexd] = (int(depth_s), size)

    def _path(self, hexdigest: str, depth: int) -> str:
        return os.path.join(
            self.dir,
            f"{self.FILE_PREFIX}{depth:04d}-{hexdigest}{self.FILE_SUFFIX}")

    def total_bytes(self) -> int:
        return sum(size for _, size in self._index.values())

    def __len__(self) -> int:
        return len(self._index)

    def depth_of(self, digest: bytes) -> int:
        entry = self._index.get(digest.hex())
        return entry[0] if entry is not None else 0

    def put(self, digest: bytes, h: KVHandoff) -> bool:
        """Store one extracted chain payload; the oldest entries go past
        the byte cap. A digest already stored at >= depth is left alone
        (the deeper chain covers the shallower)."""
        depth = int(h.meta["n_blocks"])
        hexd = digest.hex()
        have = self._index.get(hexd)
        if have is not None and have[0] >= depth:
            return False
        t0 = time.perf_counter()
        h.meta["crc32"] = h.payload_crc32()
        blob = encode_handoff(h)
        if len(blob) > self.max_bytes:
            return False
        if have is not None:
            self._drop(hexd)
        path = self._path(hexd, depth)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        self._index[hexd] = (depth, len(blob))
        self.writes += 1
        self.write_s += time.perf_counter() - t0
        if _om.enabled():
            _M_SPILL_WRITES.inc()
        while self.total_bytes() > self.max_bytes \
                and len(self._index) > 1:
            oldest = next(iter(self._index))
            if oldest == hexd:
                break
            self._drop(oldest)
            self.evictions += 1
        return True

    def _drop(self, hexd: str):
        depth, _ = self._index.pop(hexd)
        try:
            os.remove(self._path(hexd, depth))
        except OSError:
            pass

    def lookup(self, prompt, block_size: int, hash_fn
               ) -> Tuple[int, Optional[bytes]]:
        """Deepest spilled digest on ``prompt``'s chain; the walk
        mirrors ``PrefixCacheDirectory.deepest_covered`` (full blocks
        only, consecutive from the root)."""
        best: Tuple[int, Optional[bytes]] = (0, None)
        parent = b""
        for j in range((len(prompt) - 1) // block_size):
            chunk = tuple(int(t) for t in
                          prompt[j * block_size:(j + 1) * block_size])
            digest = hash_fn(parent, chunk)
            entry = self._index.get(digest.hex())
            if entry is not None and entry[0] == j + 1:
                best = (j + 1, digest)
            parent = digest
        return best

    def read(self, digest: bytes) -> KVHandoff:
        """Load and CRC-verify one stored payload, refreshing recency.
        Raises (``InjectedFault``/``OSError``/``ValueError``: an armed
        ``spill.read``, an unreadable file, a CRC or format mismatch);
        the caller counts a miss and falls back."""
        hexd = digest.hex()
        entry = self._index.get(hexd)
        if entry is None:
            raise ValueError(f"digest {hexd[:12]} not in spill index")
        faults.fault_point("spill.read")
        t0 = time.perf_counter()
        depth, _ = entry
        with open(self._path(hexd, depth), "rb") as f:
            blob = f.read()
        h = decode_handoff(blob)
        h.verify_crc()
        self._index.move_to_end(hexd)
        self.read_s += time.perf_counter() - t0
        return h

    def note_hit(self):
        self.hits += 1
        if _om.enabled():
            _M_SPILL_HITS.inc()

    def note_miss(self):
        self.misses += 1
        if _om.enabled():
            _M_SPILL_MISSES.inc()

    def stats(self) -> dict:
        return {"entries": len(self._index),
                "bytes": self.total_bytes(),
                "max_bytes": self.max_bytes,
                "writes": self.writes, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "deepest": max((d for d, _ in self._index.values()),
                               default=0)}
