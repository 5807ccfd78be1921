"""KV-block handoff wire format for the disaggregated serving fleet: the
port's own copy of ``paddle_tpu/serving/handoff.py``, wire-compatible
with it (``pt-kv-handoff`` v1 and ``pt-kv-fetch`` v1).

A prefill worker that finishes a prompt owns exactly the state a decode
worker needs to continue the stream: the slot's paged KV blocks (or the
dense cache row), the in-hand first token, the post-split rng key, the
remaining token budget and the request itself. This module defines that
payload as a **versioned, bytes-true wire format**:

- ``KVHandoff`` is the in-memory form: a JSON-safe ``meta`` dict plus a
  dict of numpy arrays (prompt, rng key, per-layer KV block data).
- ``encode_handoff()``/``decode_handoff()`` round-trip it through ONE
  uncompressed npz byte buffer (no pickle); ``len(encode_handoff(h))``
  is the real wire size.
- **Bytes-true**: arrays ship at their storage dtype. An int8 KV arena
  ships int8 codes + fp32 absmax scales and is NEVER dequantized in
  transit. A bf16 arena ships its raw 16-bit words as npz's ``|V2``
  records, as the JAX package's ml_dtypes arrays do (:func:`leaf_to_wire`
  / :func:`wire_to_tensor` convert between them and torch tensors).
- Only the blocks holding PROMPT positions ship (``ceil(L/bs)`` of the
  request's ``blocks_needed`` total): decode-position blocks are junk
  the decode worker writes before it ever reads, so they cost zero
  wire bytes.

The arrays are logical (gathered to the host), so the format carries no
device layout. ``reshard_kv_chunks`` re-chunks a sharded KV axis between
two degrees one output part at a time (peak footprint one part,
arXiv:2112.01075), for fetch payloads from a tensor-parallel owner.

Rng keys ship as the JAX package's ``(2,)`` uint32 array; the port's
slot state holds them as int64 words, converted exactly at extract and
at adopt.

Fault site (``utils.faults``): ``fleet.serialize`` fires in
``encode_handoff()`` before any bytes are produced, so a retry re-extracts
and re-serializes the identical payload.
"""
from __future__ import annotations

import io
import json
import zlib
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..utils import faults

__all__ = ["FETCH_FORMAT", "HANDOFF_FORMAT", "HANDOFF_VERSION",
           "KVHandoff", "decode_handoff", "encode_handoff",
           "leaf_to_wire", "reshard_kv_chunks", "wire_to_tensor"]

HANDOFF_FORMAT = "pt-kv-handoff"
# prefix-fetch responses (serving/prefix_cache.py) ride the SAME v1
# serializer/CRC/validation machinery under their own format stamp, so
# a fetch payload mis-delivered to an adopt path is refused by kind,
# never silently armed as a stream
FETCH_FORMAT = "pt-kv-fetch"
HANDOFF_VERSION = 1
_KNOWN_FORMATS = frozenset({HANDOFF_FORMAT, FETCH_FORMAT})

# npz writes a bfloat16 array (ml_dtypes in the JAX package) as raw
# 2-byte records; numpy reads them back as this dtype
_BF16_WIRE = np.dtype("V2")


def _dtype_name(a: np.ndarray) -> str:
    """The dtype name the CRC digests: numpy's, with bf16 words named
    ``bfloat16`` as the JAX sender names them before they hit the
    wire."""
    return "bfloat16" if a.dtype == _BF16_WIRE else str(a.dtype)


def leaf_to_wire(t: torch.Tensor) -> np.ndarray:
    """A device tensor as its wire array at storage dtype (bf16 as
    ``|V2`` words)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(_BF16_WIRE)
    return t.cpu().numpy()


def wire_to_tensor(a: np.ndarray, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """A wire array as a tensor of ``dtype`` on ``device`` (``|V2``
    words viewed as bfloat16; no value is converted)."""
    a = np.ascontiguousarray(a)
    if dtype == torch.bfloat16:
        if a.dtype not in (_BF16_WIRE, np.dtype(np.int16)):
            raise ValueError(f"a {a.dtype} array cannot hold bfloat16 "
                             "words")
        return torch.from_numpy(a.view(np.int16)).to(device) \
            .view(torch.bfloat16)
    t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"wire array is {t.dtype}, the arena holds "
                         f"{dtype}")
    return t.to(device)


@dataclass
class KVHandoff:
    """One slot's portable handoff payload.

    ``meta`` (JSON-safe): ``format``/``version``, ``kind``
    ("dense"|"paged"), the serialized request
    (``resilience.request_to_meta``), the armed-slot scalars (``tok0``,
    ``pos0``, ``rem0``, dense ``pad0``), the paged geometry
    (``n_blocks`` total to allocate, ``n_ship`` actually shipped,
    ``block_size``, ``kv_int8``), per-leaf block specs for
    compatibility validation, the first-token timestamp ``t_admit``
    (TTFT keeps measuring the prefill worker's first token), and the
    ``source`` worker name + TP degree.

    ``arrays``: ``prompt`` (int32), ``key`` ((2,) uint32 — the
    post-split state key, i.e. the NEXT decode step's split input),
    and ``kv_<i>`` per cache leaf — paged: ``(n_ship, bs, ...)`` block
    rows at storage dtype; dense: the ``(1, pos0, ...)`` populated row
    prefix.
    """
    meta: dict
    arrays: Dict[str, np.ndarray]

    @property
    def request_id(self) -> int:
        return self.meta["request"]["request_id"]

    @property
    def kind(self) -> str:
        return self.meta["kind"]

    def kv_bytes(self) -> int:
        """Bytes of KV payload on the wire (codes + scales at storage
        dtype)."""
        return sum(int(v.nbytes) for k, v in self.arrays.items()
                   if k.startswith("kv_"))

    def payload_crc32(self) -> int:
        """CRC32 over every array's name, dtype, shape and raw bytes
        (name-sorted, so the digest is layout-order independent) — the
        JAX function, with bf16 words named ``bfloat16`` on both sides of
        the wire (the JAX package names them so only before encoding,
        and ``|V2`` after). The fleet stamps it into ``meta["crc32"]`` at
        ship time; ``DecodeWorker.adopt`` recomputes it BEFORE touching
        any allocator state."""
        c = 0
        for name in sorted(self.arrays):
            a = np.ascontiguousarray(self.arrays[name])
            c = zlib.crc32(
                f"{name}|{_dtype_name(a)}|{a.shape}".encode(), c)
            c = zlib.crc32(a.reshape(-1).view(np.uint8), c)  # no copy
        return c & 0xFFFFFFFF

    def verify_crc(self):
        """Raise ValueError when ``meta["crc32"]`` (if present) does
        not match the arrays actually carried."""
        want = self.meta.get("crc32")
        if want is not None and int(want) != self.payload_crc32():
            raise ValueError(
                f"handoff payload CRC mismatch (rid {self.request_id})"
                " — refusing to adopt corrupted KV state")


def encode_handoff(handoff: KVHandoff) -> bytes:
    """Serialize to one uncompressed npz byte string (bytes-true:
    int8 stays int8 on the wire). The ``fleet.serialize`` fault site
    fires BEFORE any bytes exist, so a retry is side-effect free."""
    faults.fault_point("fleet.serialize")
    bio = io.BytesIO()
    payload = dict(handoff.arrays)
    payload["__meta__"] = np.array(json.dumps(
        {"format": HANDOFF_FORMAT, "version": HANDOFF_VERSION,
         **handoff.meta}))
    np.savez(bio, **payload)
    return bio.getvalue()


def decode_handoff(data: bytes) -> KVHandoff:
    """Inverse of :func:`encode_handoff`; refuses foreign or
    future-versioned payloads loudly instead of adopting garbage into an
    arena."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta.get("format") not in _KNOWN_FORMATS:
        raise ValueError("payload is not a KV handoff")
    if meta.get("version") != HANDOFF_VERSION:
        raise ValueError(
            f"KV handoff version {meta.get('version')} unsupported "
            f"(this build reads {HANDOFF_VERSION})")
    return KVHandoff(meta=meta, arrays=arrays)


def reshard_kv_chunks(chunks: Sequence[np.ndarray], dst_parts: int,
                      axis: int = 1) -> List[np.ndarray]:
    """Re-chunk per-shard KV pieces from a source TP degree to a target
    degree along ``axis`` (the kv-head axis).

    Each output part is assembled from exactly the input slices that
    cover its index range, so peak memory is ONE output part — the full
    logical array is never materialized (arXiv:2112.01075).
    ``concatenate(result) == concatenate(chunks)`` along ``axis`` by
    construction."""
    if dst_parts < 1:
        raise ValueError(f"dst_parts={dst_parts}; must be >= 1")
    sizes = [c.shape[axis] for c in chunks]
    total = sum(sizes)
    if total % dst_parts != 0:
        raise ValueError(
            f"axis extent {total} does not divide into {dst_parts} "
            "target shards")
    per = total // dst_parts
    starts = np.cumsum([0] + sizes)
    out: List[np.ndarray] = []
    for j in range(dst_parts):
        lo, hi = j * per, (j + 1) * per
        pieces = []
        for i, c in enumerate(chunks):
            s, e = int(starts[i]), int(starts[i + 1])
            if e <= lo or s >= hi:
                continue
            sl = [slice(None)] * c.ndim
            sl[axis] = slice(max(lo - s, 0), min(hi - s, e - s))
            pieces.append(c[tuple(sl)])
        out.append(pieces[0] if len(pieces) == 1
                   else np.concatenate(pieces, axis=axis))
    return out
