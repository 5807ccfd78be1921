"""Fleet-wide KV prefix cache: warm prefix state as a storage tier. The
port's counterpart of ``paddle_tpu/serving/prefix_cache.py``.

Every paged engine keeps a worker-LOCAL prefix index: full prompt blocks
keyed by a chained-SHA1 digest, LRU-retained at refcount 0. At fleet
scale the same prefix would be re-prefilled once per worker it lands on;
this module turns the local index into a fleet tier:

- :class:`PrefixCacheDirectory` — the fleet-level catalog. Each
  heartbeat, every paged worker publishes its registered digest chains
  (``BlockManager.registered_chains()``: digest → covered block count),
  so directory state rides the lease machinery: a dead worker's entries
  drop with its lease, an evicted block's digest vanishes on the owner's
  next beat. Lookup walks the REQUESTER's digest chain and returns the
  deepest prefix some single live owner covers consecutively from the
  root.
- :func:`extract_prefix` / :func:`adopt_prefix` — the remote fetch. The
  owner re-matches the token prefix against its OWN index (ref-acquiring
  the blocks for the copy, token-compared so a hash collision degrades
  to a shorter match, never a wrong block), ships the covered block rows
  at storage dtype as a ``pt-kv-fetch`` payload over the same v1
  serializer/CRC machinery as KV handoffs, and the requester copies them
  into freshly allocated blocks of its arena (``index_copy_``, in place:
  the captured graphs read the arena by address), registers the chain in
  its own index, and chunk-prefills only the uncovered suffix. Only the
  fetched blocks are written (the JAX scatter pads every payload to
  ``max_blocks`` to keep one jitted shape; the port runs the copy
  eagerly).

Failure semantics: a fetch that fails for ANY reason — owner dead
mid-fetch, injected ``fleet.fetch`` fault past the retry budget, CRC
mismatch, stale directory, requester pool full — falls back to LOCAL
PREFILL. Remote state is an optimization tier, not a dependency.

Metric families (JAX's names; no-ops until ``metrics.enable()`` /
``PT_METRICS``): fetches, fetched blocks/bytes, failures by reason,
duplicate responses dropped, directory entries.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..observability import metrics as _om
from .handoff import FETCH_FORMAT, KVHandoff, leaf_to_wire, wire_to_tensor

# the kv-head axis of every arena leaf's block rows (codes and int8
# scales alike): what a tensor-parallel owner's payload splits
KV_HEAD_AXIS = 2

__all__ = ["PrefixCacheDirectory", "adopt_prefix", "extract_prefix"]

_M_FETCHES = _om.counter("pt_prefix_fetches_total",
                         "remote prefix fetches adopted")
_M_FETCH_BLOCKS = _om.counter("pt_prefix_fetch_blocks_total",
                              "KV blocks adopted from remote prefix "
                              "fetches")
_M_FETCH_BYTES = _om.counter("pt_prefix_fetch_bytes_total",
                             "wire bytes of adopted prefix-fetch "
                             "payloads")
_M_FETCH_FAILS = _om.counter("pt_prefix_fetch_failures_total",
                             "prefix fetches that fell back to local "
                             "prefill, by reason", labels=("reason",))
_M_FETCH_DUPS = _om.counter("pt_prefix_fetch_duplicates_total",
                            "stale/duplicate fetch responses dropped "
                            "(at-least-once wire retransmits)")
_M_DIR_ENTRIES = _om.gauge("pt_prefix_directory_entries",
                           "distinct digest chains in the fleet prefix "
                           "directory")


class PrefixCacheDirectory:
    """Fleet-level map of registered prefix chains to owning workers.

    State is heartbeat-shaped: :meth:`publish` REPLACES a worker's entry
    set wholesale, and :meth:`drop_worker` removes a dead worker's
    entries the moment its lease expires. The directory stores no token
    data — hash collisions are caught owner-side at extract time by the
    index's stored-token comparison."""

    def __init__(self):
        self._by_worker: Dict[str, Dict[bytes, int]] = {}
        self._owners: Dict[bytes, set] = {}

    def publish(self, worker: str, chains: Dict[bytes, int]):
        """Replace ``worker``'s published digest set."""
        old = self._by_worker.get(worker, {})
        for digest in old:
            if digest not in chains:
                self._unlist(digest, worker)
        for digest in chains:
            if digest not in old:
                self._owners.setdefault(digest, set()).add(worker)
        self._by_worker[worker] = dict(chains)
        self._note()

    def drop_worker(self, worker: str):
        """Expire every entry the worker published (lease death)."""
        for digest in self._by_worker.pop(worker, {}):
            self._unlist(digest, worker)
        self._note()

    def _unlist(self, digest: bytes, worker: str):
        owners = self._owners.get(digest)
        if owners is not None:
            owners.discard(worker)
            if not owners:
                del self._owners[digest]

    def _note(self):
        if _om.enabled():
            _M_DIR_ENTRIES.set(len(self._owners))

    def owners(self, digest: bytes) -> Tuple[str, ...]:
        return tuple(sorted(self._owners.get(digest, ())))

    def size(self) -> int:
        return len(self._owners)

    def worker_entries(self, worker: str) -> Dict[bytes, int]:
        return dict(self._by_worker.get(worker, {}))

    def deepest_covered(self, prompt, block_size: int, hash_fn,
                        exclude: Iterable[str] = ()
                        ) -> Tuple[int, Tuple[str, ...]]:
        """Walk ``prompt``'s digest chain and return ``(n_blocks,
        owners)``: the deepest full-block prefix that at least one
        worker (outside ``exclude``) covers CONSECUTIVELY from the root,
        and the workers that do. A worker listing only a chain tail is
        not an owner — its own ``match_prefix`` could not serve it."""
        bs = block_size
        excl = set(exclude)
        best: Tuple[int, Tuple[str, ...]] = (0, ())
        alive: Optional[set] = None
        parent = b""
        for j in range((len(prompt) - 1) // bs):
            chunk = tuple(int(t) for t in prompt[j * bs:(j + 1) * bs])
            digest = hash_fn(parent, chunk)
            cand = {o for o in self._owners.get(digest, ())
                    if o not in excl}
            alive = cand if alive is None else (alive & cand)
            if not alive:
                break
            best = (j + 1, tuple(sorted(alive)))
            parent = digest
        return best

    def stats(self) -> dict:
        return {"entries": len(self._owners),
                "workers": sorted(self._by_worker),
                "deepest_chain": max(
                    (n for c in self._by_worker.values()
                     for n in c.values()), default=0)}


def leaf_specs(backend) -> list:
    """Canonical per-leaf KV layout (shape past the pool dim + dtype
    name): the ONE compatibility signature shared by payload producers,
    the adopt-time validators and the fleet-wide compat check — equal to
    the JAX package's for the same model and paging layout."""
    return [[list(s[1:]), d] for s, d in backend.pool_specs]


def copy_rows(engine, blocks: List[int], rows: List[np.ndarray]):
    """Write block rows (wire arrays, one per arena leaf) into
    ``blocks`` of ``engine``'s arena, IN PLACE — the shared adopt copy of
    handoffs (``DecodeWorker.adopt``) and fetches (:func:`adopt_prefix`).
    The arena tensors are the ones the captured graphs read, so nothing
    is rebound."""
    dev = engine.backend.device
    idx = torch.as_tensor(np.asarray(blocks, np.int64), device=dev)
    for t, r in zip(engine.backend.caches(), rows):
        t.index_copy_(0, idx, wire_to_tensor(r, t.dtype, dev))


def gather_rows(engine, blocks) -> List[np.ndarray]:
    """The arena rows of ``blocks`` as wire arrays, one per leaf (the
    global rows of a sharded arena)."""
    dev = engine.backend.device
    idx = torch.as_tensor(np.asarray(blocks, np.int64), device=dev)
    return [leaf_to_wire(t.index_select(0, idx))
            for t in engine.backend.caches()]


def payload_rows(engine, arrays: Dict[str, np.ndarray], blocks):
    """Put the arena rows of ``blocks`` into a fetch payload: ``kv_{i}``
    per leaf from an unsharded engine; from a tensor-parallel one, per
    leaf its ``src_tp`` per-shard chunks along the kv-head axis,
    ``kv_{i}_p{s}`` (JAX's payload; the requester joins them and splits
    the rows into its own shards). Returns the source degree, the meta's
    ``src_tp_degree``."""
    src_tp = engine.tp_degree()
    for i, rows in enumerate(gather_rows(engine, blocks)):
        if src_tp > 1:
            for s, piece in enumerate(np.split(rows, src_tp,
                                               axis=KV_HEAD_AXIS)):
                arrays[f"kv_{i}_p{s}"] = np.ascontiguousarray(piece)
        else:
            arrays[f"kv_{i}"] = rows
    return src_tp


def _logical_rows(h: KVHandoff, leaf: int, src_tp: int) -> np.ndarray:
    """One leaf's global block rows from a payload (JAX's): directly from
    an unsharded source, else its ``src_tp`` per-shard chunks joined on
    the kv-head axis (int8 scale leaves too); the arena copy splits them
    into the requester's own shards."""
    direct = h.arrays.get(f"kv_{leaf}")
    if direct is not None:
        return direct
    return np.concatenate([h.arrays[f"kv_{leaf}_p{s}"]
                           for s in range(src_tp)], axis=KV_HEAD_AXIS)


def extract_prefix(engine, tokens, n_blocks: int, skip: int = 0,
                   source: str = "") -> Optional[KVHandoff]:
    """Owner-side fetch service: build a ``pt-kv-fetch`` payload with the
    arena rows of blocks ``[skip, n_blocks)`` of ``tokens``'s digest
    chain. Returns None when this engine's index no longer covers
    ``n_blocks`` consecutive blocks (the directory was stale). The
    matched blocks are ref-acquired for the copy and released before
    returning."""
    bs = engine.kv_block_size
    sub = np.asarray(tokens[:n_blocks * bs + 1], np.int32)
    blocks = engine.manager.match_prefix(sub)
    if len(blocks) < n_blocks:
        engine.manager.release(blocks)
        return None
    arrays: Dict[str, np.ndarray] = {"tokens": sub}
    src_tp = payload_rows(engine, arrays, blocks[skip:n_blocks])
    engine.manager.release(blocks)
    meta = {
        "format": FETCH_FORMAT, "kind": "prefix",
        "n_blocks": int(n_blocks), "skip": int(skip),
        "block_size": int(bs), "kv_int8": bool(engine.kv_int8),
        "leaf_specs": leaf_specs(engine.backend),
        "src_tp_degree": int(src_tp),
        "source": {"worker": source},
    }
    return KVHandoff(meta=meta, arrays=arrays)


def adopt_prefix(engine, h: KVHandoff, local_blocks: List[int],
                 full) -> Optional[List[int]]:
    """Requester-side adopt: copy the fetched block rows into freshly
    allocated blocks of this engine's arena at exact refcounts and
    register the extended chain.

    Allocates ``n_blocks - skip`` fresh blocks (refcount 1 — the same
    hold the admitting request would have acquired by matching them
    locally), copies the rows in (:func:`copy_rows`), and registers
    ``local_blocks + fetched`` under the prompt's digest chain. Returns
    the fetched block ids, or None when the pool cannot cover them
    (caller falls back to local prefill). Raises ValueError on an
    incompatible payload — geometry mismatches are bugs, not
    fallbacks."""
    meta = h.meta
    if meta.get("kind") != "prefix":
        raise ValueError(
            f"{meta.get('kind')!r} payload on the prefix-fetch channel")
    if meta["leaf_specs"] != leaf_specs(engine.backend):
        raise ValueError(
            "prefix-fetch KV layout does not match this engine — same "
            "model config / paging layout required")
    if meta["block_size"] != engine.kv_block_size \
            or bool(meta["kv_int8"]) != bool(engine.kv_int8):
        raise ValueError(
            "prefix-fetch arena geometry mismatch (block_size/kv_int8)")
    n_blocks, skip = int(meta["n_blocks"]), int(meta["skip"])
    k = n_blocks - skip
    if k <= 0 or len(local_blocks) != skip:
        raise ValueError(
            f"prefix-fetch covers blocks [{skip}, {n_blocks}) but the "
            f"requester holds {len(local_blocks)} local blocks")
    fetched = engine.manager.allocate(k)
    if fetched is None:
        return None
    src_tp = int(meta.get("src_tp_degree", 1))
    copy_rows(engine, fetched,
              [_logical_rows(h, i, src_tp)
               for i in range(len(engine.backend.pool_specs))])
    bs = engine.kv_block_size
    engine.manager.register_prefix(
        np.asarray(full[:n_blocks * bs + 1], np.int32),
        list(local_blocks) + fetched)
    return fetched
