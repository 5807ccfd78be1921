"""The port's datasets, samplers and DataLoader, and the device
prefetch that feeds a training step.

A copy of ``paddle_tpu/io/__init__.py``: ``Dataset``,
``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``Subset``, ``ConcatDataset``, ``random_split``, the
samplers (``SequenceSampler``, ``RandomSampler``,
``WeightedRandomSampler``, ``SubsetRandomSampler``, ``BatchSampler``,
``DistributedBatchSampler``), ``default_collate_fn``, ``DataLoader`` and
``get_worker_info``. They draw from numpy's RNG exactly as the JAX
module does, so one numpy seed gives the same order in both packages.
Collation stacks numpy arrays into CPU torch tensors with JAX's
``to_tensor`` dtype rule (float64 becomes float32 and int64 int32), so
the batches equal the JAX loader's. The loader runs synchronously
(``num_workers=0``), in threads that prefetch in order, or, with
``use_shared_memory`` where the ring builds (``core``), in forked worker
processes that only index the dataset and pickle the samples into
per-worker shared-memory rings: collation happens in the parent, so a
child never touches CUDA.

``device_prefetch`` moves batches to the card ahead of the step that
takes them: each batch is staged in pinned host memory and copied with
``non_blocking`` on a copy stream; an event orders the consumer's stream
after the copy, and ``record_stream`` keeps the allocator from reusing
the batch's memory while the consumer may still read it. At most
``size`` batches are in flight, by JAX's drain-before-transfer rule.
With ``sharding=NamedSharding(mesh, "dp")`` (``distributed.mesh``) each
leaf is split on dim 0 over the mesh axis and every device of the mesh
gets its piece, as ``jax.device_put`` with ``NamedSharding(mesh,
P("dp"))`` gives each device its addressable shard.
``DistributedBatchSampler`` defaults to the job's world size and rank
(``distributed.get_world_size``/``get_rank``: the launch contract first,
then the process group, else 1 and 0; JAX: the process count and
index)."""
from __future__ import annotations

import bisect
import collections
import math
import queue
import threading

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ChainDataset",
           "ComposeDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "DataLoader",
           "default_collate_fn", "get_worker_info", "device_prefetch",
           "ConcatDataset", "SubsetRandomSampler"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if all(isinstance(l, float) for l in lengths):
        n = len(dataset)
        lengths = [int(math.floor(n * f)) for f in lengths]
        lengths[-1] += len(dataset) - sum(lengths)
    total = sum(lengths)
    perm = np.random.permutation(total).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l]))
        off += l
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches, contiguous per-rank shards of the
    padded index list (the JAX sampler's). The replica count and rank
    default to the job's (``distributed.get_world_size``/``get_rank``,
    which read the launch contract first), or, once ``fleet.init`` laid
    out an mp, a pp or a sep axis of degree above 1, to the data-parallel
    degree and rank: the ranks of an mp group hold one model, the
    stages of one pipeline run one model, and the ranks of a sep group
    split one batch's sequences, and each takes one batch."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            from ..distributed.mesh import get_hybrid_communicate_group
            from ..distributed.parallel import get_rank, get_world_size
            hcg = get_hybrid_communicate_group()
            if hcg is not None and (hcg.axis_size("mp") > 1
                                    or hcg.axis_size("pp") > 1
                                    or hcg.axis_size("sep") > 1):
                world = hcg.get_data_parallel_world_size()
                me = hcg.get_data_parallel_rank()
            else:
                world, me = get_world_size(), get_rank()
            num_replicas = num_replicas or world
            rank = rank if rank is not None else me
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to make evenly divisible
        indices += indices[: self.total_size - n]
        # contiguous per-rank shard (paddle convention)
        indices = indices[self.local_rank * self.num_samples:
                          (self.local_rank + 1) * self.num_samples]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id=0, num_workers=1, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info


def _to_tensor(data) -> torch.Tensor:
    """A CPU tensor of ``data`` with the JAX ``to_tensor`` dtype rule:
    float64 becomes float32 and int64 int32."""
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def default_collate_fn(batch):
    """A list of samples -> one batch: tensors and numpy arrays stacked
    into a CPU tensor, numbers into a vector, tuples and lists
    transposed (a list of batches), dicts by key, strings kept as a
    list."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return _to_tensor(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return _to_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        transposed = zip(*batch)
        return [default_collate_fn(list(s)) for s in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    if isinstance(sample, str):
        return list(batch)
    return _to_tensor(np.asarray(batch))


class DataLoader:
    """Batched loader: synchronous with ``num_workers=0``; with more,
    forked worker processes over the shared-memory rings where
    ``use_shared_memory`` and the ring are usable (``_shm_usable``),
    else threads that prefetch into a bounded queue in order. Batches
    are CPU tensors (``device_prefetch`` moves them to the card)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.prefetch_factor = max(2, prefetch_factor)
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        if self._iterable_mode:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                yield self._fetch(indices)
            return
        if self.use_shared_memory and self._shm_usable():
            yield from self._iter_multiprocess()
        else:
            yield from self._iter_prefetch()

    def _shm_usable(self):
        import multiprocessing
        if multiprocessing.get_start_method(allow_none=True) not in (
                None, "fork"):
            return False  # dataset state must arrive in workers via fork
        from ..core import native_available
        return native_available()

    def _iter_multiprocess(self):
        """Forked worker processes; batches return through per-worker C++
        shared-memory rings (pickled numpy, one memcpy per side).

        Worker w owns batches w, w+nw, ... and its own ring, so the parent
        always pops exactly the ring that holds the next batch in order —
        no reorder buffer, and memory is bounded by nw ring capacities
        (a full ring back-pressures its worker)."""
        import multiprocessing
        import os
        import pickle

        from ..core import ShmQueue

        batches = list(self.batch_sampler)
        if not batches:
            return
        capacity = 32 << 20
        base = f"pt_dl_{os.getpid()}_{id(self) & 0xffffff}"
        queues = [ShmQueue(f"{base}_{w}", capacity=capacity, create=True)
                  for w in range(self.num_workers)]
        ctx = multiprocessing.get_context("fork")

        def worker_main(worker_id):
            global _worker_info
            _worker_info = _WorkerInfo(num_workers=self.num_workers,
                                       id=worker_id, dataset=self.dataset)
            if self.worker_init_fn is not None:
                self.worker_init_fn(worker_id)
            wq = ShmQueue(f"{base}_{worker_id}", capacity=capacity,
                          create=False)
            try:
                for i in range(worker_id, len(batches), self.num_workers):
                    try:
                        # raw samples only: collation happens in the
                        # parent, so the forked child never touches CUDA
                        # (a child cannot use the parent's CUDA context)
                        data = [self.dataset[j] for j in batches[i]]
                        payload = pickle.dumps(
                            data, protocol=pickle.HIGHEST_PROTOCOL)
                    except Exception as e:  # surface in parent
                        payload = pickle.dumps(e)
                    if len(payload) + 8 > capacity:
                        payload = pickle.dumps(ValueError(
                            f"batch {i} ({len(payload)}B) exceeds the "
                            f"shared-memory ring capacity ({capacity}B); "
                            "lower batch_size or pass "
                            "use_shared_memory=False"))
                    wq.put(payload)
            finally:
                wq.close()

        procs = [ctx.Process(target=worker_main, args=(w,), daemon=True)
                 for w in range(self.num_workers)]
        for p in procs:
            p.start()
        # paddle contract: timeout=0 means block indefinitely — but a dead
        # worker must raise, not hang, so poll in slices and check liveness
        deadline = self.timeout if self.timeout else None
        try:
            for i in range(len(batches)):
                w = i % self.num_workers
                waited = 0.0
                while True:
                    slice_s = 5.0 if deadline is None \
                        else min(5.0, max(0.01, deadline - waited))
                    try:
                        data = pickle.loads(
                            queues[w].get(timeout=slice_s))
                        break
                    except TimeoutError:
                        waited += slice_s
                        if procs[w].exitcode not in (None, 0):
                            raise RuntimeError(
                                f"DataLoader worker {w} died with exit "
                                f"code {procs[w].exitcode} (killed/OOM?)"
                            ) from None
                        if deadline is not None and waited >= deadline:
                            raise
                if isinstance(data, Exception):
                    raise data
                yield self.collate_fn(data)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
            for q in queues:
                q.close()

    def _iter_prefetch(self):
        q: queue.Queue = queue.Queue(self.num_workers * self.prefetch_factor)
        batches = list(self.batch_sampler)
        stop = threading.Event()
        seq_lock = threading.Lock()
        results: dict = {}
        next_submit = [0]
        _SENTINEL = object()

        def worker():
            while not stop.is_set():
                with seq_lock:
                    i = next_submit[0]
                    if i >= len(batches):
                        return
                    next_submit[0] += 1
                try:
                    data = self._fetch(batches[i])
                except Exception as e:  # surface in main thread
                    data = e
                results[i] = data
                q.put(i)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            emitted = 0
            buffered: dict = {}
            next_emit = 0
            while emitted < len(batches):
                if next_emit in buffered:
                    data = buffered.pop(next_emit)
                else:
                    i = q.get()
                    data = results.pop(i)
                    if i != next_emit:
                        buffered[i] = data
                        continue
                if isinstance(data, Exception):
                    raise data
                yield data
                emitted += 1
                next_emit += 1
        finally:
            stop.set()


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_pinned() else t.pin_memory()


def _transfer(batch, target, streams):
    """Start copying ``batch``'s tensor and numpy leaves to ``target``:
    ``(device batch, {device: event}, staged host tensors)``. A device
    takes each leaf whole; a ``NamedSharding`` turns each leaf into the
    list of its pieces, one a mesh device (``target.pieces``). On
    a card each leaf is staged in pinned memory and copied with
    ``non_blocking`` on that card's copy stream, and an event a card
    marks the copies' end; on the CPU the batch is returned as tensors,
    with no event."""
    def put(x, dev):
        if dev.type != "cuda" or x.device == dev:
            return x.to(dev)
        with torch.cuda.stream(streams[dev]):
            return x.to(dev, non_blocking=True)

    def leaf(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        whole = isinstance(target, torch.device)
        targets = [target] if whole else target.devices()
        if any(d.type == "cuda" and x.device != d for d in targets):
            x = _pinned(x)
            staged.append(x)
        if whole:
            return put(x, target)
        return [put(p, d) for p, d in zip(target.pieces(x), targets)]

    def walk(tree):
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(t) for t in tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)

    staged = []
    out = walk(batch)
    events = {}
    for dev, stream in streams.items():
        events[dev] = torch.cuda.Event()
        events[dev].record(stream)
    return out, events, staged


def _handover(entry):
    """The device batch of a ``_transfer`` entry, usable on the current
    streams: each card's current stream waits for its copies, and each
    copied tensor is recorded as used by it (the allocator does not
    reuse its memory before the consumer's work on it is done)."""
    out, events, _ = entry
    if events:
        for dev, event in events.items():
            torch.cuda.current_stream(dev).wait_event(event)

        def mark(tree):
            if isinstance(tree, (tuple, list)):
                for t in tree:
                    mark(t)
            elif isinstance(tree, dict):
                for t in tree.values():
                    mark(t)
            elif isinstance(tree, torch.Tensor) and tree.device in events:
                tree.record_stream(torch.cuda.current_stream(tree.device))
        mark(out)
    return out


def device_prefetch(loader, size=2, sharding=None, device=None):
    """Wrap a batch iterator so that batches are copied to ``device``
    (the card unless ``device="cpu"``; without a card and without
    ``device="cpu"`` it raises) ``size`` batches ahead of their
    consumer, as the JAX ``device_prefetch`` overlaps the next batch's
    host-to-device transfer with the current step. At most ``size``
    batches are in flight: a batch is yielded before the next transfer
    starts once ``size`` are pending (JAX's drain-before-transfer rule);
    ``size=0`` transfers and yields in lockstep. With ``sharding`` (a
    ``distributed.mesh.NamedSharding``) the mesh's devices take the
    place of ``device``: each leaf is yielded as the list of its dim-0
    pieces, one a mesh device in the mesh's linear order."""
    if sharding is not None:
        from ..distributed.mesh import NamedSharding
        if not isinstance(sharding, NamedSharding) or device is not None:
            raise TypeError(
                "device_prefetch: sharding= takes a distributed.mesh."
                f"NamedSharding (got {sharding!r}), and no device=")
        target = sharding
        cards = {d for d in sharding.devices() if d.type == "cuda"}
    else:
        target = resolve_device(device)
        cards = {target} if target.type == "cuda" else set()
    streams = {d: torch.cuda.Stream(d) for d in cards}
    if size <= 0:
        for batch in loader:
            yield _handover(_transfer(batch, target, streams))
        return
    pending = collections.deque()
    for batch in loader:
        # drain BEFORE transferring: at most ``size`` batches are ever
        # in flight (append-then-check kept size+1 device buffers live)
        if len(pending) >= size:
            yield _handover(pending.popleft())
        pending.append(_transfer(batch, target, streams))
    while pending:
        yield _handover(pending.popleft())


class ConcatDataset(Dataset):
    """Concatenate map-style datasets (reference: io.ConcatDataset)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self._cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self._cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(
                f"index {idx} out of range for ConcatDataset of length "
                f"{len(self)}")
        di = bisect.bisect_right(self._cum, idx)
        prev = self._cum[di - 1] if di else 0
        return self.datasets[di][idx - prev]


class SubsetRandomSampler(Sampler):
    """Sample the given indices in random order (reference parity).
    ``generator`` may be a numpy Generator/RandomState or an int seed;
    None draws from the global stream."""

    def __init__(self, indices, generator=None):
        self.indices = list(indices)
        if isinstance(generator, (int, np.integer)):
            generator = np.random.default_rng(int(generator))
        self.generator = generator

    def __iter__(self):
        rng = self.generator if self.generator is not None else np.random
        order = rng.permutation(len(self.indices))
        return iter([self.indices[i] for i in order])

    def __len__(self):
        return len(self.indices)

