"""The port's ``io`` (datasets, samplers, collation, the DataLoader in
its three modes, ``device_prefetch``) and its shared-memory ring
(``core``) against the JAX package's, on the CPU.

Both packages draw from numpy's global RNG, so the same seed gives the
same order: every batch is compared value for value and dtype for
dtype (the port's collation follows JAX's ``to_tensor``: float64 to
float32, int64 to int32)."""
import os

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio

from paddle_tpu_torch import core
from paddle_tpu_torch import io as tio


def _squares(base):
    class Squares(base.Dataset):
        """Sample i: a (3,) float64 row of i, an int64 i², and a dict."""

        def __init__(self, n=37):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return (np.full((3,), i, np.float64), np.int64(i * i),
                    {"a": np.arange(2, dtype=np.float32) + i,
                     "b": [np.int32(i), np.float32(0.5 * i)]})
    return Squares


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x._value)


def _assert_same(got, want):
    """A port batch equal to a JAX batch: structure, values, dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    else:
        a, b = _np(got), _np(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _both(seed, make):
    np.random.seed(seed)
    t = make(tio)
    np.random.seed(seed)
    j = make(jio)
    return t, j


@pytest.mark.parametrize("mode", ["sync", "threads", "forked_shm"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_dataloader_batches_equal_jax(mode, shuffle):
    nw, shm = {"sync": (0, True), "threads": (2, False),
               "forked_shm": (2, True)}[mode]

    def make(m):
        return list(m.DataLoader(_squares(m)(), batch_size=5,
                                 shuffle=shuffle, num_workers=nw,
                                 use_shared_memory=shm))
    t, j = _both(7, make)
    assert len(t) == len(j) == 8
    for a, b in zip(t, j):
        _assert_same(a, b)
    if mode == "forked_shm":
        loader = tio.DataLoader(_squares(tio)(), num_workers=2)
        assert loader._shm_usable() and core.native_available()


def test_shm_ring_is_native_and_moves_bytes():
    q = core.ShmQueue(f"pt_port_ring_{os.getpid()}", capacity=1 << 16)
    try:
        assert q.is_native
        for n in (0, 1, 1000, 30000):
            q.put(bytes(range(256)) * (n // 256) + b"x" * (n % 256))
        assert [len(q.get(timeout=1)) for _ in range(4)] == \
            [0, 1, 1000, 30000]
        with pytest.raises(TimeoutError):
            q.get(timeout=0.05)
        with pytest.raises(ValueError, match="capacity"):
            q.put(b"x" * (1 << 16))
    finally:
        q.close()


def test_dying_worker_raises():
    """A forked worker that dies (here by ``os._exit`` on sample 5, in
    batch 2, which worker 0 of 2 owns) makes the parent raise instead of
    hang."""
    class Dies(tio.Dataset):
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                os._exit(3)
            return np.float32(i)

    with pytest.raises(RuntimeError, match="worker 0 died"):
        list(tio.DataLoader(Dies(), batch_size=2, num_workers=2))


def test_worker_exception_surfaces():
    class Bad(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise KeyError("sample 3")
            return np.float32(i)

    for nw, shm in ((0, True), (2, False), (2, True)):
        with pytest.raises(KeyError, match="sample 3"):
            list(tio.DataLoader(Bad(), batch_size=2, num_workers=nw,
                                use_shared_memory=shm))


@pytest.mark.parametrize("name", ["sequence", "random", "random_replace",
                                  "random_n", "weighted", "subset_random",
                                  "subset_random_seeded", "batch",
                                  "batch_drop_last", "batch_shuffle"])
def test_samplers_equal_jax(name):
    def make(m):
        data = list(range(23))
        return {
            "sequence": lambda: m.SequenceSampler(data),
            "random": lambda: m.RandomSampler(data),
            "random_replace": lambda: m.RandomSampler(data, replacement=True,
                                                      num_samples=40),
            "random_n": lambda: m.RandomSampler(data, num_samples=9),
            "weighted": lambda: m.WeightedRandomSampler(
                np.arange(1, 24, dtype=np.float64), 30),
            "subset_random": lambda: m.SubsetRandomSampler([3, 1, 4, 15, 9]),
            "subset_random_seeded": lambda: m.SubsetRandomSampler(
                range(10, 20), generator=5),
            "batch": lambda: m.BatchSampler(data, batch_size=4),
            "batch_drop_last": lambda: m.BatchSampler(data, batch_size=4,
                                                      drop_last=True),
            "batch_shuffle": lambda: m.BatchSampler(data, shuffle=True,
                                                    batch_size=5),
        }[name]()
    t, j = _both(11, make)
    assert len(t) == len(j)
    np.random.seed(12)
    tl = [list(x) if isinstance(x, list) else x for x in t]
    np.random.seed(12)
    jl = [list(x) if isinstance(x, list) else x for x in j]
    assert tl == jl


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_shards_equal_jax(shuffle, drop_last):
    ds = list(range(29))
    shards = []
    for rank in range(3):
        t = tio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        j = jio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                        shuffle=shuffle, drop_last=drop_last)
        for epoch in (0, 2):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)
        shards.append([i for b in t for i in b])
    if not drop_last:        # the shards cover the (padded) data
        assert sorted(set(i for s in shards for i in s)) == ds


def test_distributed_batch_sampler_defaults(monkeypatch):
    """No process group: one replica, rank 0. With one: the group's
    world size and rank."""
    s = tio.DistributedBatchSampler(list(range(10)), 2)
    assert (s.nranks, s.local_rank) == (1, 0)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 2)
    s = tio.DistributedBatchSampler(list(range(10)), 2)
    assert (s.nranks, s.local_rank) == (4, 2)
    assert list(s) == [[6, 7], [8]]


def test_datasets_equal_jax():
    def make(m):
        a = m.TensorDataset([np.arange(12).reshape(6, 2),
                             np.arange(6) * 10])
        b = m.Subset(a, [5, 0, 3])
        c = m.ConcatDataset([a, b])
        d = m.ComposeDataset([a, a])
        splits = m.random_split(a, [2, 4])
        fsplits = m.random_split(a, [0.5, 0.5])
        return ([a[i] for i in range(len(a))], [b[i] for i in range(3)],
                [c[i] for i in range(len(c))] + [c[-1]],
                [d[i] for i in range(len(d))],
                [[s[i] for i in range(len(s))] for s in splits + fsplits])
    t, j = _both(4, make)
    assert repr(t) == repr(j)
    with pytest.raises(IndexError):
        tio.ConcatDataset([tio.TensorDataset([np.arange(3)])])[3]


def test_iterable_and_chain_datasets():
    def make(m):
        class It(m.IterableDataset):
            def __init__(self, lo, hi):
                self.lo, self.hi = lo, hi

            def __iter__(self):
                yield from (np.float32(i) for i in range(self.lo, self.hi))
        chain = m.ChainDataset([It(0, 4), It(10, 13)])
        return (list(m.DataLoader(It(0, 10), batch_size=4)),
                list(m.DataLoader(It(0, 10), batch_size=4, drop_last=True)),
                list(m.DataLoader(chain, batch_size=3)))
    t, j = _both(0, make)
    _assert_same(t, j)


def test_collation_nested_and_dict():
    samples = [{"x": (np.full((2,), i, np.float64), [np.int64(i), "s"]),
                "t": torch.full((2, 2), i)} for i in range(3)]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn([{"x": s["x"]} for s in samples])
    _assert_same(got["x"][0], want["x"][0])
    _assert_same(got["x"][1][0], want["x"][1][0])
    assert got["x"][1][1] == ["s", "s", "s"]
    assert got["t"].shape == (3, 2, 2) and got["t"].dtype == torch.int64
    x = got["x"][0]
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"


def test_get_worker_info_in_workers():
    """In a forked worker ``get_worker_info()`` names the worker; in the
    parent it is None."""
    class Who(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            info = tio.get_worker_info()
            return np.int32(-1 if info is None else info.id)

    assert tio.get_worker_info() is None
    ids = [int(x) for b in tio.DataLoader(Who(), batch_size=1,
                                          num_workers=2) for x in b]
    assert ids == [0, 1, 0, 1]


# -- device_prefetch ---------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 2, 3])
def test_prefetch_honors_size_exactly(monkeypatch, size):
    """JAX's ``test_prefetch_honors_size_exactly`` (tests/test_io.py):
    at most ``size`` batches in flight (transferred, not yet yielded;
    lockstep at 0), order kept."""
    state = {"transferred": 0, "yielded": 0, "max_in_flight": 0}
    real = tio._transfer

    def counting(batch, device, stream):
        state["transferred"] += 1
        state["max_in_flight"] = max(state["max_in_flight"],
                                     state["transferred"] - state["yielded"])
        return real(batch, device, stream)

    monkeypatch.setattr(tio, "_transfer", counting)
    batches = [np.full((2,), i, "float32") for i in range(8)]
    out = []
    for b in tio.device_prefetch(iter(batches), size=size, device="cpu"):
        state["yielded"] += 1
        out.append(float(b[0]))
    assert out == [float(i) for i in range(8)]
    assert state["transferred"] == 8
    assert state["max_in_flight"] <= max(size, 1), state


def test_prefetch_on_cpu_keeps_structure_and_refuses_the_rest(monkeypatch):
    loader = tio.DataLoader(_squares(tio)(9), batch_size=4)
    got = list(tio.device_prefetch(loader, device="cpu"))
    for a, b in zip(got, loader):
        assert isinstance(a[2], dict) and a[0].device.type == "cpu"
        _assert_same(a, b)
    with pytest.raises(TypeError, match="NamedSharding"):
        next(tio.device_prefetch(iter([np.zeros(2)]), sharding="dp",
                                 device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        next(tio.device_prefetch(iter([np.zeros(2)])))


def test_loader_feeds_a_train_step():
    """A DataLoader over (ids, labels) samples, through
    ``device_prefetch``, into ``TrainStep``: the losses equal those of
    the same batches fed directly."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.optimizer import AdamW

    class Seqs(tio.Dataset):
        def __init__(self):
            rs = np.random.RandomState(0)
            self.ids = rs.randint(0, 512, (8, 16)).astype(np.int32)

        def __len__(self):
            return len(self.ids)

        def __getitem__(self, i):
            return self.ids[i], np.roll(self.ids[i], -1)

    losses = []
    for fed in ("loader", "direct"):
        m = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=0)
        step = TrainStep(m, lambda mm, b: mm(*b)[0],
                         AdamW(learning_rate=1e-3,
                               parameters=m.parameters()))
        if fed == "loader":
            src = tio.device_prefetch(
                tio.DataLoader(Seqs(), batch_size=2, num_workers=2),
                size=2, device="cpu")
            losses.append([float(step(tuple(b))) for b in src])
        else:
            ds = Seqs()
            losses.append([float(step((ds.ids[i:i + 2],
                                       np.roll(ds.ids[i:i + 2], -1, 1))))
                           for i in range(0, 8, 2)])
    assert losses[0] == losses[1] and len(losses[0]) == 4
