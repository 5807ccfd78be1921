"""The port's eager collectives and p2p against the JAX package's, on the
CPU.

Each group collective of ``tests/test_communication.py`` runs on two
group members driven from threads (the store route over the in-process
store, as JAX's tests run it), in both packages on the same numpy
inputs: data movement exact, reductions too (the store sums the members'
parts in rank order in both). Then one job of two processes on gloo
(``init_parallel_env(device="cpu")``) runs every world collective and
p2p through the store in the same two processes; its reductions are
held against JAX's ``_reduce_terms`` on the same inputs within 1e-6
relative (a ring sums in its own order), and both ranks must hold the
same bits."""
import json
import os
import textwrap
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import communication as jcomm

import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.distributed import communication as tcomm
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# workers of a launched job: the repo importable, one thread a process
JOB_ENV = {"OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            "")}
REDUCE_RTOL = 1e-6
OPS = ["sum", "max", "min", "prod", "avg"]


def _members(pkg, body, gid, nranks=2):
    """``body(group, r)`` on a thread per member of a ``gid`` group whose
    local rank is pinned; the members' results in rank order."""
    base = jcomm.Group if pkg == "jax" else tcomm.Group

    class Fake(base):
        def __init__(self, r):
            super().__init__(list(range(nranks)), gid)
            self._my = r

        @property
        def rank(self):
            return self._my

    results, errs = [None] * nranks, []

    def run(r):
        try:
            results[r] = body(Fake(r), r)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,))
               for r in range(nranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errs, errs
    assert not any(t.is_alive() for t in threads)
    return results


def _inputs(r, shape=(2, 3)):
    return np.random.RandomState(r).randn(*shape).astype(np.float32)


def _both(body_jax, body_port, gid):
    return (_members("jax", body_jax, gid),
            _members("port", body_port, gid + 1000))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x._value if hasattr(x, "_value") else x)


@pytest.mark.parametrize("op", OPS)
def test_group_all_reduce_equals_jax(op):
    def j(g, r):
        x = paddle.to_tensor(_inputs(r))
        jcomm.all_reduce(x, op=op, group=g)
        return _np(x)

    def t(g, r):
        x = torch.from_numpy(_inputs(r))
        tcomm.all_reduce(x, op=op, group=g)
        return _np(x)

    jr, tr = _both(j, t, 200 + OPS.index(op))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tr[0], tr[1])


def _movement_cases():
    def all_gather(m, g, r, x, X):
        out = []
        m.all_gather(out, X(x), group=g)
        return np.stack([_np(o) for o in out])

    def broadcast(m, g, r, x, X):
        y = X(x)
        m.broadcast(y, src=1, group=g)
        return _np(y)

    def reduce_scatter(m, g, r, x, X):
        y = X(np.zeros(3, np.float32))
        m.reduce_scatter(y, [X(x[0]), X(x[1])], group=g)
        return _np(y)

    def alltoall(m, g, r, x, X):
        return np.stack([_np(o) for o in
                         m.alltoall([X(x[0]), X(x[1])], group=g)])

    def alltoall_single(m, g, r, x, X):
        return _np(m.alltoall_single(X(x), group=g))

    def scatter(m, g, r, x, X):
        y = X(np.zeros(3, np.float32))
        m.scatter(y, [X(x[0]), X(x[1])], src=0, group=g)
        return _np(y)

    def gather(m, g, r, x, X):
        out = []
        m.gather(X(x), out, dst=0, group=g)
        return np.stack([_np(o) for o in out]) if out else None

    def all_gather_object(m, g, r, x, X):
        out = []
        m.all_gather_object(out, {"rank": r, "sum": float(x.sum())},
                            group=g)
        return out

    def barrier(m, g, r, x, X):
        m.barrier(group=g)
        return True

    return [all_gather, broadcast, reduce_scatter, alltoall,
            alltoall_single, scatter, gather, all_gather_object, barrier]


@pytest.mark.parametrize("case", _movement_cases(), ids=lambda f: f.__name__)
def test_group_collective_equals_jax(case):
    gid = 300 + [c.__name__ for c in _movement_cases()].index(case.__name__)
    jr, tr = _both(
        lambda g, r: case(jcomm, g, r, _inputs(r), paddle.to_tensor),
        lambda g, r: case(tcomm, g, r, _inputs(r), torch.from_numpy), gid)
    for a, b in zip(jr, tr):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_global_scatter_gather_equals_jax():
    """The MoE exchange of ``tests/test_communication.py``: 2 ranks x 4
    experts with ragged row counts, and its exact round trip."""
    e_per = 2
    lcs = {0: [1, 0, 2, 1], 1: [2, 1, 0, 1]}

    def rows(r):
        return np.asarray([[r * 100 + i * 10 + j]
                           for i, c in enumerate(lcs[r]) for j in range(c)],
                          np.float32)

    def body(m, X):
        def run(g, r):
            gc = [lcs[src][r * e_per + i] for i in range(e_per)
                  for src in (0, 1)]
            y = m.global_scatter(X(rows(r)), lcs[r], gc, group=g)
            back = m.global_gather(y, lcs[r], gc, group=g)
            return _np(y), _np(back)
        return run

    jr, tr = _both(body(jcomm, paddle.to_tensor),
                   body(tcomm, torch.from_numpy), 400)
    for r in (0, 1):
        np.testing.assert_array_equal(jr[r][0], tr[r][0])
        np.testing.assert_array_equal(tr[r][1], rows(r))


def test_world_collectives_single_process_identity():
    tcomm.reset_counters()
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(tdist.all_reduce(x), torch.tensor([1.0, 2.0]))
    outs = []
    tdist.all_gather(outs, torch.tensor([3.0]))
    assert len(outs) == 1 and float(outs[0][0]) == 3.0
    objs = []
    tdist.all_gather_object(objs, {"a": 1})
    assert objs == [{"a": 1}]
    tdist.barrier()
    assert tcomm.route_counts()["all_reduce"] == {"local": 1}
    assert tdist.get_backend() == "LOCAL" and not tdist.is_initialized()


def test_p2p_in_one_process():
    """Self-sends, async tasks, batches and FIFO order per pair (JAX's
    single-process p2p tests)."""
    dst = torch.zeros(3)
    tdist.send(torch.tensor([1.0, 2.0, 3.0]), dst=0)
    tdist.recv(dst, src=0)
    assert dst.tolist() == [1, 2, 3]
    buf = torch.zeros(2)
    task_r = tdist.irecv(buf, src=0)
    tdist.isend(torch.tensor([5.0, 6.0]), dst=0).wait()
    task_r.wait()
    assert buf.tolist() == [5, 6]
    a, b = torch.zeros(2), torch.zeros(2)
    ops = [tcomm.P2POp(tcomm.isend, torch.tensor([1.0, 2.0]), 0),
           tcomm.P2POp(tcomm.isend, torch.tensor([3.0, 4.0]), 0),
           tcomm.P2POp(tcomm.irecv, a, 0), tcomm.P2POp(tcomm.irecv, b, 0)]
    for task in tdist.batch_isend_irecv(ops):
        task.wait()
    assert a.tolist() == [1, 2] and b.tolist() == [3, 4]
    with pytest.raises(ValueError):
        tdist.batch_isend_irecv([tcomm.P2POp(print, torch.zeros(1), 0)])
    tdist.send(torch.zeros(4), dst=0)
    with pytest.raises(ValueError, match="recv"):
        tdist.recv(torch.zeros(3), src=0)


class TestBulkSizeGuard:
    """JAX's guard on the store transport: warn once per op, raise, or
    off, past ``PT_EAGER_COLLECTIVE_WARN_MB``."""

    def test_warn_once_per_op(self, monkeypatch):
        monkeypatch.setenv("PT_EAGER_COLLECTIVE_WARN_MB", "0.001")
        monkeypatch.setattr(tcomm, "_BULK_WARNED_OPS", set())
        big = torch.zeros(4096)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tcomm._warn_if_bulk(big, "allgather")
            tcomm._warn_if_bulk(big, "allgather")
            tcomm._warn_if_bulk(big, "scatter")
        assert len([x for x in w if "TCP store" in str(x.message)]) == 2

    def test_error_and_off(self, monkeypatch):
        monkeypatch.setenv("PT_EAGER_COLLECTIVE_WARN_MB", "0.001")
        monkeypatch.setenv("PT_EAGER_COLLECTIVE_GUARD", "error")
        with pytest.raises(RuntimeError, match="TCP store"):
            tcomm._warn_if_bulk(torch.zeros(4096), "alltoall")
        monkeypatch.setenv("PT_EAGER_COLLECTIVE_GUARD", "off")
        monkeypatch.setattr(tcomm, "_BULK_WARNED_OPS", set())
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tcomm._warn_if_bulk(torch.zeros(4096), "gather")
        assert not [x for x in w if "TCP store" in str(x.message)]


_JOB = r"""
import json, os, sys
import numpy as np
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import communication as C

env = dist.init_parallel_env(device="cpu")
rank, n = dist.get_rank(), dist.get_world_size()
x = torch.from_numpy(np.random.RandomState(rank).randn(2, 3)
                     .astype(np.float32))
out = {}
for op in ("sum", "max", "min", "prod", "avg"):
    y = x.clone()
    dist.all_reduce(y, op=op)
    out["all_reduce_" + op] = y
lst = []
dist.all_gather(lst, x)
out["all_gather"] = torch.stack(lst)
y = x.clone()
dist.broadcast(y, src=1)
out["broadcast"] = y
y = torch.zeros(3)
dist.reduce_scatter(y, [x[0], x[1]])
out["reduce_scatter"] = y
y = torch.zeros(3)
dist.scatter(y, [x[0], x[1]] if rank == 0 else None, src=0)
out["scatter"] = y
out["alltoall"] = torch.stack(dist.alltoall([x[0], x[1]]))
out["alltoall_single"] = dist.alltoall_single(x)
gl = []
dist.gather(x, gl, dst=0)
if rank == 0:
    out["gather"] = torch.stack(gl)
objs = []
dist.all_gather_object(objs, {"rank": rank})
dist.barrier()
# p2p through the store, in the same two processes
peer = 1 - rank
b16 = (x * (rank + 1)).to(torch.bfloat16)
dist.send(x * 10, dst=peer)
dist.send(b16, dst=peer)
got, got16 = torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.bfloat16)
dist.recv(got, src=peer)
dist.recv(got16, src=peer)
out["p2p"] = got
out["p2p_bf16"] = got16.float()
# a subset group: rank 0 takes no part
g = dist.new_group([1])
if rank == 1:
    y = x.clone()
    dist.all_reduce(y, group=g)
    out["subset"] = y
np.savez(os.path.join(sys.argv[1], f"rank{rank}.npz"),
         **{k: v.numpy() for k, v in out.items()})
with open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w") as f:
    json.dump({"objs": objs, "routes": C.route_counts(),
               "backend": dist.get_backend(), "init": dist.is_initialized(),
               "store_native": C._get_store().is_native}, f)
dist.barrier()
dist.destroy_process_group()
"""


def test_two_process_gloo_job_matches_jax(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent(_JOB))
    cfg = LaunchConfig(str(script), [str(tmp_path)], nproc_per_node=2,
                       log_dir=str(tmp_path / "log"),
                       envs=JOB_ENV)
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text() for p in (tmp_path / "log").iterdir()}
    assert rc == 0, logs
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]
    meta = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in (0, 1)]
    xs = [np.random.RandomState(r).randn(2, 3).astype(np.float32)
          for r in (0, 1)]
    jx = [jnp.asarray(v) for v in xs]
    for op in OPS:
        want = np.asarray(jcomm._reduce_terms(op, jx))
        np.testing.assert_allclose(res[0][f"all_reduce_{op}"], want,
                                   rtol=REDUCE_RTOL)
        np.testing.assert_array_equal(res[0][f"all_reduce_{op}"],
                                      res[1][f"all_reduce_{op}"])
    for r in (0, 1):
        got = res[r]
        np.testing.assert_array_equal(got["all_gather"], np.stack(xs))
        np.testing.assert_array_equal(got["broadcast"], xs[1])
        np.testing.assert_allclose(
            got["reduce_scatter"],
            np.asarray(jcomm._reduce_terms("sum", [v[r] for v in jx])),
            rtol=REDUCE_RTOL)
        np.testing.assert_array_equal(got["scatter"], xs[0][r])
        np.testing.assert_array_equal(got["alltoall"],
                                      np.stack([v[r] for v in xs]))
        np.testing.assert_array_equal(got["alltoall_single"],
                                      np.stack([v[r] for v in xs]))
        np.testing.assert_array_equal(got["p2p"], xs[1 - r] * 10)
        np.testing.assert_array_equal(
            got["p2p_bf16"], torch.from_numpy(xs[1 - r] * (2 - r))
            .to(torch.bfloat16).float().numpy())
        assert meta[r]["objs"] == [{"rank": 0}, {"rank": 1}]
        assert meta[r]["backend"] == "GLOO" and meta[r]["init"]
        routes = meta[r]["routes"]
        assert routes["all_reduce"]["gloo"] == len(OPS)
        assert routes["send"] == {"store": 2} and \
            routes["gather"] == {"store": 1}
    np.testing.assert_array_equal(res[0]["gather"], np.stack(xs))
    np.testing.assert_array_equal(res[1]["subset"], xs[1])
    assert meta[1]["routes"]["all_reduce"]["store"] == 1
    assert "store" not in meta[0]["routes"]["all_reduce"]


def test_init_parallel_env_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdist.init_parallel_env()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        tdist.init_parallel_env(device="cpu")
