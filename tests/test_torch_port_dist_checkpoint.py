"""The port's distributed checkpoint against the JAX package, on the CPU.

Both packages write one layout (``shard_{rank}.npz`` a rank, the merged
``metadata.json``, bf16 as raw ``|V2`` words), so a directory of either
loads in the other. Held, bit for bit unless stated:

- one-process round trips (fp32, bf16, async, scalars, an optimizer's
  state), the tensorstore backend refused by name;
- reshard on load between 1, 2 and 4 ranks (gloo processes: one job of
  2 and one of 4 ranks, ``launch_pod`` of the worker below), each rank's
  largest host buffer one target region;
- a directory JAX saved from its 8 simulated devices loads in the port
  at 1 and 2 ranks, and the port's 2-rank directories (sync and async)
  load in JAX's ``load_state_dict``;
- the port's counterpart of ``tests/test_process_golden.py``: 2 port
  ranks train data-parallel (AdamW, ``fused_allreduce_gradients``) from
  the JAX model's weights and save their regions in JAX's layout; JAX
  loads them within 1e-5 of its serial run on the whole batch;
- the commit point: a rank killed between its shard file and the
  metadata leaves that directory without ``metadata.json``, and the
  previous checkpoint still loads; killed while saving over a
  checkpoint, the directory holds no metadata, so no mix of old and
  new shards loads."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import (ProcessMesh, Replicate, Shard,
                                    shard_tensor)
from paddle_tpu.distributed import checkpoint as jckpt

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.optimizer import AdamW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_STEPS, GOLDEN_LR = 5, 1e-2

WORKER = r'''
import json, os, sys
import numpy as np
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import group_sharded_parallel
from paddle_tpu_torch.distributed.fleet.utils import \
    fused_allreduce_gradients
from paddle_tpu_torch.distributed.sharding import ShardedTensor
from paddle_tpu_torch.optimizer import AdamW

root, mode = sys.argv[1], sys.argv[2]
dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
z = np.load(os.path.join(root, "data.npz"))
W = torch.from_numpy(z["w"])
B = torch.from_numpy(z["b_bits"]).view(torch.bfloat16)
R = torch.from_numpy(z["r"])
out, rec = {}, {}


def targets(shapes):
    return {"w": ShardedTensor.shard(torch.zeros(shapes["w"])),
            "b": ShardedTensor.shard(torch.zeros(shapes["b"],
                                                 dtype=torch.bfloat16)),
            "r": torch.zeros(shapes["r"])}


def keep(tag, sd):
    for k, v in sd.items():
        if isinstance(v, ShardedTensor):
            out[f"{tag}/{k}"] = v.local.view(torch.int16).numpy() \
                if v.dtype == torch.bfloat16 else v.local.numpy()
            rec[f"{tag}/{k}/region"] = v.region
        elif isinstance(v, torch.Tensor):
            out[f"{tag}/{k}"] = v.numpy()
    rec[f"{tag}/max_buffer"] = ck._last_load_stats["max_buffer_bytes"]


shapes = {"w": tuple(W.shape), "b": tuple(B.shape), "r": tuple(R.shape)}
for src in ("jax8", "port1", "port2"):
    if os.path.exists(os.path.join(root, src, "metadata.json")) \
            and not (mode == "save2" and src == "port2"):
        sd = targets(shapes)
        ck.load_state_dict(sd, os.path.join(root, src))
        keep(src, sd)

if mode == "save2":
    state = {"w": ShardedTensor.shard(W), "b": ShardedTensor.shard(B),
             "r": R, "nested": {"step": 7}}
    ck.save_state_dict(state, os.path.join(root, "port2"))
    h = ck.save_state_dict(state, os.path.join(root, "port2a"),
                           async_save=True)
    h.result(timeout=60)
    rec["async_done"] = h.done()
    ck.wait_async_save()
    # the optimizer state of a group-sharded AdamW, round trip
    torch.manual_seed(0)
    net = torch.nn.Linear(8, 16)
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())
    group_sharded_parallel(net, opt, "os")
    (net(torch.ones(4, 8)) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()
    ck.save_state_dict({"model": net.state_dict(), "opt": opt.state_dict()},
                       os.path.join(root, "optrt"))
    torch.manual_seed(1)
    net2 = torch.nn.Linear(8, 16)
    opt2 = AdamW(learning_rate=1e-3, parameters=net2.parameters())
    group_sharded_parallel(net2, opt2, "os")
    (net2(torch.ones(4, 8)) ** 2).mean().backward()
    opt2.step()
    opt2.clear_grad()
    sd = {"model": net2.state_dict(), "opt": opt2.state_dict()}
    ck.load_state_dict(sd, os.path.join(root, "optrt"))
    net2.load_state_dict(sd["model"])
    opt2.set_state_dict(sd["opt"])
    rec["opt_round_trip"] = all(
        torch.equal(a, b) for a, b in zip(net.parameters(),
                                          net2.parameters())) and all(
        torch.equal(opt._slots[id(p)][k], opt2._slots[id(p2)][k])
        for p, p2 in zip(net.parameters(), net2.parameters())
        for k in ("moment1", "moment2")) \
        and opt2._step_count == opt._step_count == 1
    # the process-golden counterpart: DP over the halves, JAX's layout
    g = np.load(os.path.join(root, "golden_init.npz"))
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 2))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.from_numpy(g[n]))
    opt = AdamW(learning_rate=float(sys.argv[3]),
                parameters=net.parameters())
    half = g["x"].shape[0] // world
    x = torch.from_numpy(g["x"][rank * half:(rank + 1) * half])
    y = torch.from_numpy(g["y"][rank * half:(rank + 1) * half])
    for _ in range(int(sys.argv[4])):
        ((net(x) - y) ** 2).mean().backward()
        fused_allreduce_gradients(list(net.parameters()))
        opt.step()
        opt.clear_grad()
    ck.save_state_dict(
        {n: ShardedTensor.shard(p.detach().T.contiguous()
                                if n.endswith("weight") else p.detach())
         for n, p in net.named_parameters()}, os.path.join(root, "golden"))

if mode in ("kill", "resave"):
    state = {"w": ShardedTensor.shard(W), "r": R}
    ck.save_state_dict(state, os.path.join(root, "ok"))
    # resave: the torn save goes into a directory that holds a checkpoint
    torn = os.path.join(root, "ok" if mode == "resave" else "torn")
    C.barrier()
    if rank == 1:
        def die(group):       # after this rank's shard, before the commit
            os._exit(3)
        ck._barrier = die
    ck.save_state_dict({"w": ShardedTensor.shard(W * 2), "r": R}, torn)

np.savez(os.path.join(root, f"{mode}_rank{rank}.npz"), **out)
with open(os.path.join(root, f"{mode}_rank{rank}.json"), "w") as f:
    json.dump(rec, f)
C.barrier()
C.destroy_process_group()
'''


def _rnd(rs, *shape):
    return rs.rand(*shape).astype(np.float32)


def _golden_jax():
    """``tests/test_process_golden.py``'s network and data, AdamW: the
    initial weights (JAX's layout) and the serial run's final ones."""
    paddle.seed(0)
    net = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 2))
    init = {k: np.asarray(v._value) for k, v in net.state_dict().items()}
    opt = joptimizer.AdamW(learning_rate=GOLDEN_LR,
                           parameters=net.parameters())
    rs = np.random.RandomState(42)
    x = rs.rand(16, 8).astype("float32")
    y = rs.rand(16, 2).astype("float32")
    for _ in range(GOLDEN_STEPS):
        loss = ((net(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    final = {k: np.asarray(v._value) for k, v in net.state_dict().items()}
    return init, final, x, y


def _run_job(root, world, mode, expect_ok=True):
    script = root / "ckpt_worker.py"
    script.write_text(WORKER)
    cfg = LaunchConfig(
        str(script), [str(root), mode, str(GOLDEN_LR), str(GOLDEN_STEPS)],
        nproc_per_node=world, log_dir=str(root / f"log_{mode}"),
        envs={"OMP_NUM_THREADS": "1",
              "PYTHONPATH": REPO + os.pathsep
              + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    if expect_ok:
        logs = {p.name: p.read_text()[-3000:]
                for p in (root / f"log_{mode}").iterdir()}
        assert rc == 0, logs
        return [(json.loads((root / f"{mode}_rank{r}.json").read_text()),
                 dict(np.load(root / f"{mode}_rank{r}.npz")))
                for r in range(world)]
    return rc


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(3)
    w = _rnd(rs, 64, 128)
    b = jnp.asarray(_rnd(rs, 8, 8), jnp.bfloat16)
    r = _rnd(rs, 3, 5)
    return w, np.asarray(b), r


@pytest.fixture(scope="module")
def dirs(tmp_path_factory, data):
    """The JAX 8-device save, the port's one-process save, then the
    2-rank job (loads, its saves, the golden run) and the 4-rank job
    (loads)."""
    root = tmp_path_factory.mktemp("dckpt")
    w, b, r = data
    np.savez(root / "data.npz", w=w, b_bits=b.view(np.uint16).view(
        np.int16), r=r)
    m1 = ProcessMesh(list(range(8)), dim_names=["x"])
    m2 = ProcessMesh(np.arange(8).reshape(4, 2).tolist(),
                     dim_names=["x", "y"])
    jckpt.save_state_dict(
        {"w": shard_tensor(paddle.to_tensor(w), m1, [Shard(0)]),
         "b": shard_tensor(paddle.to_tensor(jnp.asarray(b)), m2,
                           [Shard(0), Shard(1)]),
         "r": shard_tensor(paddle.to_tensor(r), m2,
                           [Replicate(), Replicate()])}, str(root / "jax8"))
    ckpt.save_state_dict(
        {"w": torch.from_numpy(w), "r": torch.from_numpy(r),
         "b": torch.from_numpy(b.view(np.int16).copy()).view(
             torch.bfloat16)},
        str(root / "port1"))
    init, final, x, y = _golden_jax()
    port_init = {k: (v.T.copy() if k.endswith("weight") else v)
                 for k, v in init.items()}
    np.savez(root / "golden_init.npz", x=x, y=y, **port_init)
    two = _run_job(root, 2, "save2")
    four = _run_job(root, 4, "load4")
    return root, two, four, final


def _want_region(full, region):
    return full[tuple(slice(a, b) for a, b in region)]


def _bits(a):
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _check_job(recs, data, src):
    w, b, r = data
    for rec, arrs in recs:
        np.testing.assert_array_equal(
            arrs[f"{src}/w"], _want_region(w, rec[f"{src}/w/region"]))
        np.testing.assert_array_equal(
            arrs[f"{src}/b"], _want_region(_bits(b), rec[f"{src}/b/region"]))
        np.testing.assert_array_equal(arrs[f"{src}/r"], r)


def test_one_process_round_trip_bf16_and_scalars(tmp_path):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(_rnd(rs, 8, 6))
    bf = torch.from_numpy(_rnd(rs, 8, 8)).to(torch.bfloat16)
    ckpt.save_state_dict({"w": x, "opt": {"b": bf, "@step": 3}},
                         str(tmp_path))
    tgt = {"w": torch.zeros(8, 6),
           "opt": {"b": torch.zeros(8, 8, dtype=torch.bfloat16),
                   "@step": 0}, "absent": torch.ones(2)}
    ckpt.load_state_dict(tgt, str(tmp_path))
    assert torch.equal(tgt["w"], x)
    assert tgt["opt"]["b"].dtype == torch.bfloat16
    assert torch.equal(tgt["opt"]["b"].view(torch.int16),
                       bf.view(torch.int16))
    assert tgt["opt"]["@step"] == 3 and torch.equal(tgt["absent"],
                                                    torch.ones(2))
    meta = json.loads((tmp_path / "metadata.json").read_text())
    assert meta["opt.b"]["dtype"] == "bfloat16"
    assert meta["opt.@step"] == {"kind": "scalar", "value": 3}
    with np.load(tmp_path / "shard_0.npz") as z:
        assert z["opt.b__0"].dtype == np.dtype("V2")


def test_one_process_async_round_trip(tmp_path):
    x = torch.from_numpy(_rnd(np.random.RandomState(1), 8, 6))
    h = ckpt.save_state_dict({"w": x}, str(tmp_path), async_save=True)
    x.zero_()                      # the snapshot was taken at the call
    h.result(timeout=60)
    assert h.done()
    ckpt.wait_async_save()
    tgt = {"w": torch.ones(8, 6)}
    ckpt.load_state_dict(tgt, str(tmp_path))
    assert torch.equal(tgt["w"], torch.from_numpy(_rnd(
        np.random.RandomState(1), 8, 6)))


def test_optimizer_state_round_trip_one_process(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Linear(8, 16)
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())
    (net(torch.ones(4, 8)) ** 2).mean().backward()
    opt.step()
    ckpt.save_state_dict({"model": net.state_dict(),
                          "opt": opt.state_dict()}, str(tmp_path))
    torch.manual_seed(1)
    net2 = torch.nn.Linear(8, 16)
    opt2 = AdamW(learning_rate=1e-3, parameters=net2.parameters())
    opt2.functional_state()        # slots to load into, as JAX's
    sd = {"model": net2.state_dict(), "opt": opt2.state_dict()}
    ckpt.load_state_dict(sd, str(tmp_path))
    net2.load_state_dict(sd["model"])
    opt2.set_state_dict(sd["opt"])
    assert torch.equal(net2.weight, net.weight)
    assert opt2._step_count == 1
    for p, p2 in zip(net.parameters(), net2.parameters()):
        for k in ("moment1", "moment2"):
            assert torch.equal(opt._slots[id(p)][k], opt2._slots[id(p2)][k])


def test_tensorstore_backend_is_refused_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        ckpt.save_state_dict({"w": torch.ones(2)}, str(tmp_path),
                             backend="tensorstore")
    assert not (tmp_path / "metadata.json").exists()


def test_jax_eight_devices_load_in_the_port_at_one_rank(dirs, data):
    root = dirs[0]
    w, b, r = data
    tgt = {"w": torch.zeros(64, 128), "r": torch.zeros(3, 5),
           "b": torch.zeros(8, 8, dtype=torch.bfloat16)}
    ckpt.load_state_dict(tgt, str(root / "jax8"))
    np.testing.assert_array_equal(tgt["w"].numpy(), w)
    np.testing.assert_array_equal(tgt["r"].numpy(), r)
    np.testing.assert_array_equal(tgt["b"].view(torch.int16).numpy(),
                                  _bits(b))


def test_jax_eight_devices_load_in_the_port_at_two_ranks(dirs, data):
    _, two, _, _ = dirs
    _check_job(two, data, "jax8")
    for rec, _ in two:   # one half of (64, 128) fp32 (its longer dim)
        assert rec["jax8/w/region"][1][1] - rec["jax8/w/region"][1][0] \
            == 64
        assert rec["jax8/max_buffer"] <= 64 * 128 * 4 // 2


def test_reshard_one_to_two_ranks(dirs, data):
    _check_job(dirs[1], data, "port1")


def test_reshard_two_to_four_ranks_bounded_by_a_region(dirs, data):
    _, _, four, _ = dirs
    _check_job(four, data, "port2")
    regions = sorted(tuple(map(tuple, rec["port2/w/region"]))
                     for rec, _ in four)
    assert regions == [((0, 64), (0, 32)), ((0, 64), (32, 64)),
                       ((0, 64), (64, 96)), ((0, 64), (96, 128))]
    for rec, _ in four:
        assert rec["port2/max_buffer"] <= 64 * 128 * 4 // 4


@pytest.mark.parametrize("src", ["port2", "port2a"])
def test_reshard_two_ranks_to_one(dirs, data, src):
    root = dirs[0]
    w, b, r = data
    tgt = {"w": torch.zeros(64, 128), "r": torch.zeros(3, 5),
           "b": torch.zeros(8, 8, dtype=torch.bfloat16),
           "nested": {"step": 0}}
    ckpt.load_state_dict(tgt, str(root / src))
    np.testing.assert_array_equal(tgt["w"].numpy(), w)
    np.testing.assert_array_equal(tgt["b"].view(torch.int16).numpy(),
                                  _bits(b))
    assert tgt["nested"]["step"] == 7
    assert sorted(os.listdir(root / src)) == ["metadata.json",
                                              "shard_0.npz", "shard_1.npz"]
    meta = json.loads((root / src / "metadata.json").read_text())
    assert [s["file"] for s in meta["w"]["shards"]] == ["shard_0.npz",
                                                        "shard_1.npz"]
    assert [s["index"] for s in meta["w"]["shards"]] == [
        [[0, 64], [0, 64]], [[0, 64], [64, 128]]]
    assert len(meta["r"]["shards"]) == 1      # replicated: written once


@pytest.mark.parametrize("src", ["port2", "port2a"])
def test_port_two_ranks_load_in_jax(dirs, data, src):
    root = dirs[0]
    w, b, r = data
    tgt = {"w": paddle.to_tensor(np.zeros((64, 128), np.float32)),
           "b": paddle.to_tensor(jnp.zeros((8, 8), jnp.bfloat16)),
           "r": paddle.to_tensor(np.zeros((3, 5), np.float32))}
    jckpt.load_state_dict(tgt, str(root / src))
    np.testing.assert_array_equal(np.asarray(tgt["w"]._value), w)
    np.testing.assert_array_equal(np.asarray(tgt["r"]._value), r)
    assert tgt["b"]._value.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(tgt["b"]._value).view(np.uint16), b.view(np.uint16))


def test_async_save_and_optimizer_state_across_ranks(dirs):
    for rec, _ in dirs[1]:
        assert rec["async_done"] and rec["opt_round_trip"]


def test_two_port_ranks_train_and_jax_loads_within_serial(dirs):
    """tests/test_process_golden.py's check with the port as the
    distributed side: JAX loads the port ranks' regions into one-device
    tensors within 1e-5 of its own serial run."""
    root, _, _, final = dirs
    tgt = {k: paddle.to_tensor(np.zeros_like(v)) for k, v in final.items()}
    jckpt.load_state_dict(tgt, str(root / "golden"))
    for k, v in final.items():
        np.testing.assert_allclose(np.asarray(tgt[k]._value), v, rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_killed_rank_leaves_previous_checkpoint_loadable(tmp_path, data):
    w, _, r = data
    np.savez(tmp_path / "data.npz", w=w, r=r,
             b_bits=np.zeros((2, 2), np.int16))
    rc = _run_job(tmp_path, 2, "kill", expect_ok=False)
    assert rc != 0
    torn = tmp_path / "torn"
    assert (torn / "shard_1.npz").exists()      # rank 1 wrote its shard
    assert not (torn / "metadata.json").exists()
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_dict({"w": torch.zeros(64, 128)}, str(torn))
    tgt = {"w": torch.zeros(64, 128), "r": torch.zeros(3, 5)}
    ckpt.load_state_dict(tgt, str(tmp_path / "ok"))
    np.testing.assert_array_equal(tgt["w"].numpy(), w)
    np.testing.assert_array_equal(tgt["r"].numpy(), r)


def test_killed_rank_over_a_checkpoint_leaves_no_metadata(tmp_path, data):
    """A save into a directory that holds a checkpoint, cut short after
    rank 1's new shard: the old metadata is gone, so the load refuses
    instead of mixing the old rank-0 region with the new rank-1 one."""
    w, _, r = data
    np.savez(tmp_path / "data.npz", w=w, r=r,
             b_bits=np.zeros((2, 2), np.int16))
    rc = _run_job(tmp_path, 2, "resave", expect_ok=False)
    assert rc != 0
    ok = tmp_path / "ok"
    assert (ok / "shard_1.npz").exists()
    with np.load(ok / "shard_1.npz") as z:      # rank 1's new region
        np.testing.assert_array_equal(z["w__1"], 2 * w[:, 64:])
    assert not (ok / "metadata.json").exists()
    with pytest.raises(FileNotFoundError):
        ckpt.load_state_dict({"w": torch.zeros(64, 128)}, str(ok))
