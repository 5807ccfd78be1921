"""The port's eager data parallelism against the JAX package, on the CPU.

One job of two processes (``python -m``-equivalent ``launch_pod`` of
``tools/port_dp_worker.py``, gloo on the host) trains the tiny Llama
for 3 AdamW steps from the JAX model's weights (carried by
``convert.params_from_jax``), each rank on its shard of the data through
``DistributedBatchSampler``, ``DataLoader`` and ``device_prefetch``,
once with the bucketed gradient sync and once with one all-reduce a
gradient. The ranks' parameters are bit-identical after every step (the
worker compares digests over the store and stops otherwise) and at the
end; the two syncs are bit-equal (fp32: a bucket sums each element as
the per-tensor path does); step 1's synced gradient is the mean of the
two halves' gradients bit for bit; and the final parameters agree with
one JAX process trained on the global batch (the two frameworks'
products and the mean of two half-batch means sum in other orders):
every element within ``2 * lr * steps`` (AdamW moves an element by at
most lr a step, so a gradient entry near zero whose sign differs can
part the runs by that much; the port's training test explains it), and
all but ``BULK_SHARE`` of them within ``BULK_TOL`` (the 1e-6 of one step
in that test, a step). The losses agree within 1e-5 relative. The same
job runs the worker's store checks (a 64 MiB p2p round trip, a subset
group, ``ElasticManager``).

Beside it: ``build_buckets`` equal to JAX's, the one-process syncs,
``DataParallel``'s API, and ``device_prefetch(sharding=)``'s pieces
equal to JAX's addressable shards on 8 CPU devices."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed.collectives import bucketing as jbucketing
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.distributed import DataParallel
from paddle_tpu_torch.distributed.collectives import (
    bucketed_allreduce_gradients, build_buckets)
from paddle_tpu_torch.distributed.fleet.utils import \
    fused_allreduce_gradients
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.distributed.mesh import (NamedSharding,
                                               build_device_mesh)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "port_dp_worker.py")
RANKS, BATCH, SEQ, STEPS = 2, 2, 16, 3
LR = 1e-4                 # the worker's AdamW
PARAM_TOL = 2 * LR * STEPS
BULK_TOL, BULK_SHARE = 1e-6 * STEPS, 1e-3


def _global_batches():
    """The worker's data (``dataset``): each step's global batch, the
    ranks' batches in rank order."""
    ids = np.random.RandomState(0).randint(
        0, 512, (RANKS * BATCH * STEPS, SEQ)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    per = BATCH * STEPS
    return [(np.concatenate([ids[r * per + s * BATCH:
                                 r * per + (s + 1) * BATCH]
                             for r in range(RANKS)]),
             np.concatenate([labels[r * per + s * BATCH:
                                    r * per + (s + 1) * BATCH]
                             for r in range(RANKS)]))
            for s in range(STEPS)]


@pytest.fixture(scope="module")
def dp_job(tmp_path_factory):
    """The two-process job (both syncs) and one JAX process on the
    global batch, from the same weights."""
    tmp = tmp_path_factory.mktemp("dp")
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    init = params_from_jax({n: np.asarray(p._value)
                            for n, p in jm.named_parameters()})
    np.savez(tmp / "init.npz", **{k: v.numpy() for k, v in init.items()})
    cfg = LaunchConfig(
        WORKER, ["--out", str(tmp), "--config", "tiny", "--device", "cpu",
                 "--init", str(tmp / "init.npz"), "--batch", str(BATCH),
                 "--seq", str(SEQ), "--steps", str(STEPS), "--sync",
                 "bucketed,tensor", "--reference", "--store-checks",
                 "--save-params"],
        nproc_per_node=RANKS, log_dir=str(tmp / "log"),
        envs={"OMP_NUM_THREADS": "1",
              "PYTHONPATH": REPO + os.pathsep
              + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs
    opt = joptimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                           parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda m, b: m(*b)[0], opt)
    jax_losses = [float(step(tuple(paddle.to_tensor(a) for a in b)))
                  for b in _global_batches()]
    jax_params = {k: v.numpy() for k, v in params_from_jax(
        {n: np.asarray(p._value) for n, p in jm.named_parameters()}).items()}
    recs = [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(RANKS)]
    params = {(r, s): dict(np.load(tmp / f"rank{r}-{s}.npz"))
              for r in range(RANKS) for s in ("bucketed", "tensor")}
    return recs, params, jax_params, jax_losses


def test_ranks_bit_identical_and_syncs_bit_equal(dp_job):
    recs, params, _, _ = dp_job
    for s in ("bucketed", "tensor"):
        assert recs[0]["runs"][s]["digests"] == recs[1]["runs"][s]["digests"]
        assert len(recs[0]["runs"][s]["digests"]) == STEPS
        for k, v in params[(0, s)].items():
            np.testing.assert_array_equal(v, params[(1, s)][k], err_msg=k)
    assert recs[0]["runs"]["bucketed"]["digests"] == \
        recs[0]["runs"]["tensor"]["digests"]
    for k, v in params[(0, "bucketed")].items():
        np.testing.assert_array_equal(v, params[(0, "tensor")][k])
    for r in recs:
        assert r["backend"] == "gloo" and r["world"] == RANKS
        routes = [r["runs"][s]["routes"]["all_reduce"]
                  for s in ("bucketed", "tensor")]
        n_tensors = r["runs"]["tensor"]["param_tensors"]
        assert routes == [{"gloo": STEPS}, {"gloo": STEPS * n_tensors}]


def test_step_one_gradient_is_the_halves_mean(dp_job):
    recs, _, _, _ = dp_job
    for s in ("bucketed", "tensor"):
        ref = recs[0]["runs"][s]["reference"]
        assert ref["halves_mean_unequal"] == []
        assert ref["grad_rel_max"] < 1e-5     # fp32: summation order only


def test_matches_one_jax_process_on_the_global_batch(dp_job):
    recs, params, jax_params, jax_losses = dp_job
    got = params[(0, "bucketed")]
    assert set(got) == set(jax_params)
    far, total = 0, 0
    for k, v in jax_params.items():
        np.testing.assert_allclose(got[k], v, atol=PARAM_TOL, rtol=0,
                                   err_msg=k)
        far += int((np.abs(got[k] - v) > BULK_TOL).sum())
        total += v.size
    assert far <= BULK_SHARE * total, (far, total)
    # each rank's loss is its half's; their mean is the global batch's
    mean = np.mean([r["runs"]["bucketed"]["losses"] for r in recs], axis=0)
    np.testing.assert_allclose(mean, jax_losses, rtol=1e-5)


def test_store_checks_in_the_job(dp_job):
    recs, _, _, _ = dp_job
    for r in recs:
        st = r["store"]
        assert st["p2p_equal"] and st["bulk_warnings"] == 1
        assert st["elastic_alive"] == ["rank0", "rank1"]
        assert r["routes"]["send"] == {"store": 1}
    assert recs[1]["store"]["subset_ok"]
    assert recs[1]["routes"]["all_reduce"]["store"] == 1


@pytest.mark.parametrize("target", [1, 100, 1 << 20])
def test_build_buckets_equals_jax(target):
    sizes = [(f"p{i}", n) for i, n in enumerate([3, 50, 7, 1000, 1, 1, 64])]
    assert build_buckets(sizes, target) == \
        jbucketing.build_buckets(sizes, target)


def _linear_with_grads():
    torch.manual_seed(0)
    net = tnn.Linear(4, 2)
    (net(torch.ones(3, 4)) ** 2).mean().backward()
    return net


@pytest.mark.parametrize("route", ["tensor", "bucket_bytes", "config"])
def test_one_process_sync_is_the_identity(route):
    """One rank: the mean over the world is the gradient itself, per
    tensor, with ``bucket_bytes`` and with the config's
    ``bucketed_grad_sync`` (``PT_COLLECTIVES_BUCKETED_SYNC``)."""
    from paddle_tpu_torch.distributed import collectives
    from paddle_tpu_torch.distributed import communication as C
    net = _linear_with_grads()
    before = [p.grad.clone() for p in net.parameters()]
    C.reset_counters()
    with collectives.configure(bucketed_grad_sync=route == "config"):
        fused_allreduce_gradients(
            list(net.parameters()),
            bucket_bytes=16 if route == "bucket_bytes" else None)
    n = 1 if route == "config" else 2      # one bucket; two tensors
    assert C.route_counts()["all_reduce"] == {"local": n}
    for p, b in zip(net.parameters(), before):
        assert torch.equal(p.grad, b)
    fresh = tnn.Linear(4, 2)
    fused_allreduce_gradients(list(fresh.parameters()))   # no grads: ok
    assert fresh.weight.grad is None


def test_data_parallel_api():
    net = _linear_with_grads()
    dp = DataParallel(net, comm_buffer_size=1)
    assert torch.equal(dp(torch.ones(1, 4)), net(torch.ones(1, 4)))
    assert dp.state_dict().keys() == net.state_dict().keys()
    before = [p.grad.clone() for p in net.parameters()]
    with dp.no_sync():
        dp.sync_gradients()
    dp.sync_gradients()                      # world of one: the mean is 1x
    bucketed_allreduce_gradients(list(net.parameters()))
    for p, b in zip(net.parameters(), before):
        assert torch.equal(p.grad, b)
    assert dp.scale_loss(3.0) == 3.0


def test_prefetch_sharding_equals_jax_addressable_shards():
    from jax.sharding import Mesh, NamedSharding as JaxSharding
    from jax.sharding import PartitionSpec as P
    devs = np.array(jax.devices()[:8]).reshape(4, 2)
    jmesh = Mesh(devs, ("dp", "mp"))
    tmesh = build_device_mesh({"dp": 4, "mp": 2}, devices=["cpu"] * 8)
    rs = np.random.RandomState(0)
    batches = [(rs.randn(8, 3).astype(np.float32),
                {"ids": rs.randint(0, 9, (8, 5)).astype(np.int32)})
               for _ in range(2)]
    for spec in ("dp", ("dp", "mp")):
        jout = list(jio.device_prefetch(iter(batches),
                                        sharding=JaxSharding(jmesh,
                                                             P(spec))))
        tout = list(tio.device_prefetch(iter(batches),
                                        sharding=NamedSharding(tmesh, spec)))
        for jb, tb in zip(jout, tout):
            for jleaf, tleaf in ((jb[0], tb[0]),
                                 (jb[1]["ids"], tb[1]["ids"])):
                shards = {s.device: np.asarray(s.data)
                          for s in jleaf.addressable_shards}
                assert len(tleaf) == 8
                for d, piece in zip(devs.reshape(-1), tleaf):
                    np.testing.assert_array_equal(piece.numpy(), shards[d])
    with pytest.raises(ValueError, match="split"):
        list(tio.device_prefetch(iter([np.zeros((6, 2))]),
                                 sharding=NamedSharding(tmesh, "dp")))
