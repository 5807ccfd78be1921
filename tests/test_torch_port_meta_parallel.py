"""The port's meta-parallel layers, mp communication, RNG tracker and
recompute against the JAX package, on the CPU.

Port side: one gloo job of 2 and one of 4 ranks (``launch_pod`` of the
worker below, ``fleet.init(mp_degree=world)``), each rank building every
layer of ``distributed/fleet/meta_parallel.py`` with its slice of the
JAX layer's full weight (``convert.params_from_jax_mp``) and running a
forward and a backward on the same inputs. JAX side: the same layers
on a 2- or 4-device ``mp`` mesh (``HybridCommunicateGroup``,
``place_model``), their forward and ``backward()``. Held within 1e-5
relative (fp32):

- ``ColumnParallelLinear`` with ``gather_output`` True and False,
  ``RowParallelLinear`` with ``input_is_parallel`` False and True
  (outputs, input and parameter gradients: a split one as this rank's
  slice of JAX's);
- ``VocabParallelEmbedding`` on ids in every rank's slice;
- ``ParallelCrossEntropy`` on class-split logits with ``ignore_index``;
- ``ScatterOp``/``GatherOp`` along an axis (JAX's leave the value as it
  is: the port's scatter gives this rank's slice of it);
- an fp32 all-reduce of the group within 1e-6 relative of the rank-order
  sum (JAX's ``_reduce_terms``).

In this process: the RNG tracker's named streams draw JAX's bits and
restore the stream in use on exit; ``recompute`` and
``recompute_sequential`` give JAX's values and gradients on the same
function and equal the port without recompute (the selective policy
too)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import framework as jframework
from paddle_tpu.distributed.fleet import meta_parallel as jmp
from paddle_tpu.distributed.fleet import utils_recompute as jrc
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_current_mesh)
from paddle_tpu.distributed.sharding_utils import place_model

from paddle_tpu_torch import random as prandom
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp
from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                      recompute_sequential)
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
B, S, IN, OUT, VOCAB, D = 3, 4, 16, 16, 32, 8

WORKER = r'''
import json, os, sys
import numpy as np
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.convert import params_from_jax_mp
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed.fleet import meta_parallel as mpl

out = sys.argv[1]
dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": 1, "mp_degree": world}
fleet.init(is_collective=True, strategy=st)
hcg = fleet.get_hybrid_communicate_group()
z = dict(np.load(os.path.join(out, "case.npz")))
res = {}


def load(layer, prefix):
    named = {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}
    sd = params_from_jax_mp(named, mpl.mp_partition_specs(layer), rank,
                            world)
    layer.load_state_dict(sd)
    return layer


def piece(a, axis):
    k = a.shape[axis] // world
    return np.take(a, range(rank * k, (rank + 1) * k), axis=axis)


def run(tag, layer, x, cot):
    x = torch.tensor(x, requires_grad=x.dtype == np.float32)
    y = layer(x)
    (y * torch.from_numpy(cot)).sum().backward()
    res[f"{tag}/out"] = y.detach().numpy()
    if x.grad is not None:
        res[f"{tag}/dx"] = x.grad.numpy()
    for n, p in layer.named_parameters():
        res[f"{tag}/d{n}"] = p.grad.numpy()


for gather in (True, False):
    tag = f"col{int(gather)}"
    layer = load(mpl.ColumnParallelLinear(16, 16, gather_output=gather,
                                          device="cpu"), "col.")
    run(tag, layer, z["x16"], z["cot16"] if gather
        else piece(z["cot16"], -1))
for parallel in (False, True):
    tag = f"row{int(parallel)}"
    layer = load(mpl.RowParallelLinear(16, 16, input_is_parallel=parallel,
                                       device="cpu"), "row.")
    run(tag, layer, piece(z["x16"], -1) if parallel else z["x16"],
        z["cot16"])
layer = load(mpl.VocabParallelEmbedding(32, 8, device="cpu"), "emb.")
run("emb", layer, z["ids"], z["cot_emb"])
logits = torch.tensor(piece(z["logits"], -1), requires_grad=True)
loss = mpl.ParallelCrossEntropy(ignore_index=-100)(
    logits, torch.from_numpy(z["labels"]))
(loss * torch.from_numpy(z["cot_ce"])).sum().backward()
res["ce/out"], res["ce/dx"] = loss.detach().numpy(), logits.grad.numpy()
x = torch.tensor(z["seq"], requires_grad=True)
sc = mpl.ScatterOp.apply(x, axis=1)
ga = mpl.GatherOp.apply(sc * 2.0, axis=1)
(ga * torch.from_numpy(z["cot_seq"])).sum().backward()
res["scatter"], res["gather"] = sc.detach().numpy(), ga.detach().numpy()
res["seq/dx"] = x.grad.numpy()
v = torch.from_numpy(z["terms"][rank].copy())
C.all_reduce(v, group=hcg.get_model_parallel_group())
res["allreduce"] = v.numpy()
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump({"mp_rank": hcg.get_model_parallel_rank(),
               "mp_world": hcg.get_model_parallel_world_size()}, f)
C.barrier()
C.destroy_process_group()
'''


def _inputs():
    rs = np.random.RandomState(3)
    ids = rs.randint(0, VOCAB, (B, S)).astype(np.int64)
    ids[0, :4] = [0, 9, 17, 31]              # every rank's slice, at 4 ranks
    labels = rs.randint(0, VOCAB, (6,)).astype(np.int64)
    labels[:4] = [1, 10, 20, 30]
    labels[4] = -100
    return {
        "x16": rs.randn(B, S, IN).astype(np.float32),
        "cot16": rs.randn(B, S, OUT).astype(np.float32),
        "ids": ids, "cot_emb": rs.randn(B, S, D).astype(np.float32),
        "logits": rs.randn(6, VOCAB).astype(np.float32),
        "labels": labels, "cot_ce": rs.randn(6).astype(np.float32),
        "seq": rs.randn(2, 8, 4).astype(np.float32),
        "cot_seq": rs.randn(2, 8, 4).astype(np.float32),
        "terms": rs.randn(4, 1000).astype(np.float32)}


def _jax_layers(n):
    """JAX's layers on an n-device mp mesh (seeded), placed by their
    partition specs."""
    paddle.seed(11)
    hcg = HybridCommunicateGroup(dp_degree=1, mp_degree=n,
                                 devices=jax.devices()[:n])
    layers = {"col": jmp.ColumnParallelLinear(IN, OUT),
              "row": jmp.RowParallelLinear(IN, OUT),
              "emb": jmp.VocabParallelEmbedding(VOCAB, D)}
    for layer in layers.values():
        place_model(layer, hcg.jax_mesh)
    return layers


def _jax_run(layer, x, cot):
    xt = paddle.to_tensor(x, stop_gradient=not np.issubdtype(
        x.dtype, np.floating))
    y = layer(xt)
    (y * paddle.to_tensor(cot)).sum().backward()
    out = {"out": np.asarray(y._value)}
    if np.issubdtype(x.dtype, np.floating):
        out["dx"] = np.asarray(xt.grad._value)
    for name, p in layer.named_parameters():
        out[f"d{name}"] = np.asarray(p.grad._value)
    return out


def _jax_results(n, inp):
    layers = _jax_layers(n)
    weights = {f"{k}.{name}": np.asarray(p._value)
               for k, layer in layers.items()
               for name, p in layer.named_parameters()}
    res = {}
    for gather in (True, False):           # JAX's value is the same
        res[f"col{int(gather)}"] = _jax_run(layers["col"], inp["x16"],
                                            inp["cot16"])
        layers["col"].clear_gradients()
    for parallel in (False, True):
        res[f"row{int(parallel)}"] = _jax_run(layers["row"], inp["x16"],
                                              inp["cot16"])
        layers["row"].clear_gradients()
    res["emb"] = _jax_run(layers["emb"], inp["ids"], inp["cot_emb"])
    logits = paddle.to_tensor(inp["logits"], stop_gradient=False)
    loss = jmp.ParallelCrossEntropy(ignore_index=-100)(
        logits, paddle.to_tensor(inp["labels"]))
    (loss * paddle.to_tensor(inp["cot_ce"])).sum().backward()
    res["ce"] = {"out": np.asarray(loss._value),
                 "dx": np.asarray(logits.grad._value)}
    x = paddle.to_tensor(inp["seq"], stop_gradient=False)
    sc = jmp.ScatterOp.apply(x, axis=1)
    ga = jmp.GatherOp.apply(sc * 2.0, axis=1)
    (ga * paddle.to_tensor(inp["cot_seq"])).sum().backward()
    res["seq"] = {"scatter": np.asarray(sc._value),
                  "gather": np.asarray(ga._value),
                  "dx": np.asarray(x.grad._value)}
    from paddle_tpu.distributed import mesh as jmesh
    set_current_mesh(None)
    jmesh._HCG = None
    return weights, res


@pytest.fixture(scope="module", params=[2, 4], ids=["mp2", "mp4"])
def job(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"meta{n}")
    inp = _inputs()
    weights, jres = _jax_results(n, inp)
    np.savez(tmp / "case.npz", **inp, **weights)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    cfg = LaunchConfig(str(script), [str(tmp)], nproc_per_node=n,
                       log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": REPO + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(n)]
    recs = [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(n)]
    return n, inp, jres, ranks, recs


def _close(got, want, msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(
        1.0, float(np.abs(want).max())), err_msg=msg)


def _piece(a, axis, r, n):
    k = a.shape[axis] // n
    return np.take(a, range(r * k, (r + 1) * k), axis=axis)


def test_ranks_know_their_mp_coordinates(job):
    n, _, _, _, recs = job
    assert [r["mp_rank"] for r in recs] == list(range(n))
    assert all(r["mp_world"] == n for r in recs)


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(job, gather):
    n, _, jres, ranks, _ = job
    want = jres[f"col{int(gather)}"]
    for r, got in enumerate(ranks):
        tag = f"col{int(gather)}"
        _close(got[f"{tag}/out"], want["out"] if gather
               else _piece(want["out"], -1, r, n), tag)
        _close(got[f"{tag}/dx"], want["dx"])
        _close(got[f"{tag}/dweight"], _piece(want["dweight"], 1, r, n))
        _close(got[f"{tag}/dbias"], _piece(want["dbias"], 0, r, n))


@pytest.mark.parametrize("parallel", [False, True])
def test_row_parallel_linear(job, parallel):
    n, _, jres, ranks, _ = job
    want = jres[f"row{int(parallel)}"]
    for r, got in enumerate(ranks):
        tag = f"row{int(parallel)}"
        _close(got[f"{tag}/out"], want["out"], tag)
        _close(got[f"{tag}/dx"], _piece(want["dx"], -1, r, n) if parallel
               else want["dx"])
        _close(got[f"{tag}/dweight"], _piece(want["dweight"], 0, r, n))
        _close(got[f"{tag}/dbias"], want["dbias"])


def test_vocab_parallel_embedding(job):
    n, inp, jres, ranks, _ = job
    rows = VOCAB // n
    assert set(np.unique(inp["ids"] // rows)) == set(range(n))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["emb/out"], jres["emb"]["out"])
        _close(got["emb/dweight"], _piece(jres["emb"]["dweight"], 0, r, n))


def test_parallel_cross_entropy(job):
    n, inp, jres, ranks, _ = job
    assert inp["labels"][4] == -100
    for r, got in enumerate(ranks):
        _close(got["ce/out"], jres["ce"]["out"].reshape(-1))
        assert got["ce/out"][4] == 0
        _close(got["ce/dx"], _piece(jres["ce"]["dx"], -1, r, n))


def test_scatter_and_gather_ops(job):
    n, _, jres, ranks, _ = job
    want = jres["seq"]
    np.testing.assert_array_equal(want["scatter"], _inputs()["seq"])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["scatter"],
                                      _piece(want["scatter"], 1, r, n))
        _close(got["gather"], want["gather"])
        _close(got["seq/dx"], want["dx"])


def test_allreduce_within_rank_order_sum(job):
    n, inp, _, ranks, _ = job
    want = inp["terms"][0].copy()
    for t in inp["terms"][1:n]:
        want = want + t
    for got in ranks:
        np.testing.assert_allclose(got["allreduce"], want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
        np.testing.assert_array_equal(got["allreduce"],
                                      ranks[0]["allreduce"])


def test_rng_tracker_streams_match_jax():
    """Same seed, same draws: the named stream gives JAX's bits (each
    entry from the seed's key, as JAX's tracker), and the stream in use
    before resumes on exit."""
    jtr, ttr = jmp.get_rng_state_tracker(), tmp.get_rng_state_tracker()
    jtr.add("mp-rng", 77)
    ttr.add("mp-rng", 77)
    paddle.seed(5)
    prandom.seed(5)
    for _ in range(2):
        with jtr.rng_state("mp-rng"):
            jd = [np.asarray(jax.random.uniform(jframework.split_key(),
                                                (6,))) for _ in range(2)]
        with ttr.rng_state("mp-rng"):
            td = [prandom.uniform(prandom.split_key(), (6,)).numpy()
                  for _ in range(2)]
        for a, b in zip(jd, td):
            np.testing.assert_array_equal(a, b)
        assert not np.array_equal(td[0], td[1])
    # outside: the global stream, untouched by the named draws
    ja = np.asarray(jax.random.uniform(jframework.split_key(), (6,)))
    ta = prandom.uniform(prandom.split_key(), (6,)).numpy()
    np.testing.assert_array_equal(ja, ta)
    prandom.seed(5)
    np.testing.assert_array_equal(
        prandom.uniform(prandom.split_key(), (6,)).numpy(), ta)
    with ttr.rng_state("unknown"):
        prandom.split_key()


def _mlp_weights():
    rs = np.random.RandomState(9)
    return [rs.randn(8, 16).astype(np.float32) * 0.3,
            rs.randn(16, 8).astype(np.float32) * 0.3]


def _jax_fn(w1, w2):
    def f(x):
        return paddle.tanh(paddle.matmul(paddle.tanh(
            paddle.matmul(x, w1)), w2))
    return f


def _torch_fn(w1, w2):
    def f(x):
        return torch.tanh(torch.tanh(x @ w1) @ w2)
    return f


@pytest.mark.parametrize("kind", ["recompute", "sequential"])
def test_recompute_matches_jax_and_no_recompute(kind):
    w1n, w2n = _mlp_weights()
    x = np.random.RandomState(4).randn(5, 8).astype(np.float32)
    jw = [paddle.to_tensor(w, stop_gradient=False) for w in (w1n, w2n)]
    jx = paddle.to_tensor(x, stop_gradient=False)
    jf = _jax_fn(*jw)
    if kind == "recompute":
        jy = jrc.recompute(jf, jx)
    else:
        jy = jrc.recompute_sequential({"segments": 2}, [jf, jf, jf], jx)
    jy.sum().backward()
    want = [np.asarray(t._value) for t in (jy, jx.grad, *[w.grad
                                                          for w in jw])]
    runs = {}
    for mode in ("plain", "recompute", "selective"):
        tw = [torch.tensor(w, requires_grad=True) for w in (w1n, w2n)]
        tx = torch.tensor(x, requires_grad=True)
        tf = _torch_fn(*tw)
        kw = {"use_reentrant": False, "policy": "selective"} \
            if mode == "selective" else {}
        if mode == "plain":
            ty = tf(tx) if kind == "recompute" else tf(tf(tf(tx)))
        elif kind == "recompute":
            ty = recompute(tf, tx, **kw)
        else:
            ty = recompute_sequential({"segments": 2}, [tf, tf, tf], tx,
                                      **kw)
        ty.sum().backward()
        runs[mode] = [t.detach().numpy() for t in (ty, tx.grad, *[
            w.grad for w in tw])]
    for mode, got in runs.items():
        for g, w in zip(got, want):
            _close(g, w, mode)
        for g, p in zip(got, runs["plain"]):
            np.testing.assert_array_equal(g, p)


def test_recompute_policy_refusals():
    f = _torch_fn(*[torch.tensor(w) for w in _mlp_weights()])
    x = torch.ones(2, 8, requires_grad=True)
    with pytest.raises(ValueError, match="use_reentrant=False"):
        recompute(f, x, policy="selective")
    with pytest.raises(ValueError, match="policy="):
        recompute(f, x, use_reentrant=False, policy="everything")
