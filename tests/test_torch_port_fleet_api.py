"""The port's fleet strategy API, meta-optimizers and GradScaler against
the JAX package, on the CPU (one process; the multi-rank wiring of
``fleet.init``/``distributed_model``/``distributed_optimizer`` is held
in ``tests/test_torch_port_sharding.py``'s jobs).

Both sides start from the same numpy weights (a JAX ``nn.Linear``'s,
transposed into torch's layout) and see the same batches: gradient
merge at k=2, AMPOptimizer in bf16 and fp16, GradScaler's scale,
unscale, inf skip, dynamic update and ``state_dict``. Parameters are
held within 1e-6."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import meta_optimizers as jmeta

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
from paddle_tpu_torch.optimizer import AdamW

TOL = 1e-6


@pytest.fixture(autouse=True)
def _reset_fleets():
    yield
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.distributed.mesh import set_current_mesh as jset
    from paddle_tpu_torch.distributed import mesh as tmesh
    jset(None)
    jmesh._HCG = None
    jfleet._FLEET.update(initialized=False, strategy=None, hcg=None)
    tmesh.set_current_mesh(None)
    tmesh._HCG = None
    fleet._FLEET.update(initialized=False, strategy=None, hcg=None)


def _pair(seed=3, din=6, dout=4, lr=1e-2):
    """A JAX Linear and the port's copy, each with its AdamW."""
    paddle.seed(seed)
    jl = jnn.Linear(din, dout)
    tl = torch.nn.Linear(din, dout)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(np.asarray(jl.weight._value).T))
        tl.bias.copy_(torch.from_numpy(np.asarray(jl.bias._value)))
    return (jl, joptimizer.AdamW(learning_rate=lr,
                                 parameters=jl.parameters()),
            tl, AdamW(learning_rate=lr, parameters=tl.parameters()))


def _batches(n, din=6, dout=4):
    rs = np.random.RandomState(11)
    return [(rs.randn(5, din).astype(np.float32),
             rs.randn(5, dout).astype(np.float32)) for _ in range(n)]


def _jloss(m, x, y):
    return ((m(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()


def _tloss(m, x, y):
    return ((m(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()


def _same(jl, tl, tol=TOL):
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.weight._value).T, atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               np.asarray(jl.bias._value), atol=tol,
                               rtol=tol)


def test_strategy_merges_hybrid_configs():
    for mod in (jfleet, fleet):
        st = mod.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 2}
        st.hybrid_configs = {"sharding_degree": 4}
        assert st.hybrid_configs == {"dp_degree": 2, "mp_degree": 1,
                                     "pp_degree": 1, "sharding_degree": 4,
                                     "sep_degree": 1}
        st.amp = True
        assert st.amp and st.gradient_merge_configs == {}


def test_init_degrees_on_one_process():
    """dp_degree=-1 is the world over the other degrees (JAX: the
    devices; the port: the ranks): 8 devices give JAX dp 4 beside
    sharding 2, one process gives the port dp 1, and degrees that need
    more ranks than the job has are refused."""
    st = jfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": -1, "sharding_degree": 2}
    jfleet.init(is_collective=True, strategy=st)
    jh = jfleet.get_hybrid_communicate_group()
    assert (jh.axis_size("dp"), jh.axis_size("sharding")) == (4, 2)
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": -1}
    fleet.init(is_collective=True, strategy=st, device="cpu")
    h = fleet.get_hybrid_communicate_group()
    assert h.axis_size("dp") == 1 and fleet.get_strategy() is st
    assert h.get_data_parallel_group() is None
    assert (fleet.worker_num(), fleet.worker_index(),
            fleet.is_first_worker()) == (1, 0, True)
    fleet.barrier_worker()
    st.hybrid_configs = {"sharding_degree": 2}
    with pytest.raises(ValueError, match="need 2 ranks"):
        fleet.init(strategy=st, device="cpu")


def test_distributed_model_and_optimizer_wiring_on_one_process():
    with pytest.raises(RuntimeError, match="fleet.init"):
        fleet.distributed_model(torch.nn.Linear(2, 2))
    st = fleet.DistributedStrategy()
    st.sharding = True
    st.sharding_configs = {"stage": 3}
    st.gradient_merge = True
    st.gradient_merge_configs = {"k_steps": 4, "avg": False}
    st.amp = True
    st.amp_configs = {"dtype": "float16", "init_loss_scaling": 128.0}
    fleet.init(strategy=st, device="cpu")
    net = torch.nn.Linear(4, 2)
    assert fleet.distributed_model(net) is net     # dp 1: the model
    assert net._pt_stage3 and all(p._pt_stage3 for p in net.parameters())
    opt = AdamW(parameters=net.parameters())
    out = fleet.distributed_optimizer(opt)
    assert isinstance(out, meta.AMPOptimizer)
    gm = out.inner_opt
    assert isinstance(gm, meta.GradientMergeOptimizer)
    assert (gm.k_steps, gm.avg) == (4, False) and gm.inner_opt is opt
    assert out._scaler.get_loss_scaling() == 128.0
    assert opt._shard_plan is None       # one rank: nothing is sharded


def test_gradient_merge_k2_equals_jax():
    jl, jopt, tl, topt = _pair()
    jgm = jmeta.GradientMergeOptimizer(jopt, k_steps=2, avg=True)
    tgm = meta.GradientMergeOptimizer(topt, k_steps=2, avg=True)
    w0 = tl.weight.detach().clone()
    for i, (x, y) in enumerate(_batches(4), 1):
        _jloss(jl, x, y).backward()
        jgm.step()
        jgm.clear_grad()
        _tloss(tl, x, y).backward()
        tgm.step()
        tgm.clear_grad()
        if i == 1:
            assert torch.equal(tl.weight, w0)     # accumulated, no step
            jsd, tsd = jgm.state_dict(), tgm.state_dict()
            assert jsd["@gm_micro"] == tsd["@gm_micro"] == 1
            jacc = [np.asarray(v._value) for k, v in jsd.items()
                    if k.startswith("@gm_acc.")]
            tacc = [v.numpy() for k, v in tsd.items()
                    if k.startswith("@gm_acc.")]
            assert sorted(k for k in tsd if k.startswith("@gm_acc.")) == [
                "@gm_acc.param_0", "@gm_acc.param_1"]
            np.testing.assert_allclose(tacc[0], jacc[0].T, atol=TOL)
            np.testing.assert_allclose(tacc[1], jacc[1], atol=TOL)
        _same(jl, tl)
    assert topt._step_count == 2 and tgm._micro == 0


def test_gradient_merge_state_dict_keeps_the_partial_sum():
    _, _, tl, topt = _pair()
    gm = meta.GradientMergeOptimizer(topt, k_steps=2)
    (x, y), (x2, y2) = _batches(2)
    _tloss(tl, x, y).backward()
    gm.step()
    sd = gm.state_dict()
    _, _, tl2, topt2 = _pair()
    gm2 = meta.GradientMergeOptimizer(topt2, k_steps=2)
    gm2.set_state_dict(sd)
    assert gm2._micro == 1
    for m, g in ((tl, gm), (tl2, gm2)):
        _tloss(m, x2, y2).backward()
        g.step()
    assert torch.equal(tl.weight, tl2.weight)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_amp_optimizer_equals_jax(dtype):
    jl, jopt, tl, topt = _pair()
    jamp_opt = jmeta.AMPOptimizer(jopt, dtype=dtype,
                                  init_loss_scaling=2.0 ** 10)
    tamp_opt = meta.AMPOptimizer(topt, dtype=dtype,
                                 init_loss_scaling=2.0 ** 10)
    for x, y in _batches(3):
        jamp_opt.minimize(_jloss(jl, x, y))
        jamp_opt.clear_grad()
        tamp_opt.minimize(_tloss(tl, x, y))
        tamp_opt.clear_grad()
        _same(jl, tl)
    if dtype == "float16":
        assert tamp_opt._scaler.get_loss_scaling() == \
            jamp_opt._scaler.get_loss_scaling() == 2.0 ** 10
        assert tamp_opt._scaler.state_dict() == \
            jamp_opt._scaler.state_dict()
    else:
        assert tamp_opt._scaler is None and jamp_opt._scaler is None


def test_grad_scaler_equals_jax():
    """scale, unscale_, the skip of a step whose gradient is inf, and the
    dynamic update (incr every 2 good steps, decr at a bad one)."""
    jl, jopt, tl, topt = _pair()
    kw = dict(init_loss_scaling=2.0 ** 8, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), amp.GradScaler(**kw)
    scales = []
    for i, (x, y) in enumerate(_batches(5)):
        if i == 2:
            x = x.copy()
            x[0, 0] = np.inf
        jl_loss, tl_loss = _jloss(jl, x, y), _tloss(tl, x, y)
        jsc, tsc = js.scale(jl_loss), ts.scale(tl_loss)
        np.testing.assert_allclose(float(tsc.detach()),
                                   float(np.asarray(jsc._value)), rtol=1e-6)
        jsc.backward()
        tsc.backward()
        js.unscale_(jopt)
        ts.unscale_(topt)
        assert js._found_inf == ts._found_inf == (i == 2)
        if i != 2:
            np.testing.assert_allclose(
                tl.weight.grad.numpy(),
                np.asarray(jl.weight.grad._value).T, atol=TOL, rtol=1e-5)
        before = tl.weight.detach().clone()
        js.step(jopt)
        ts.step(topt)
        js.update()
        ts.update()
        jopt.clear_grad()
        topt.clear_grad()
        if i == 2:
            assert torch.equal(tl.weight, before)       # skipped
        _same(jl, tl)
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        scales.append(ts.get_loss_scaling())
    assert scales == [2.0 ** 8, 2.0 ** 9, 2.0 ** 8, 2.0 ** 8, 2.0 ** 9]
    assert ts.state_dict() == js.state_dict()
    t2 = amp.GradScaler()
    t2.load_state_dict(ts.state_dict())
    assert t2.get_loss_scaling() == 2.0 ** 9 and t2.state_dict() == \
        {**ts.state_dict(), "incr_ratio": 2.0, "decr_ratio": 0.5}


# ---------------------------------------------------------------------------
# fleet.init over a process group: the degrees it refuses, the mp group and
# the HybridCommunicateGroup's getters (gloo jobs of 2 and 4 ranks)
# ---------------------------------------------------------------------------

_FLEET_WORKER = r'''
import json, os, sys
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import communication as C

out = sys.argv[1]
dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
rec = {"refused": {}, "layouts": {}}
refusals = {"pp": {"pp_degree": 2}, "sep": {"sep_degree": 2},
            "mp_sharding": {"mp_degree": 2, "sharding_degree": 2}} \
    if world == 2 else {}
for tag, h in refusals.items():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dict({"dp_degree": 1}, **h) \
        if tag != "mp_sharding" else h
    try:
        fleet.init(is_collective=True, strategy=st)
        rec["refused"][tag] = None
    except NotImplementedError as e:
        rec["refused"][tag] = str(e)
layouts = {"dp2_mp2": {"dp_degree": 2, "mp_degree": 2},
           "mp4": {"dp_degree": 1, "mp_degree": 4},
           "sharding2_dp2": {"dp_degree": 2, "sharding_degree": 2}} \
    if world == 4 else {"mp2": {"dp_degree": 1, "mp_degree": 2}}
for tag, h in layouts.items():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = h
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    g = {k: getattr(hcg, f"get_{k}_parallel_group")()
         for k in ("data", "model", "sharding", "pipe", "sep")}
    rec["layouts"][tag] = {
        "mode": hcg.get_parallel_mode(), "global": hcg.get_global_rank(),
        "sizes": [hcg.get_data_parallel_world_size(),
                  hcg.get_model_parallel_world_size(),
                  hcg.get_pipe_parallel_world_size(),
                  hcg.get_sharding_parallel_world_size(),
                  hcg.get_sep_parallel_world_size()],
        "ranks": [hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank(), hcg.get_stage_id(),
                  hcg.get_sharding_parallel_rank(),
                  hcg.get_sep_parallel_rank()],
        "src": [hcg.get_data_parallel_group_src_rank(),
                hcg.get_model_parallel_group_src_rank()],
        "groups": {k: (v.ranks if v is not None else None)
                   for k, v in g.items()},
        "stage": [hcg.is_first_stage(), hcg.is_last_stage()]}
    from paddle_tpu_torch import io
    sampler = io.DistributedBatchSampler(list(range(8)), 2)
    rec["layouts"][tag]["sampler"] = [sampler.nranks, sampler.local_rank]
    mp = g["model"]
    if mp is not None:       # the mp group carries a collective
        import torch
        t = torch.tensor([float(rank)])
        C.all_reduce(t, group=mp)
        rec["layouts"][tag]["mp_sum"] = float(t[0])
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
C.barrier()
C.destroy_process_group()
'''


def _fleet_job(tmp, world):
    import json
    import os
    from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp / "worker.py"
    script.write_text(_FLEET_WORKER)
    cfg = LaunchConfig(str(script), [str(tmp)], nproc_per_node=world,
                       log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": repo + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def fleet_jobs(tmp_path_factory):
    return {w: _fleet_job(tmp_path_factory.mktemp(f"fleet{w}"), w)
            for w in (2, 4)}


@pytest.mark.parametrize("tag,item", [("pp", "A.6 (e2)"),
                                      ("sep", "A.6 (e3)"),
                                      ("mp_sharding", "A.6 (e5)")])
def test_init_refuses_unported_degrees_on_every_rank(fleet_jobs, tag, item):
    """Each of the two ranks raises NotImplementedError naming the item
    that ports the axis, before any group is made (the job then goes on
    to the layouts below, so nothing hung)."""
    for rec in fleet_jobs[2]:
        msg = rec["refused"][tag]
        assert msg is not None and item in msg and "ROADMAP.md" in msg


def _jax_layout(dims, rank):
    """JAX's HybridCommunicateGroup getters for the device ``rank`` of a
    mesh of 4 devices, one a process (JAX's ``_axis_rank`` reads the
    process's coordinate in the mesh)."""
    from paddle_tpu.distributed.mesh import AXIS_ORDER
    from paddle_tpu.distributed.mesh import \
        HybridCommunicateGroup as JaxHCG
    n = int(np.prod(list(dims.values())))
    import jax
    h = JaxHCG(devices=jax.devices()[:n], **{f"{k}_degree": v
                                             for k, v in dims.items()})
    ids = np.vectorize(lambda d: d.id)(h.mesh.devices)
    base = min(d.id for d in jax.devices()[:n])
    coord = [int(c[0]) for c in np.nonzero(ids - base == rank)]
    at = dict(zip(AXIS_ORDER, coord))

    def src(axis):
        c = list(coord)
        c[AXIS_ORDER.index(axis)] = 0
        return int(ids[tuple(c)] - base)

    def group(axis):
        if h.axis_size(axis) == 1:
            return None
        c = [slice(None) if a == axis else x
             for a, x in zip(AXIS_ORDER, coord)]
        return sorted(int(i - base) for i in ids[tuple(c)].reshape(-1))

    out = {"mode": h.get_parallel_mode(), "global": rank,
           "sizes": [h.get_data_parallel_world_size(),
                     h.get_model_parallel_world_size(),
                     h.get_pipe_parallel_world_size(),
                     h.get_sharding_parallel_world_size(),
                     h.get_sep_parallel_world_size()],
           "ranks": [at["dp"], at["mp"], at["pp"], at["sharding"],
                     at["sep"]],
           "src": [src("dp"), src("mp")],
           "groups": {"data": group("dp"), "model": group("mp"),
                      "sharding": group("sharding"), "pipe": group("pp"),
                      "sep": group("sep")},
           "stage": [True, True]}
    from paddle_tpu.distributed import mesh as jmesh
    from paddle_tpu.distributed.mesh import set_current_mesh as jset
    jset(None)
    jmesh._HCG = None
    return out


@pytest.mark.parametrize("world,tag,dims", [
    (2, "mp2", {"dp": 1, "mp": 2}),
    (4, "dp2_mp2", {"dp": 2, "mp": 2}),
    (4, "mp4", {"dp": 1, "mp": 4}),
    (4, "sharding2_dp2", {"dp": 2, "sharding": 2})])
def test_hcg_getters_equal_jax_for_each_layout(fleet_jobs, world, tag, dims):
    for r, rec in enumerate(fleet_jobs[world]):
        got = dict(rec["layouts"][tag])
        mp_sum = got.pop("mp_sum", None)
        sampler = got.pop("sampler")
        want = _jax_layout(dims, r)
        assert got == want
        # the ranks of an mp group take one batch: the sampler's replicas
        # are the dp ranks; without mp, every rank of the world
        assert sampler == ([want["sizes"][0], want["ranks"][0]]
                           if dims.get("mp", 1) > 1 else [world, r])
        if dims.get("mp", 1) > 1:        # a collective over the mp group
            assert mp_sum == sum(got["groups"]["model"])
