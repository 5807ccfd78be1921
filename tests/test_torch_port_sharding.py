"""The port's group-sharded (ZeRO) training against the JAX package, on
the CPU.

JAX side: ``tests/test_group_sharded.py``'s MLP (16 -> 32 -> 16, seed
7, AdamW lr 1e-2, 4 steps on x, y from ``RandomState(0)``/``(1)``), run
serially and under ``group_sharded_parallel`` at each level on the 8
simulated devices. Port side: one job of 2 and one of 4 gloo processes
(``launch_pod`` of the worker below), each rank on its rows of the same
batch, from the JAX model's initial weights, at each level, with the
data-parallel loop as the reference; and the port's serial run in this
process. Held:

- every level within JAX's tolerance (1e-4 relative, 1e-5 absolute) of
  JAX's group-sharded run and of serial training, step by step for the
  losses and at the end for the parameters;
- at 2 ranks every level bit-identical to data parallelism after every
  step (a sum of two fp32 terms does not depend on its order, the mean
  by 2 is exact, AdamW is elementwise and a gather copies);
- every slot held as this rank's 1/n region (JAX's ``_sharded_spec``
  rule), stage 3's parameters empty at rest;
- global-norm clipping and GradScaler's inf skip under ``os_g`` equal
  to the serial run (the squares and the found-inf reduced over the
  group);
- ``DataParallel.sync_gradients`` under a sharded optimizer a counted
  no-op (no all-reduce), ``state_dict`` round-tripping into a fresh
  sharded optimizer under JAX's keys;
- fleet's wiring over the process group (``fleet.init`` degrees and
  groups, ``distributed_optimizer``'s levels and wrappers);
- ``tools/port_zero_worker.py``, the card's phase-17 job, at the tiny
  Llama's size: its stages, checkpoint reloads and gradient merge."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import sharding as jsharding
from paddle_tpu.distributed.mesh import set_current_mesh
from paddle_tpu.distributed.sharding_utils import place_model
from paddle_tpu.jit import TrainStep
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.distributed import group_sharded_parallel
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.distributed.sharding import (ShardedTensor, region,
                                                   sharded_dim)
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, D, H, LR = 4, 16, 32, 1e-2
RTOL, ATOL = 1e-4, 1e-5          # tests/test_group_sharded.py's
LEVELS = ("os", "os_g", "p_g_os")
CLIP = 0.05
INF_STEP = 2                     # the scaler run's step with an inf input

WORKER = r'''
import json, os, sys
import numpy as np
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import (DataParallel, fleet,
                                          group_sharded_parallel)
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

out = sys.argv[1]
STEPS, CLIP, INF_STEP = int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4])
env = dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
z = np.load(os.path.join(out, "init.npz"))
rows = z["x"].shape[0] // world
X = torch.from_numpy(z["x"][rank * rows:(rank + 1) * rows])
Y = torch.from_numpy(z["y"][rank * rows:(rank + 1) * rows])


class MLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(16, 32)
        self.fc2 = torch.nn.Linear(32, 16)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def build(**kw):
    m = MLP()
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(torch.from_numpy(z[n]))
    return m, AdamW(learning_rate=1e-2, parameters=m.parameters(), **kw)


def global_loss(loss):
    t = loss.detach().clone().reshape(1)
    C.all_reduce(t)
    return float(t[0]) / world


def full_params(m, opt):
    plan = opt._shard_plan
    ps = list(m.parameters())
    if plan is not None and plan.rest:
        plan.gather(ps)
    got = {n: p.detach().clone().numpy() for n, p in m.named_parameters()}
    if plan is not None and plan.rest:
        plan.release(ps)
    return got


arrays, rec = {}, {"rank": rank, "world": world}
for run in ("dp", "os", "os_g", "p_g_os", "clip", "scaler"):
    m, opt = build(grad_clip=ClipGradByGlobalNorm(CLIP)
                   if run == "clip" else None)
    dp = DataParallel(m)
    level = {"clip": "os_g", "scaler": "os_g"}.get(run, run)
    if run != "dp":
        group_sharded_parallel(m, opt, level)
    scaler = GradScaler(init_loss_scaling=2.0 ** 10,
                        incr_every_n_steps=2) if run == "scaler" else None
    C.reset_counters()
    r = rec[run] = {"losses": [], "rest_numel": [], "scales": []}
    for step in range(1, STEPS + 1):
        x = X.clone()
        if run == "scaler" and step == INF_STEP and rank == world - 1:
            x[0, 0] = float("inf")
        loss = ((m(x) - Y) ** 2).mean()
        if scaler is not None:
            scaler.scale(loss).backward()
            dp.sync_gradients()
            scaler.step(opt)
            scaler.update()
            r["scales"].append(scaler.get_loss_scaling())
        else:
            loss.backward()
            dp.sync_gradients()
            opt.step()
        opt.clear_grad()
        r["losses"].append(global_loss(loss))
        r["rest_numel"].append([p.numel() for p in m.parameters()])
        for n, v in full_params(m, opt).items():
            arrays[f"{run}/{step}/{n}"] = v
    r["routes"] = C.route_counts()
    plan = opt._shard_plan
    if plan is not None:
        r["slot_shapes"] = {n: {k: list(v.shape) for k, v in
                                opt._slots[id(p)].items()}
                            for n, p in m.named_parameters()}
        r["dims"] = {n: plan.dim(p) for n, p in m.named_parameters()}
        r["regions"] = {n: plan.region(p) for n, p in m.named_parameters()}
    if run == "p_g_os":
        from paddle_tpu_torch.distributed import save_group_sharded_model
        save_group_sharded_model(m, os.path.join(out, "gsm"), opt)
        r["rest_after_save"] = [p.numel() for p in m.parameters()]
        rec["gsm_dir"] = os.path.join(out, "gsm")
    if run == "os_g":
        sd = opt.state_dict()
        r["sd_keys"] = sorted(sd)
        r["sd_region_types"] = sorted({type(v).__name__ for k, v in
                                       sd.items() if k != "@step"})
        m2, opt2 = build()
        group_sharded_parallel(m2, opt2, "os_g")
        opt2.set_state_dict(sd)
        r["sd_round_trip"] = opt2._step_count == opt._step_count and all(
            torch.equal(opt2._slots[id(p2)][k], v)
            for p, p2 in zip(m.parameters(), m2.parameters())
            for k, v in opt._slots[id(p)].items())

# fleet over the process group
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": -1}
st.sharding = True
st.sharding_configs = {"stage": 2}
st.gradient_merge = True
st.gradient_merge_configs = {"k_steps": 2}
fleet.init(is_collective=True, strategy=st)
hcg = fleet.get_hybrid_communicate_group()
m, opt = build()
model = fleet.distributed_model(m)
wrapped = fleet.distributed_optimizer(opt)
rec["fleet"] = {
    "dp": hcg.axis_size("dp"), "sharding": hcg.axis_size("sharding"),
    "dp_group": hcg.get_data_parallel_group().ranks,
    "model": type(model).__name__, "optimizer": type(wrapped).__name__,
    "k_steps": wrapped.k_steps, "level": wrapped.inner_opt._shard_plan.level,
    "worker_num": fleet.worker_num(), "worker_index": fleet.worker_index()}
if world == 4:
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    st.sharding = True
    st.sharding_configs = {"stage": 3}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    m, opt = build()
    fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(opt)
    plan = opt._shard_plan
    rec["fleet_hybrid"] = {
        "sharding_group": hcg.get_sharding_parallel_group().ranks,
        "dp_group": hcg.get_data_parallel_group().ranks,
        "plan_group": plan.group.ranks, "level": plan.level,
        "at_rest": [p.numel() for p in m.parameters()]}
np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
C.barrier()
C.destroy_process_group()
'''


@pytest.fixture(autouse=True)
def _clear_jax_mesh():
    yield
    set_current_mesh(None)
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed import mesh as mesh_mod
    mesh_mod._HCG = None
    jfleet._FLEET.update(initialized=False, strategy=None, hcg=None)


def _jax_mlp():
    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(D, H)
            self.fc2 = jnn.Linear(H, D)

        def forward(self, x):
            return self.fc2(jnn.functional.relu(self.fc1(x)))
    return MLP()


def _data():
    x = np.random.RandomState(0).randn(8, D).astype(np.float32)
    y = np.random.RandomState(1).randn(8, D).astype(np.float32)
    return x, y


def _jax_run(level):
    """``tests/test_group_sharded.py``'s ``_run``: (initial params,
    losses, final params), the params in JAX's layout."""
    paddle.seed(7)
    model = _jax_mlp()
    init = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    opt = joptimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    if level is not None:
        mesh = Mesh(np.array(jax.devices()[:8]), ("sharding",))
        set_current_mesh(mesh)
        model, opt, _ = jsharding.group_sharded_parallel(model, opt, level)
        place_model(model, mesh)
    step = TrainStep(model, lambda m, b: ((m(b[0]) - b[1]) ** 2).mean(),
                     opt)
    x, y = _data()
    losses = [float(step((Tensor(jnp.asarray(x)),
                          Tensor(jnp.asarray(y))))._value)
              for _ in range(STEPS)]
    final = {k: np.asarray(v._value) for k, v in model.state_dict().items()}
    set_current_mesh(None)
    return init, losses, final


def _to_port(params: dict) -> dict:
    """JAX's (in, out) Linear weights as torch's (out, in)."""
    return {k: (v.T.copy() if k.endswith("weight") else v.copy())
            for k, v in params.items()}


class _MLP(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        self.fc1 = torch.nn.Linear(D, H)
        self.fc2 = torch.nn.Linear(H, D)
        with torch.no_grad():
            for n, p in self.named_parameters():
                p.copy_(torch.from_numpy(init[n]))

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


def _port_serial(init, clip=None, scaler=False):
    """The port on one process, the whole batch: (losses, per-step
    params, scales)."""
    from paddle_tpu_torch.amp import GradScaler
    m = _MLP(init)
    opt = AdamW(learning_rate=LR, parameters=m.parameters(),
                grad_clip=ClipGradByGlobalNorm(clip) if clip else None)
    sc = GradScaler(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2) \
        if scaler else None
    x, y = (torch.from_numpy(a) for a in _data())
    losses, params, scales = [], [], []
    for step in range(1, STEPS + 1):
        xs = x.clone()
        if scaler and step == INF_STEP:
            xs[-1, 0] = float("inf")       # a row of the last rank
        loss = ((m(xs) - y) ** 2).mean()
        if sc is not None:
            sc.scale(loss).backward()
            sc.step(opt)
            sc.update()
            scales.append(sc.get_loss_scaling())
        else:
            loss.backward()
            opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        params.append({n: p.detach().numpy().copy()
                       for n, p in m.named_parameters()})
    return losses, params, scales


@pytest.fixture(scope="module")
def jax_runs():
    return {lvl: _jax_run(lvl) for lvl in (None,) + LEVELS}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def job(request, tmp_path_factory, jax_runs):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"zero{world}")
    init = _to_port(jax_runs[None][0])
    x, y = _data()
    np.savez(tmp / "init.npz", x=x, y=y, **init)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    cfg = LaunchConfig(
        str(script), [str(tmp), str(STEPS), str(CLIP), str(INF_STEP)],
        nproc_per_node=world, log_dir=str(tmp / "log"),
        envs={"OMP_NUM_THREADS": "1",
              "PYTHONPATH": REPO + os.pathsep
              + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs
    recs = [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(world)]
    arrays = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]
    return world, recs, arrays, init


def _final(arrays, run, step=STEPS):
    return {k.split("/", 2)[2]: v for k, v in arrays.items()
            if k.startswith(f"{run}/{step}/")}


@pytest.mark.parametrize("level", LEVELS)
def test_level_matches_jax_and_serial(job, jax_runs, level):
    world, recs, arrays, init = job
    _, jax_losses, jax_final = jax_runs[level]
    _, serial_losses, serial_final = jax_runs[None]
    port_losses, port_params, _ = _port_serial(init)
    got = _final(arrays[0], level)
    for want in (_to_port(jax_final), _to_port(serial_final),
                 port_params[-1]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{level} {k}")
    for want in (jax_losses, serial_losses, port_losses):
        np.testing.assert_allclose(recs[0][level]["losses"], want,
                                   rtol=RTOL, atol=ATOL)
    for a in arrays[1:]:                 # every rank holds the same params
        for k, v in _final(a, level).items():
            np.testing.assert_array_equal(v, got[k])


@pytest.mark.parametrize("level", LEVELS)
def test_levels_against_data_parallel(job, level):
    """At 2 ranks bit for bit after every step; at 4 the reduce-scatter
    and gloo's all-reduce may sum in other orders: JAX's tolerance."""
    world, _, arrays, _ = job
    for step in range(1, STEPS + 1):
        for k, v in _final(arrays[0], "dp", step).items():
            got = _final(arrays[0], level, step)[k]
            if world == 2:
                np.testing.assert_array_equal(
                    got, v, err_msg=f"{level} step {step} {k}")
            else:
                np.testing.assert_allclose(
                    got, v, rtol=RTOL, atol=ATOL,
                    err_msg=f"{level} step {step} {k}")


def test_slots_are_regions_and_stage3_rests(job):
    world, recs, _, init = job
    for r, rec in enumerate(recs):
        for level in LEVELS:
            run = rec[level]
            for n, shapes in run["slot_shapes"].items():
                shape = init[n].shape
                d = sharded_dim(shape, world)
                assert d is not None and run["dims"][n] == d
                reg = region(shape, d, world, r)
                assert run["regions"][n] == reg
                want = [b - a for a, b in reg]
                assert shapes == {"moment1": want, "moment2": want}
                assert np.prod(want) * world == np.prod(shape)
            rest = run["rest_numel"][-1]
            if level == "p_g_os":
                assert rest == [0] * len(rest)
            else:
                assert rest == [int(np.prod(v.shape))
                                for v in init.values()]


@pytest.mark.parametrize("run", ["clip", "scaler"])
def test_clip_and_inf_skip_under_os_g_equal_serial(job, run):
    world, recs, arrays, init = job
    if run == "clip":
        losses, params, _ = _port_serial(init, clip=CLIP)
    else:
        losses, params, scales = _port_serial(init, scaler=True)
        for rec in recs:                 # every rank skipped the same step
            assert rec["scaler"]["scales"] == scales
        assert scales[INF_STEP - 1] == 2.0 ** 9     # halved at the skip
    np.testing.assert_allclose(
        [x for x in recs[0][run]["losses"] if np.isfinite(x)],
        [x for x in losses if np.isfinite(x)], rtol=RTOL, atol=ATOL)
    for step in range(1, STEPS + 1):
        for k, v in params[step - 1].items():
            np.testing.assert_allclose(_final(arrays[0], run, step)[k], v,
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{run} step {step} {k}")
    if run == "scaler":    # the skipped step left the params as they were
        for k, v in _final(arrays[0], run, INF_STEP - 1).items():
            np.testing.assert_array_equal(
                _final(arrays[0], run, INF_STEP)[k], v)


def test_sync_gradients_is_a_counted_noop_and_state_dict_round_trips(job):
    world, recs, _, _ = job
    for rec in recs:
        routes = rec["os_g"]["routes"]
        assert routes["sync_gradients"] == {"sharded_step": STEPS}
        # the loss's own all-reduce is the only one (the print of it)
        assert routes["all_reduce"] == {"gloo": STEPS}
        assert routes["reduce_scatter_tensor"] == {"gloo": STEPS}
        assert rec["dp"]["routes"]["all_reduce"]["gloo"] == 2 * STEPS
        assert rec["os_g"]["sd_round_trip"]
        assert rec["os_g"]["sd_region_types"] == ["ShardedTensor"]
        assert rec["os_g"]["sd_keys"] == ["@step"] + sorted(
            f"param_{i}.moment{j}" for i in range(4) for j in (1, 2))


def test_save_group_sharded_model_writes_whole_tensors(job):
    """Stage 3's parameters at rest and their slot regions, gathered and
    written whole by rank 0 (``torch.save`` files); the parameters stay
    at rest."""
    world, recs, arrays, init = job
    for rec in recs:
        assert rec["p_g_os"]["rest_after_save"] == [0] * 4
    gsm = recs[0]["gsm_dir"]
    params = torch.load(os.path.join(gsm, "model.pdparams"))
    for k, v in _final(arrays[0], "p_g_os").items():
        np.testing.assert_array_equal(params[k].numpy(), v)
    opt = torch.load(os.path.join(gsm, "model.pdopt"))
    assert opt["@step"] == STEPS
    for i, (k, v) in enumerate(init.items()):
        assert tuple(opt[f"param_{i}.moment1"].shape) == v.shape


def test_fleet_wires_the_process_group(job):
    world, recs, _, _ = job
    for r, rec in enumerate(recs):
        f = rec["fleet"]
        assert (f["dp"], f["sharding"]) == (world, 1)
        assert f["dp_group"] == list(range(world))
        assert f["model"] == "DataParallel"
        assert f["optimizer"] == "GradientMergeOptimizer"
        assert (f["k_steps"], f["level"]) == (2, "os_g")
        assert (f["worker_num"], f["worker_index"]) == (world, r)
        if world == 4:
            h = rec["fleet_hybrid"]
            # ranks laid out (dp, sharding) row-major, as AXIS_ORDER
            assert h["sharding_group"] == [r // 2 * 2, r // 2 * 2 + 1]
            assert h["dp_group"] == [r % 2, r % 2 + 2]
            assert h["plan_group"] == h["sharding_group"]
            assert h["level"] == "p_g_os"
            assert h["at_rest"] == [0, 0, 0, 0]


@pytest.mark.parametrize("shape", [(16, 32), (32, 16), (32,), (6, 6),
                                   (3, 5), (7, 8, 8), (2, 5632, 2048), ()])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_dim_is_jax_rule(shape, n):
    mesh = Mesh(np.array(jax.devices()[:n]), ("sharding",))
    spec = jsharding._sharded_spec(shape, "sharding", mesh)
    want = None if spec is None else list(spec).index("sharding")
    assert sharded_dim(shape, n) == want


def test_one_process_shards_nothing():
    """At world size 1 nothing is sharded (JAX without a mesh): no plan,
    the step is the plain one; ``ShardedTensor.shard`` holds the whole
    tensor and ``full`` returns it."""
    m = torch.nn.Linear(4, 6)
    opt = AdamW(parameters=m.parameters())
    assert group_sharded_parallel(m, opt, "p_g_os") == (m, opt, None)
    assert opt._shard_plan is None
    t = torch.arange(12.0).reshape(3, 4)
    s = ShardedTensor.shard(t)
    assert s.region == [[0, 3], [0, 4]] and s.dim is None
    assert torch.equal(s.full(), t)
    with pytest.raises(ValueError, match="os / os_g / p_g_os"):
        group_sharded_parallel(m, opt, "zero3")


def test_zero_worker_job_on_the_cpu(tmp_path):
    """``tools/port_zero_worker.py`` (``chip_smoke.py`` phase 17's job)
    at the tiny Llama's size on 2 gloo ranks: every stage bit-identical
    to its DP run after every step, the ``os`` state reloaded into
    ``p_g_os`` at 2 ranks and on one rank (``--load1``) with the regions
    and the next step bit for bit, the merged gradient within its
    tolerance."""
    args = ["--out", str(tmp_path), "--config", "tiny", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--steps", "2"]
    envs = {"OMP_NUM_THREADS": "1",
            "PYTHONPATH": REPO + os.pathsep
            + os.environ.get("PYTHONPATH", "")}
    worker = os.path.join(REPO, "tools", "port_zero_worker.py")
    for n, extra in ((2, ["--gm-layers", "1"]), (1, ["--load1"])):
        rc = launch_pod(LaunchConfig(worker, args + extra,
                                     nproc_per_node=n,
                                     log_dir=str(tmp_path / f"log{n}"),
                                     envs=envs))
        logs = {p.name: p.read_text()[-3000:]
                for p in (tmp_path / f"log{n}").iterdir()}
        assert rc == 0, logs
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    one = json.loads((tmp_path / "load1.json").read_text())
    for rec in recs:
        runs = rec["runs"]
        dp = runs["dp"]["digests"]
        assert len(dp) == 2
        for level in LEVELS:
            assert runs[level]["digests"] == dp, level
        assert runs["load"]["regions_equal"]
        assert runs["load"]["next_step_equal"]
        assert runs["load"]["digests"] == dp[1:]
        assert runs["gm"]["grad_rel_max"] <= runs["gm"]["grad_tol"]
        assert runs["os_g"]["routes"]["sync_gradients"] == {
            "sharded_step": 2}
    assert one["loaded_params"] == recs[0]["runs"]["os"]["saved_params"]
    assert one["loaded_slots"] == [r["runs"]["os"]["saved_slots"]
                                   for r in recs]
    assert one["digest"] == recs[0]["runs"]["dp"]["digests"][-1]
