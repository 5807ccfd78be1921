"""The port's pipeline (``distributed.pipeline``, ``PipelineLayer``,
tagged p2p over the process group) against the JAX package, on the CPU.

Port side: gloo jobs through ``launch_pod`` (workers below, written to
tmp), one rank a stage. JAX side: ``pipeline_spmd``,
``pipeline_spmd_interleaved`` and ``PipelineLayer`` on its simulated
host devices, a ``"pp"`` mesh of 2 or 4. Both see the same numpy
weights and inputs; held in fp32 within 1e-5 relative (the same sums,
added in another order):

- the FThenB schedule at pp 2 and pp 4 (with and without ``remat``) and
  the interleaved one at pp 2 and pp 4 (V = 2): outputs, the stage
  parameters' gradients and the input's; ``mb_extras`` travel with
  their microbatch; the interleaved schedule's error for M not
  divisible by S;
- ``split_microbatches``/``merge_microbatches`` with the clamp;
- p2p over the process group: tagged messages received in another
  order than sent, each by its tag; the route counters;
- ``PipelineLayer`` at pp 2: the trunk found and stacked for 1- and
  2-layer units, the forward, and training through ``PipelineParallel
  .train_batch`` with ``accumulate_steps`` (AdamW) against JAX's
  ``TrainStep`` on the mesh; ``num_virtual_pipeline_stages=2``; a
  ``SharedLayerDesc`` on both stages (its gradient summed between
  them); in one process: the heterogeneous fallback's warning, a
  buffer trunk left unstacked, the degree-mismatch error,
  ``forward_func`` at every site, ``train_batch``'s ``loss_fn``
  error."""
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
from paddle_tpu.distributed import pipeline as jpl
from paddle_tpu.distributed.fleet import meta_parallel as jmeta
from paddle_tpu.distributed.mesh import set_current_mesh
from paddle_tpu.distributed.sharding_utils import place_model
from paddle_tpu.jit import TrainStep as JaxTrainStep

from paddle_tpu_torch.distributed import pipeline as pl
from paddle_tpu_torch.distributed.communication import Group
from paddle_tpu_torch.distributed.fleet import meta_parallel as meta
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.utils.enforce import InvalidArgumentError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
D, MB = 8, 2


@pytest.fixture(autouse=True)
def _clear_mesh():
    yield
    set_current_mesh(None)


def _pp_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("pp",))


def _launch(tmp, world, script, args=()):
    path = tmp / "worker.py"
    path.write_text(script)
    cfg = LaunchConfig(str(path), [str(tmp), *args], nproc_per_node=world,
                       log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": REPO + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs


# ---------------------------------------------------------------------------
# the schedules
# ---------------------------------------------------------------------------

def _inputs():
    rs = np.random.RandomState(0)
    return {"w8": (rs.randn(8, D, D) * 0.3).astype(np.float32),
            "x8": rs.randn(8, MB, D).astype(np.float32),
            "scales": np.arange(1.0, 9.0, dtype=np.float32),
            "wv": (rs.randn(4, 2, 1, D, D) * 0.3).astype(np.float32)}


# rank r of a 4-rank job: pp 4 over the world, pp 2 over {0, 1} or {2, 3}
SCHEDULE_WORKER = r'''
import faulthandler, json, os, sys
import numpy as np
import torch
faulthandler.dump_traceback_later(240, exit=True)
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import pipeline as pl

out = sys.argv[1]
dist.init_parallel_env(device="cpu")
rank = dist.get_rank()
g4 = C.new_group([0, 1, 2, 3])
pairs = [C.new_group([0, 1]), C.new_group([2, 3])]
g2 = pairs[rank // 2]
z = np.load(os.path.join(out, "inputs.npz"))
res = {}


def stage_fn(w, h):
    for wi in w.unbind(0):
        h = torch.tanh(h @ wi)
    return h


def run(name, group, W, x, fn=stage_fn, **kw):
    S, s = group.nranks, group.rank
    w = torch.tensor(W.reshape(S, -1, *W.shape[1:])[s], requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    y = pl.pipeline_spmd(fn, w, xt, group=group, **kw)
    y.sum().backward()
    res[name] = {"y": y.detach().numpy(),
                 "gw": None if w.grad is None else w.grad.numpy(),
                 "gx": None if xt.grad is None else xt.grad.numpy()}


run("s4", g4, z["w8"], z["x8"])
run("s2", g2, z["w8"], z["x8"])
run("s4_remat", g4, z["w8"], z["x8"], remat=True)
run("s2_remat", g2, z["w8"], z["x8"], remat=True)
ones = np.ones_like(z["x8"])
run("extras", g4, np.zeros((4, 1, 8, 8), np.float32), ones,
    fn=lambda w, h, sc: h * sc, mb_extras=(torch.tensor(z["scales"]),))


def inter(name, group, WV):
    S, s = group.nranks, group.rank
    w = torch.tensor(WV[:S][s], requires_grad=True)          # (V, 1, d, d)
    xt = torch.tensor(z["x8"], requires_grad=True)
    y = pl.pipeline_spmd_interleaved(stage_fn, w, xt, group=group)
    y.sum().backward()
    res[name] = {"y": y.detach().numpy(), "gw": w.grad.numpy(),
                 "gx": xt.grad.numpy() if xt.grad is not None else None}


inter("v4", g4, z["wv"])
inter("v2", g2, z["wv"])
# tagged p2p: rank 0 sends tags 0..3 in order, rank 1 receives them in
# reverse order; each receive takes its own tag's tensor
C.reset_counters()
if rank == 0:
    tasks = [C.isend(torch.full((3,), float(t)), 1, tag=t) for t in range(4)]
    for t in tasks:
        t.wait()
elif rank == 1:
    got = {}
    for t in reversed(range(4)):
        buf = torch.zeros(3)
        C.recv(buf, 0, tag=t)
        got[t] = buf.tolist()
    res["tags"] = got
res["routes"] = C.route_counts()
res["hops"] = pl.pipeline_stats()
np.save(os.path.join(out, f"rank{rank}.npy"), res, allow_pickle=True)
C.barrier()
C.destroy_process_group()
'''


def _jax_stage_fn(w, h):
    def body(hh, wi):
        return jnp.tanh(hh @ wi), None
    return jax.lax.scan(body, h, w)[0]


def _jax_spmd(W, x, S, remat=False):
    mesh = _pp_mesh(S)
    Wst = jnp.asarray(W.reshape(S, -1, *W.shape[1:]))

    def f(w, xx):
        return jpl.pipeline_spmd(_jax_stage_fn, w, xx, mesh=mesh,
                                 remat=remat)
    y = jax.jit(f)(Wst, jnp.asarray(x))
    gw, gx = jax.jit(jax.grad(lambda w, xx: f(w, xx).sum(),
                              argnums=(0, 1)))(Wst, jnp.asarray(x))
    return np.asarray(y), np.asarray(gw), np.asarray(gx)


def _jax_inter(WV, x, S):
    mesh = _pp_mesh(S)
    W = jnp.asarray(WV[:S])

    def f(w, xx):
        return jpl.pipeline_spmd_interleaved(_jax_stage_fn, w, xx,
                                             mesh=mesh)
    y = jax.jit(f)(W, jnp.asarray(x))
    gw, gx = jax.jit(jax.grad(lambda w, xx: f(w, xx).sum(),
                              argnums=(0, 1)))(W, jnp.asarray(x))
    return np.asarray(y), np.asarray(gw), np.asarray(gx)


@pytest.fixture(scope="module")
def schedule_job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_schedules")
    np.savez(tmp / "inputs.npz", **_inputs())
    _launch(tmp, 4, SCHEDULE_WORKER)
    return [np.load(tmp / f"rank{r}.npy", allow_pickle=True).item()
            for r in range(4)]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S,remat", [(2, False), (4, False), (2, True),
                                     (4, True)])
def test_fthenb_matches_jax(schedule_job, S, remat):
    """Output and gradients at pp S: every stage holds the last stage's
    output (broadcast), the parameter gradient of its own rows, and the
    first stage the input's gradient."""
    z = _inputs()
    y, gw, gx = _jax_spmd(z["w8"], z["x8"], S, remat)
    name = f"s{S}" + ("_remat" if remat else "")
    ranks = range(4) if S == 4 else range(2)
    for r in ranks:
        got = schedule_job[r][name]
        _close(got["y"], y)
        _close(got["gw"], gw[r % S])
    _close(schedule_job[0][name]["gx"], gx)


def test_mb_extras_travel_with_their_microbatch(schedule_job):
    z = _inputs()
    want = np.ones_like(z["x8"]) * (z["scales"] ** 4)[:, None, None]
    for r in range(4):
        np.testing.assert_allclose(schedule_job[r]["extras"]["y"], want,
                                   rtol=1e-6)


@pytest.mark.parametrize("S", [2, 4])
def test_interleaved_matches_jax(schedule_job, S):
    z = _inputs()
    y, gw, gx = _jax_inter(z["wv"], z["x8"], S)
    name = f"v{S}"
    for r in (range(4) if S == 4 else range(2)):
        got = schedule_job[r][name]
        _close(got["y"], y)
        _close(got["gw"], gw[r % S])
    _close(schedule_job[0][name]["gx"], gx)


def test_tagged_p2p_and_routes(schedule_job):
    got = schedule_job[1]["tags"]
    assert got == {t: [float(t)] * 3 for t in range(4)}
    assert schedule_job[0]["routes"]["send"] == {"gloo": 4}
    assert schedule_job[1]["routes"]["recv"] == {"gloo": 4}


def test_hop_counts(schedule_job):
    """Each microbatch hops S - 1 times each way (V S - 1 interleaved):
    over the job's runs a rank's sends equal its receives' count on its
    peers."""
    sends = sum(r["hops"]["sends"] for r in schedule_job)
    recvs = sum(r["hops"]["recvs"] for r in schedule_job)
    assert sends == recvs > 0


def test_interleaved_needs_m_divisible_by_s():
    w = torch.zeros(2, 1, D, D)
    x = torch.zeros(3, MB, D)
    with pytest.raises(ValueError, match="divisible"):
        pl.pipeline_spmd_interleaved(lambda p, h: h, w, x,
                                     group=Group([0, 1], gid=77))


def test_split_merge_microbatches_clamp():
    x = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    mb = pl.split_microbatches(torch.from_numpy(x), 4)
    jmb = jpl.split_microbatches(jnp.asarray(x), 4)
    assert tuple(mb.shape) == tuple(jmb.shape) == (3, 2, 4)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(jmb))
    np.testing.assert_array_equal(pl.merge_microbatches(mb).numpy(), x)
    assert pl.num_pipeline_stages() == 1


# ---------------------------------------------------------------------------
# PipelineLayer
# ---------------------------------------------------------------------------

class _JBlock(jnn.Layer):
    def __init__(self, d):
        super().__init__()
        self.fc1 = jnn.Linear(d, d * 2)
        self.fc2 = jnn.Linear(d * 2, d)

    def forward(self, x):
        return x + self.fc2(jnn.functional.relu(self.fc1(x)))


class _TBlock(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc1 = torch.nn.Linear(d, d * 2)
        self.fc2 = torch.nn.Linear(d * 2, d)

    def forward(self, x):
        return x + self.fc2(torch.relu(self.fc1(x)))


def _mse(o, y):
    return ((o - y) ** 2).mean()


# the models of both packages: name -> (layers, num_stages, kwargs); the
# port's are built from the port's modules (torch layout), the same
# structure
def _layers(pkg, name):
    lin, blk = (jnn.Linear, _JBlock) if pkg == "jax" else \
        (torch.nn.Linear, _TBlock)
    relu = jnn.ReLU if pkg == "jax" else torch.nn.ReLU
    Desc = jmeta.LayerDesc if pkg == "jax" else meta.LayerDesc
    Shared = jmeta.SharedLayerDesc if pkg == "jax" else meta.SharedLayerDesc
    if name == "blocks":
        return ([Desc(lin, 4, D)] + [Desc(blk, D) for _ in range(4)]
                + [Desc(lin, D, 2)]), {}
    if name == "pairs":
        return [Desc(lin, D, D), Desc(relu)] * 4, {}
    if name == "vpp":
        return ([Desc(lin, 4, D)] + [Desc(blk, D) for _ in range(4)]
                + [Desc(lin, D, 2)]), {"num_virtual_pipeline_stages": 2}
    if name == "shared":
        def tail(layer, x):
            return layer(x)[..., :2]
        return ([Shared("e", lin, None, "weight", D, D)]
                + [Desc(blk, D) for _ in range(4)]
                + [Shared("e", lin, tail, "weight", D, D)]), {}
    raise KeyError(name)


LAYER_CASES = {"blocks": 8, "pairs": 8, "vpp": 8, "shared": 8}


def _jax_model(name, loss=True):
    paddle.seed(5)
    layers, kw = _layers("jax", name)
    return jmeta.PipelineLayer(layers=layers, num_stages=2,
                               loss_fn=_mse if loss else None,
                               num_microbatches=4, **kw)


def _to_port_state(jm):
    """JAX's parameters in the port's layout: every weight of a Linear
    (2-D, or stacked (S, U, in, out)) transposed on its last two dims."""
    out = {}
    for n, p in jm.named_parameters():
        a = np.asarray(p._value)
        if n.endswith("weight") and a.ndim >= 2:
            a = np.swapaxes(a, -1, -2)
        out[n] = a
    return out


def _layer_data(name):
    """Three (x, y) batches of 8 rows at the case's input and output
    widths."""
    in_dim = 4 if name in ("blocks", "vpp") else D
    out_dim = D if name == "pairs" else 2
    rs = np.random.RandomState(9)
    return [(rs.randn(8, in_dim).astype(np.float32),
             rs.randn(8, out_dim).astype(np.float32)) for _ in range(3)]


def _jax_layer_run(name):
    """JAX's PipelineLayer on a 2-device pp mesh: the forward on the
    first batch, then 3 AdamW steps; (init, out, losses, final
    params)."""
    jm = _jax_model(name)
    init = _to_port_state(jm)
    data = _layer_data(name)
    mesh = _pp_mesh(2)
    set_current_mesh(mesh)
    place_model(jm, mesh)
    out = np.asarray(jm(paddle.to_tensor(data[0][0]))._value)
    opt = joptimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda m, b: _mse(m(b[0]), b[1]), opt)
    losses = [float(np.asarray(step(tuple(paddle.to_tensor(a) for a in b))
                               ._value)) for b in data]
    final = _to_port_state(jm)
    set_current_mesh(None)
    return init, out, losses, final


LAYER_WORKER = r'''
import faulthandler, json, os, sys
import numpy as np
import torch
faulthandler.dump_traceback_later(240, exit=True)
sys.path.insert(0, os.path.dirname(os.path.abspath(sys.argv[0])))
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.pipeline import PipelineParallel
from paddle_tpu_torch.optimizer import AdamW
import cases

out = sys.argv[1]
dist.init_parallel_env(device="cpu")
rank = dist.get_rank()
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": 1, "pp_degree": 2}
st.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
fleet.init(is_collective=True, strategy=st)
res = {}
for name in cases.NAMES:
    z = np.load(os.path.join(out, f"{name}.npz"))
    model = cases.port_model(name)
    model.load_state_dict({k: torch.from_numpy(z[f"init/{k}"])
                           for k in model.state_dict()})
    pp = fleet.distributed_model(model)
    assert isinstance(pp, PipelineParallel)
    r = {"pipelined": model._pipelined, "period": model._period,
         "units": model._units, "names": sorted(
             n for n, _ in model.named_parameters()),
         "micro": model.num_microbatches}
    x0 = torch.from_numpy(z["x0"])
    r["out"] = pp(x0).detach().numpy()
    opt = AdamW(learning_rate=1e-3, parameters=pp.parameters())
    r["losses"] = [float(pp.train_batch(
        (torch.from_numpy(z[f"x{i}"]), torch.from_numpy(z[f"y{i}"])), opt))
        for i in range(3)]
    r["final"] = {n: p.detach().numpy() for n, p in model.named_parameters()}
    res[name] = r
np.save(os.path.join(out, f"rank{rank}.npy"), res, allow_pickle=True)
C.barrier()
C.destroy_process_group()
'''

CASES_MODULE = r'''
import torch
from paddle_tpu_torch.distributed.fleet import meta_parallel as meta
D = {d}
NAMES = {names}


class TBlock(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc1 = torch.nn.Linear(d, d * 2)
        self.fc2 = torch.nn.Linear(d * 2, d)

    def forward(self, x):
        return x + self.fc2(torch.relu(self.fc1(x)))


def mse(o, y):
    return ((o - y) ** 2).mean()


def tail(layer, x):
    return layer(x)[..., :2]


def port_model(name):
    L, B = torch.nn.Linear, TBlock
    if name == "blocks":
        layers, kw = [meta.LayerDesc(L, 4, D)] + [meta.LayerDesc(B, D)
            for _ in range(4)] + [meta.LayerDesc(L, D, 2)], {{}}
    elif name == "pairs":
        layers, kw = [meta.LayerDesc(L, D, D),
                      meta.LayerDesc(torch.nn.ReLU)] * 4, {{}}
    elif name == "vpp":
        layers = [meta.LayerDesc(L, 4, D)] + [meta.LayerDesc(B, D)
            for _ in range(4)] + [meta.LayerDesc(L, D, 2)]
        kw = {{"num_virtual_pipeline_stages": 2}}
    else:
        layers = [meta.SharedLayerDesc("e", L, None, "weight", D, D)] + [
            meta.LayerDesc(B, D) for _ in range(4)] + [
            meta.SharedLayerDesc("e", L, tail, "weight", D, D)]
        kw = {{}}
    return meta.PipelineLayer(layers=layers, num_stages=2, loss_fn=mse,
                              **kw)
'''


@pytest.fixture(scope="module")
def layer_job(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_layers")
    names = list(LAYER_CASES)
    (tmp / "cases.py").write_text(CASES_MODULE.format(d=D, names=names))
    jax_runs = {}
    for name in names:
        init, out, losses, final = _jax_layer_run(name)
        jax_runs[name] = (init, out, losses, final)
        data = _layer_data(name)
        arrays = {f"init/{k}": v for k, v in init.items()}
        for i, (x, y) in enumerate(data):
            arrays[f"x{i}"], arrays[f"y{i}"] = x, y
        np.savez(tmp / f"{name}.npz", **arrays)
    _launch(tmp, 2, LAYER_WORKER)
    return jax_runs, [np.load(tmp / f"rank{r}.npy", allow_pickle=True)
                      .item() for r in range(2)]


def _stage_rows(name, a, stage):
    return a[stage:stage + 1] if name.startswith("trunk_") else a


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_pipeline_layer_matches_jax(layer_job, name):
    """The forward on every stage, the losses of 3 ``train_batch`` steps
    (4 microbatches from ``accumulate_steps``) and each stage's final
    parameters against JAX's PipelineLayer on a 2-device pp mesh."""
    jax_runs, recs = layer_job
    init, out, losses, final = jax_runs[name]
    for stage, rec in enumerate(recs):
        r = rec[name]
        assert r["pipelined"] and r["micro"] == 4
        _close(r["out"], out)
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL)
        for n, v in r["final"].items():
            # a shared layer registered again on the stage that runs its
            # later site carries that site's name
            jn = n.replace("epilogue.0.shared.", "prologue.0.")
            _close(v, _stage_rows(n, final[jn], stage))


def test_pipeline_layer_split_by_stage(layer_job):
    """Trunk detection (1-layer units, 2-layer units), each stage's
    rows, the prologue on the first stage and the epilogue on the last;
    the shared layer on both."""
    _, recs = layer_job
    assert (recs[0]["blocks"]["period"], recs[0]["blocks"]["units"]) == \
        (1, 4)
    assert (recs[0]["pairs"]["period"], recs[0]["pairs"]["units"]) == (2, 4)
    assert any(n.startswith("prologue") for n in recs[0]["blocks"]["names"])
    assert not any(n.startswith("epilogue")
                   for n in recs[0]["blocks"]["names"])
    assert any(n.startswith("epilogue") for n in recs[1]["blocks"]["names"])
    assert not any(n.startswith("prologue")
                   for n in recs[1]["blocks"]["names"])
    for rec in recs:
        assert any("shared" in n or n.startswith(("prologue", "epilogue"))
                   for n in rec["shared"]["names"])
        for n, v in rec["vpp"]["final"].items():
            if n.startswith("trunk_"):
                assert v.shape[:3] == (1, 2, 1)      # (S=1 local, V, U)


def test_pipeline_layer_in_one_process():
    torch.manual_seed(0)
    with pytest.warns(UserWarning, match="no periodic trunk"):
        m = meta.PipelineLayer(layers=[meta.LayerDesc(torch.nn.Linear, 4, 8),
                                       meta.LayerDesc(torch.nn.Linear, 8, 2)],
                               num_stages=2)
    assert not m._pipelined and m(torch.zeros(2, 4)).shape == (2, 2)

    class BufBlock(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(4, 4)
            self.register_buffer("mu", torch.zeros(4))

        def forward(self, x):
            return self.fc(x) + self.mu
    with pytest.warns(UserWarning, match="no periodic trunk"):
        m = meta.PipelineLayer(layers=[meta.LayerDesc(BufBlock)
                                       for _ in range(4)], num_stages=2)
    assert not m._pipelined

    m = meta.PipelineLayer(layers=[meta.LayerDesc(_TBlock, D)
                                   for _ in range(4)], num_stages=4)
    assert m._pipelined and m.get_stage_from_index(3) == 3
    assert [p.pp_stage for p in m._protos[0].parameters()] == [0] * 4
    m.pp_group = Group([0, 1], gid=78)
    with pytest.raises(InvalidArgumentError, match="pp=2"):
        m(torch.zeros(4, D))

    calls = []

    def fwd(layer, x):
        calls.append(1)
        return layer(x)
    m = meta.PipelineLayer(layers=[
        meta.SharedLayerDesc("e", torch.nn.Linear, fwd, "weight", 4, 4),
        meta.SharedLayerDesc("e", torch.nn.Linear, fwd, "weight", 4, 4)],
        num_stages=1)
    assert len(list(m.parameters())) == 2
    m(torch.ones(2, 4))
    assert len(calls) == 2
    wrapped = pl.PipelineParallel(m)
    with pytest.raises(ValueError, match="loss_fn"):
        wrapped.train_batch((torch.zeros(2, 4), torch.zeros(2, 4)), None)


def test_jax_signature_rules_hold():
    assert meta._layer_signature(torch.relu) != \
        meta._layer_signature(torch.tanh)
    assert meta._layer_signature(torch.nn.Dropout(0.1)) != \
        meta._layer_signature(torch.nn.Dropout(0.5))
    sigs = ["a", "b", "b", "b", "b", "c"]
    assert meta._find_periodic_trunk(sigs, 2) == \
        jmeta._find_periodic_trunk(sigs, 2)
