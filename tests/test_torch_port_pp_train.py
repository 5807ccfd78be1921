"""Pipeline-parallel (pp) training of the port's Llama against the JAX
package, on the CPU.

Port side: ``tools/port_pp_worker.py``'s ``train`` in gloo jobs through
``launch_pod`` (the worker below): pp 2 on 2 ranks, pp 2 x dp 2 and pp 2
x mp 2 on 4, and dp 2 and mp 2 without pp (the schedule's microbatches
on each rank, ``one_rank_schedule``) on 2; ``fleet.init``,
``fleet.distributed_model`` of a whole 4-layer ``llama_tiny_config(
pipeline_parallel=True, pp_num_microbatches=4)`` with full recompute,
loaded with the JAX model's weights (``convert.params_from_jax``; at
``virtual_pp=2`` JAX's (V, L/V, ...) stacks), AdamW (lr 1e-4, wd 0.01),
3 steps on ``RandomState(0)``'s batches. JAX side: the same model,
weights and batches through JAX's ``TrainStep`` on a 2-device ``"pp"``
mesh (2 x 2 ``dp`` x ``pp`` and ``pp`` x ``mp`` ones for the 4-rank
jobs). Held in fp32:

- each step's loss within 1e-5 relative of JAX's, and each step's
  parameters (every rank's regions of JAX's global tensors put
  together) within 1e-5 (norm of the difference over the norm, per
  tensor) of JAX's: ``virtual_pp`` 1 and 2, the fused and the unfused
  head, GQA, the tied head (its weight on both stages, its gradient
  summed between them), and labels with ``ignore_index`` spread unevenly
  over the microbatches (the loss is the batch's mean over its valid
  tokens, as JAX's head on the merged batch gives it); the user's loop
  (forward, ``backward()``, ``opt.step()``) and ``jit.TrainStep``;
- at pp 2, bit-identical to rank 0's one-rank run of the same
  microbatches in the same order (the worker's ``--reference``); at pp 2
  x dp 2 and pp 2 x mp 2, bit-identical to the dp 2 and mp 2 runs
  without pp on the same microbatches;
- the pp checkpoint (``save_state_dict(convert.jax_state_dict(model))``)
  loads in JAX's ``load_state_dict`` with JAX's global shapes, at one
  port rank, and back at pp 2, bit for bit;
- ``pipeline_parallel=True`` with no pp group leaves a one-rank step's
  bits as ``scan_layers=True`` gives them; ``virtual_pp=2`` with no pp
  group runs JAX's flattened layer order; ``TrainStep`` runs a pp-split
  model eagerly and says why."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_current_mesh)
from paddle_tpu.distributed.sharding_utils import place_model, shard_batch
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch.convert import (jax_state_dict, params_from_jax,
                                      params_from_jax_mp)
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.communication import Group
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.optimizer import AdamW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LR, WD = 1e-4, 0.01             # tools/port_mp_worker.py's
STEPS, BATCH, SEQ, LAYERS, MICRO = 3, 4, 16, 4, 4
BASE = {"num_hidden_layers": LAYERS, "recompute": True,
        "tensor_parallel": False}
# name -> (fields, virtual_pp, labels with ignore_index, jit.TrainStep)
PP_CASES = {
    "v1_fused_ignore": ({}, 1, True, False),
    "v2_unfused_gqa": ({"fused_head_ce": False, "num_key_value_heads": 2},
                       2, False, False),
    "v1_tied_gqa": ({"tie_word_embeddings": True, "num_key_value_heads": 2},
                    1, False, False),
    "v2_train_step": ({}, 2, False, True),
}
CKPT_CASE = "v1_fused_ignore"
# the 4-rank jobs (pp 2 x dp 2, pp 2 x mp 2) and the runs without pp they
# are held to bit for bit: name -> (dp, mp, pp, microbatched)
MESH_CASES = {"pp2dp2": (2, 1, 2, False), "pp2mp2": (1, 2, 2, False),
              "dp2": (2, 1, 1, True), "mp2": (1, 2, 1, True)}

WORKER = r'''
import faulthandler, json, os, sys
import torch
faulthandler.dump_traceback_later(600, exit=True)
import tools.port_pp_worker as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import communication as C

out = sys.argv[1]
with open(os.path.join(out, "cases.json")) as f:
    cases = json.load(f)
dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
cpu = torch.device("cpu")
store = C._get_store()
for name, c in cases.items():
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": c["dp"], "mp_degree": c["mp"],
                         "pp_degree": c["pp"]}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    argv = ["--out", d, "--config", "tiny", "--kw", json.dumps(c["kw"]),
            "--device", "cpu", "--batch", sys.argv[2], "--seq", sys.argv[3],
            "--steps", sys.argv[4], "--micro", sys.argv[5], "--pp",
            str(c["pp"]), "--mp", str(c["mp"]), "--vpp", str(c["vpp"]),
            "--tag", name, "--init", c["init"], "--save-params"]
    if c["ignore"]:
        argv.append("--ignore")
    if c["microbatched"]:
        argv.append("--microbatched")
    if c["train_step"]:
        argv.append("--train-step")
    if c["ckpt"]:
        argv += ["--ckpt", os.path.join(d, "ckpt")]
    args = W.parse(argv)
    dp, dp_rank = hcg.get_data_parallel_world_size(), \
        hcg.get_data_parallel_rank()
    steps = W.data(args, W.config(args), dp, dp_rank, cpu)
    ref = None
    if c["reference"]:
        if rank == 0:
            ref = W.run_reference(args, cpu, steps)
            import numpy as np
            np.savez(os.path.join(d, "reference.npz"), **{
                f"{s}/{k}": v.numpy()
                for s, ps in enumerate(ref["params"], 1)
                for k, v in ps.items()})
        C.barrier()
    rec = W.train(args, c["vpp"], cpu, rank, world, hcg, store, ref, steps)
    if c["ckpt"]:
        C.barrier()
        largs = W.parse(argv[:-2] + ["--seed", "9", "--load",
                                     os.path.join(d, "ckpt")])
        model, _ = W.build(largs, W.config(largs, c["vpp"]), cpu)
        fleet.distributed_model(model)
        rec["reload"] = W.load_and_check(largs, model, rank)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    C.barrier()
C.destroy_process_group()
'''


def _batches(dp, ignore, vocab=512):
    """The worker's batches (``port_mp_worker.batches`` and ``--ignore``):
    step k's global rows of RandomState(0)."""
    n = dp * BATCH * STEPS
    ids = np.random.RandomState(0).randint(0, vocab, (n, SEQ)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    g = dp * BATCH
    out = []
    for k in range(STEPS):
        i, lab = ids[k * g:(k + 1) * g], labels[k * g:(k + 1) * g].copy()
        if ignore:
            for r in range(dp):
                lab[r * BATCH, :SEQ // 2] = -100
                lab[r * BATCH + 2, 1:4] = -100
        out.append((i, lab))
    return out


def _jax_named(jm):
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _jax_config(kw, vpp, mp):
    return jax_tiny_config(**dict(BASE, **kw, tensor_parallel=mp > 1,
                                  pipeline_parallel=True,
                                  pp_num_microbatches=MICRO,
                                  virtual_pp=vpp))


def _jax_run(kw, vpp, ignore, dp=1, mp=1, pp=2):
    """JAX's model on a dp x pp x mp mesh: (initial weights, losses,
    each step's parameters), weights in JAX's layout."""
    paddle.seed(0)
    jm = JaxLlama(_jax_config(kw, vpp, mp))
    init = _jax_named(jm)
    hcg = HybridCommunicateGroup(dp_degree=dp, mp_degree=mp, pp_degree=pp,
                                 devices=jax.devices()[:dp * mp * pp])
    mesh = hcg.jax_mesh
    place_model(jm, mesh)
    opt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                           parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda m, b: m(*b)[0], opt)
    losses, params = [], []
    for ids, labels in _batches(dp, ignore):
        batch = tuple(shard_batch(mesh, paddle.to_tensor(a), P("dp"))
                      for a in (ids, labels))
        losses.append(float(np.asarray(step(batch)._value)))
        params.append(_jax_named(jm))
    set_current_mesh(None)
    from paddle_tpu.distributed import mesh as jmesh
    jmesh._HCG = None
    return init, losses, params


def _launch(tmp, world, cases):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    (tmp / "cases.json").write_text(json.dumps(cases))
    cfg = LaunchConfig(str(script), [str(tmp), str(BATCH), str(SEQ),
                                     str(STEPS), str(MICRO)],
                       nproc_per_node=world, log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": REPO + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs


def _assemble(d, world, vpp):
    """Each step's global parameters (JAX's layout) from every rank's
    regions; a region two ranks hold must hold the same bits."""
    out = {}
    for r in range(world):
        z = np.load(d / f"params{r}_v{vpp}.npz")
        for key in z.files:
            if "/" not in key or key.startswith(("region/", "shape/")):
                continue
            step, name = key.split("/", 1)
            full = out.setdefault(step, {}).setdefault(
                name, np.full(tuple(z[f"shape/{name}"]), np.nan,
                              np.float32))
            idx = tuple(slice(a, b) for a, b in z[f"region/{name}"])
            held = full[idx]
            if not np.isnan(held).all():
                np.testing.assert_array_equal(held, z[key], err_msg=name)
            full[idx] = z[key]
    for step in out.values():
        for name, v in step.items():
            assert not np.isnan(v).any(), name
    return out


def _case(kw, vpp, ignore, init, dp=1, mp=1, pp=2, microbatched=False,
          reference=False, ckpt=False, train_step=False):
    return {"kw": dict(BASE, **kw, tensor_parallel=mp > 1), "vpp": vpp,
            "ignore": ignore, "init": init, "dp": dp, "mp": mp, "pp": pp,
            "microbatched": microbatched, "reference": reference,
            "ckpt": ckpt, "train_step": train_step}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job and the JAX runs they are held to."""
    root = tmp_path_factory.mktemp("pp_train")
    jax_runs, cases2, cases4, cases_mb = {}, {}, {}, {}
    for name, (kw, vpp, ignore, train_step) in PP_CASES.items():
        jax_runs[name] = _jax_run(kw, vpp, ignore)
        init = str(root / f"{name}_init.npz")
        np.savez(init, **{k: v.numpy() for k, v in params_from_jax(
            jax_runs[name][0]).items()})
        cases2[name] = _case(kw, vpp, ignore, init, reference=True,
                             ckpt=name == CKPT_CASE, train_step=train_step)
    for name, (dp, mp, pp, mb) in MESH_CASES.items():
        if pp > 1:
            jax_runs[name] = _jax_run({}, 1, False, dp=dp, mp=mp, pp=pp)
        init = str(root / f"mesh_mp{mp}_init.npz")
        if not os.path.exists(init):
            paddle.seed(0)
            jm = JaxLlama(_jax_config({}, 1, mp))
            np.savez(init, **{k: v.numpy() for k, v in params_from_jax(
                _jax_named(jm)).items()})
        (cases4 if pp > 1 else cases_mb)[name] = _case(
            {}, 1, False, init, dp=dp, mp=mp, pp=pp, microbatched=mb)
    jobs = {}
    for tag, world, cases in (("pp2", 2, cases2), ("mesh4", 4, cases4),
                              ("nopp", 2, cases_mb)):
        tmp = root / tag
        tmp.mkdir()
        _launch(tmp, world, cases)
        for name, c in cases.items():
            d = tmp / name
            recs = [json.loads((d / f"rank{r}.json").read_text())
                    for r in range(world)]
            jobs[name] = (recs, _assemble(d, world, c["vpp"]), d)
    return jax_runs, jobs


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_close_to_jax(name, params, jlosses, jparams, recs):
    np.testing.assert_allclose(recs[0]["losses"], jlosses, rtol=TOL)
    for rec in recs:
        assert rec["losses"] == recs[0]["losses"]
        assert rec["failed"] == []
    for step in range(1, STEPS + 1):
        for n, w in jparams[step - 1].items():
            assert _relnorm(params[str(step)][n], w) <= TOL, (name, step, n)


@pytest.mark.parametrize("name", list(PP_CASES))
def test_pp_steps_match_jax_and_one_rank(runs, name):
    jax_runs, jobs = runs
    _, jlosses, jparams = jax_runs[name]
    recs, params, d = jobs[name]
    _assert_close_to_jax(name, params, jlosses, jparams, recs)
    # every region of both stages, bit for bit, to rank 0's one-rank run
    # of the same microbatches (the worker's own check, and here again)
    checks = recs[0]["reference_checks"]
    assert len(checks) == STEPS and all(c["differ"] == 0 and c["checked"]
                                        for c in checks)
    assert recs[0]["losses"] == recs[0]["reference_losses"]
    ref = np.load(d / "reference.npz")
    for step in range(1, STEPS + 1):
        for n, v in params[str(step)].items():
            np.testing.assert_array_equal(
                v, ref[f"{step}/{n}"].reshape(v.shape), err_msg=n)
    # a stage holds its rows and the modules it runs; the hops; through
    # jit.TrainStep the step runs eagerly and says why
    S, vpp, train_step = 2, PP_CASES[name][1], PP_CASES[name][3]
    for rec in recs:
        assert (rec["eager_reason"] is not None) == train_step
        assert not train_step or "pp process group" in rec["eager_reason"]
    for rec in recs:
        assert rec["local_params"] < rec["params"]
        assert all(h["sends"] == h["recvs"] == MICRO * (2 * vpp - 1)
                   and h["routes"]["send"] == {"gloo": h["sends"]}
                   for h in rec["p2p"])
        assert rec["expected_launches"]["rms_norm"] == \
            4 * LAYERS // S * MICRO + rec["stage"]


def test_ignore_index_gives_the_batch_mean(runs):
    """The loss of labels with -100 spread unevenly over the microbatches
    is the batch's mean over its valid tokens (JAX's, above), not the
    mean of the microbatches' means, which differs here."""
    jax_runs, jobs = runs
    recs, _, _ = jobs["v1_fused_ignore"]
    ids, labels = _batches(1, True)[0]
    m = LlamaForCausalLM(llama_tiny_config(**BASE, pipeline_parallel=True),
                         device="cpu")
    m.load_state_dict(params_from_jax(jax_runs["v1_fused_ignore"][0]))
    with torch.no_grad():
        per_mb = [float(m(torch.from_numpy(ids[i:i + 1]),
                          torch.from_numpy(labels[i:i + 1]))[0])
                  for i in range(BATCH)]
        whole = float(m(torch.from_numpy(ids), torch.from_numpy(labels))[0])
    assert abs(np.mean(per_mb) - whole) > 10 * TOL * abs(whole)
    np.testing.assert_allclose(recs[0]["losses"][0], whole, rtol=TOL)


@pytest.mark.parametrize("name,plain", [("pp2dp2", "dp2"),
                                        ("pp2mp2", "mp2")])
def test_pp_with_dp_and_mp(runs, name, plain):
    """pp 2 x dp 2 and pp 2 x mp 2 on 4 ranks: within 1e-5 of JAX's run
    on the same mesh, and bit-identical to the port's dp 2 or mp 2 run
    without pp on the same microbatches."""
    jax_runs, jobs = runs
    _, jlosses, jparams = jax_runs[name]
    recs, params, _ = jobs[name]
    _assert_close_to_jax(name, params, jlosses, jparams, recs)
    precs, pparams, _ = jobs[plain]
    assert recs[0]["losses"] == precs[0]["losses"]
    for step in range(1, STEPS + 1):
        for n, v in params[str(step)].items():
            np.testing.assert_array_equal(v, pparams[str(step)][n],
                                          err_msg=(name, n))
    assert {r["stage"] for r in recs} == {0, 1}


def test_pp_checkpoint_loads_in_jax_one_rank_and_pp2(runs):
    jax_runs, jobs = runs
    recs, params, d = jobs[CKPT_CASE]
    path = str(d / "ckpt")
    final = params[str(STEPS)]
    meta = json.loads((d / "ckpt" / "metadata.json").read_text())
    init = jax_runs[CKPT_CASE][0]
    for n, v in init.items():                # JAX's names and shapes
        assert meta[n]["shape"] == list(v.shape), n
        assert len(meta[n]["shards"]) == (2 if "__" in n else 1), n
    tgt = {n: paddle.to_tensor(np.zeros_like(v)) for n, v in init.items()}
    jckpt.load_state_dict(tgt, path)
    for n, v in final.items():
        np.testing.assert_array_equal(np.asarray(tgt[n]._value), v,
                                      err_msg=n)
    one = LlamaForCausalLM(llama_tiny_config(**BASE, pipeline_parallel=True),
                           device="cpu", seed=9)
    sd = jax_state_dict(one)
    ckpt.load_state_dict(sd, path)
    for n, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), final[n], err_msg=n)
    for rec in recs:
        assert rec["reload"]["regions_checked"] > 0


def _one_step(**kw):
    torch.manual_seed(0)
    m = LlamaForCausalLM(llama_tiny_config(**BASE, **kw), device="cpu")
    opt = AdamW(learning_rate=LR, weight_decay=WD, parameters=m.parameters())
    step = TrainStep(m, lambda mm, b: mm(*b)[0], opt)
    ids, labels = _batches(1, False)[0]
    loss = step((torch.from_numpy(ids), torch.from_numpy(labels)))
    return float(loss), m


def test_pipeline_parallel_without_a_group_changes_no_bit():
    a, ma = _one_step(pipeline_parallel=True)
    b, mb = _one_step(scan_layers=True)
    assert a == b
    for (n, p), (_, q) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(p, q), n


def test_virtual_pp_without_a_group_matches_jax_flattened():
    """``virtual_pp=2`` with no pp group: the (V, L/V, ...) storage runs
    in global layer order, as JAX's does without a pp mesh axis; the
    same weights stored at V = 1 give the same bits."""
    paddle.seed(0)
    cfg = _jax_config({}, 2, 1)
    jm = JaxLlama(cfg)
    ids, labels = _batches(1, True)[0]
    jloss = float(np.asarray(jm(paddle.to_tensor(ids),
                                paddle.to_tensor(labels))[0]._value))
    sd = params_from_jax(_jax_named(jm))
    m2 = LlamaForCausalLM(llama_tiny_config(**BASE, pipeline_parallel=True,
                                            virtual_pp=2), device="cpu")
    m2.load_state_dict(sd)
    m1 = LlamaForCausalLM(llama_tiny_config(**BASE, pipeline_parallel=True),
                          device="cpu")
    m1.load_state_dict({k: v.reshape(m1.get_parameter(k).shape)
                        for k, v in sd.items()})
    l2 = m2(torch.from_numpy(ids), torch.from_numpy(labels))[0]
    l1 = m1(torch.from_numpy(ids), torch.from_numpy(labels))[0]
    np.testing.assert_allclose(float(l2), jloss, rtol=TOL)
    assert float(l2) == float(l1)
    assert m2.llama.layers.self_attn__q_proj__weight.shape[:2] == (2, 2)


@pytest.mark.parametrize("vpp", [1, 2])
def test_params_from_jax_mp_splits_a_pipelined_model_over_mp(vpp):
    """A pipelined tensor-parallel model's specs lead its stacks with
    "pp" (``("pp", "mp", None)``); ``params_from_jax_mp`` still splits
    the mp dimension only, and keeps every layer."""
    paddle.seed(0)
    named = _jax_named(JaxLlama(_jax_config({}, vpp, 2)))
    full = params_from_jax(named)
    m = LlamaForCausalLM(llama_tiny_config(**dict(
        BASE, tensor_parallel=True, pipeline_parallel=True,
        virtual_pp=vpp)), device="cpu")
    specs = m.partition_specs()
    both = [n for n, s in specs.items() if s and "pp" in s and "mp" in s]
    assert both
    for rank in (0, 1):
        got = params_from_jax_mp(named, specs, rank, 2)
        for n, t in full.items():
            s = specs.get(n)
            if not s or "mp" not in s:
                assert torch.equal(got[n], t), n
                continue
            d = s.index("mp")
            k = t.shape[d] // 2
            assert torch.equal(got[n], t.narrow(d, rank * k, k)), n
            if "pp" in s:           # every layer (and chunk) kept
                assert got[n].shape[:d] == t.shape[:d], n


def test_config_and_eager_train_step():
    llama_tiny_config(pipeline_parallel=True, virtual_pp=2,
                      num_hidden_layers=4)
    # sequence parallelism is ported (A.6 (e3)); beside pp, fleet.init
    # refuses it (A.6 (e5), tests/test_torch_port_sep_train.py)
    assert llama_tiny_config(sequence_parallel=True).sequence_parallel
    with pytest.raises(ValueError, match="virtual_pp"):
        llama_tiny_config(virtual_pp=2)
    m = LlamaForCausalLM(llama_tiny_config(**BASE, pipeline_parallel=True),
                         device="cpu")
    step = TrainStep(m, lambda mm, b: mm(*b)[0],
                     AdamW(learning_rate=LR, parameters=m.parameters()))
    assert step.eager_reason is None
    m.llama.layers.pp_group = Group([0, 1], gid=97)
    assert "pp process group" in step.eager_reason
    assert "runs eagerly" in step.eager_reason
    specs = m.partition_specs()
    assert specs["llama.layers.self_attn__q_proj__weight"] == \
        ("pp", None, None)
    assert specs["llama.embed_tokens.weight"] is None
