"""Sequence-parallel (sep) training of the port's Llama against the JAX
package, on the CPU.

Port side: ``tools/port_sep_worker.py``'s ``train`` in gloo jobs through
``launch_pod`` (the worker below): sep 2 on 2 ranks, and sep 4, sep 2 x
dp 2 and sep 2 x mp 2 on 4; ``fleet.init``, ``fleet.distributed_model``
of a whole 2-layer ``llama_tiny_config(sequence_parallel=True,
sequence_parallel_mode=m)``, loaded with the JAX model's weights
(``convert.params_from_jax``), AdamW (lr 1e-4, wd 0.01), 3 steps on
``RandomState(0)``'s batches of 16 tokens, each rank passing its piece
of every sequence; each case runs the three modes (ring, ulysses,
megatron) from the same weights. JAX side: the same model, weights and
batches through JAX's ``TrainStep`` on the matching mesh (``P("dp",
"sep")`` batches), in one of the modes (JAX's three agree to rounding).
Held in fp32:

- each step's loss within 1e-5 relative of JAX's, step 1's gradients
  (after the sum over sep and the dp mean, before the update) within
  1e-5 (per tensor, as below) of JAX's gradients of the same loss at
  the same weights, and each step's parameters (every rank's regions
  of JAX's global tensors put together; a region two ranks hold must
  hold the same bits, so the sep ranks' parameters and gradients are
  bit-identical) within 1e-5 (norm of the
  difference over the norm, per tensor) of JAX's: the layer list and the
  stacked trunk with full recompute, the fused and the unfused head,
  GQA, the vocab-parallel fused head under sep x mp, labels with
  ``ignore_index`` spread unevenly over the pieces (the loss is the
  sequence's mean, not a mean of the ranks' means); the user's loop and
  ``jit.TrainStep`` (eager under a sep group, which it says);
- the exchanges each step runs (the worker's ``expected_exchanges``:
  under full recompute the forward's hops, all-to-alls or gathers run
  again inside the recompute) and the ranks' agreement on the loss;
- the sep 2 x mp 2 checkpoint (``save_state_dict(convert.jax_state_
  dict(model))``) writes each region once and loads in JAX's
  ``load_state_dict`` with JAX's global shapes, and back at sep 2 x mp 2;
- ``io.DistributedBatchSampler`` defaults to the dp degree and rank;
- in one process: ``sequence_parallel=True`` with no group changes no
  bit; ``fleet.init`` refuses sep beside pp or sharding naming ROADMAP.md
  A.6 (e5); a model that is not sequence-parallel is refused at sep > 1."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import framework
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_current_mesh)
from paddle_tpu.distributed.sharding_utils import place_model, shard_batch
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.communication import Group
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.optimizer import AdamW

import tools.port_sep_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LR, WD = W.LR, W.WD
STEPS, BATCH, SEQ = 3, 2, 16
MODES = ("ring", "ulysses", "megatron")
BASE = {"num_hidden_layers": 2, "tensor_parallel": False}
STACKED = {"scan_layers": True, "recompute": True}
# name -> (dp, mp, sep, model fields, JAX's mode, labels with -100,
#          jit.TrainStep, checkpoint)
CASES = {
    "sep2": (1, 1, 2, {}, None, True, False, False),
    "sep2_train_step": (1, 1, 2, {}, "ring", True, True, False),
    "sep4": (1, 1, 4, dict(STACKED, num_key_value_heads=2), "ulysses",
             False, False, False),
    "sep2dp2": (2, 1, 2, {"fused_head_ce": False}, "megatron", True,
                False, False),
    "sep2mp2": (1, 2, 2, dict(STACKED, tensor_parallel=True), "ring",
                True, False, True),
}

WORKER = r'''
import faulthandler, json, os, sys
import torch
faulthandler.dump_traceback_later(600, exit=True)
import tools.port_sep_worker as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import io
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
                         "sep_degree": c["sep"]}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    argv = ["--out", d, "--config", "tiny", "--kw", json.dumps(c["kw"]),
            "--device", "cpu", "--batch", sys.argv[2], "--seq", sys.argv[3],
            "--steps", sys.argv[4], "--sep", str(c["sep"]), "--mp",
            str(c["mp"]), "--modes", c["modes"], "--tag", name,
            "--init", c["init"], "--save-params"]
    if c["ignore"]:
        argv.append("--ignore")
    if c["train_step"]:
        argv.append("--train-step")
    if c["ckpt"]:
        argv += ["--ckpt", os.path.join(d, "ckpt")]
    args = W.parse(argv)
    steps = W.data(args, W.config(args), hcg.get_data_parallel_world_size(),
                   hcg.get_data_parallel_rank(),
                   hcg.get_sep_parallel_world_size(),
                   hcg.get_sep_parallel_rank(), cpu)
    recs = [W.train(args, m, cpu, rank, world, hcg, store, None, steps)
            for m in c["modes"].split(",")]
    sampler = io.DistributedBatchSampler(list(range(8)), 2)
    rec = {"runs": recs, "sampler": [sampler.nranks, sampler.local_rank],
           "dp_rank": hcg.get_data_parallel_rank()}
    if c["ckpt"]:
        C.barrier()
        largs = W.parse(argv[:-2] + ["--seed", "9", "--load",
                                     os.path.join(d, "ckpt")])
        model, _ = W.build(largs, W.config(largs, "ring"), cpu)
        fleet.distributed_model(model)
        rec["reload"] = W.load_and_check(largs, model, rank)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    C.barrier()
C.destroy_process_group()
'''


def _batches(dp, ignore, vocab=512):
    """The worker's global batches (``port_mp_worker.batches`` and
    ``--ignore``): step k's rows of RandomState(0)."""
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
                W.ignore_labels(lab[r * BATCH:(r + 1) * BATCH])
        out.append((i, lab))
    return out


def _jax_named(jm):
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _jax_config(kw, mode):
    return jax_tiny_config(**dict(BASE, **kw, sequence_parallel=True,
                                  sequence_parallel_mode=mode or "ring"))


def _jax_grads(jm, batch):
    """The gradients of JAX's loss at ``jm``'s weights as its
    ``TrainStep`` takes them: the model in functional mode under
    ``jax.grad``, jitted (ring and Ulysses bind their ``shard_map`` only
    under a trace)."""
    named = dict(jm.named_parameters())

    def loss(vals, b):
        saved = {n: p._value for n, p in named.items()}
        try:
            for n, v in vals.items():
                named[n]._value = v
            with framework.functional_mode():
                return jm(*jax.tree.map(Tensor, b))[0]._value
        finally:
            for n, v in saved.items():
                named[n]._value = v
    g = jax.jit(jax.grad(loss))({n: p._value for n, p in named.items()},
                                tuple(t._value for t in batch))
    return {n: np.asarray(v) for n, v in g.items()}


def _jax_run(kw, mode, ignore, dp, mp, sep):
    """JAX's model on a dp x sep x mp mesh: (initial weights, losses, each
    step's parameters, the gradients of step 1's loss at the initial
    weights), in JAX's layout."""
    paddle.seed(0)
    jm = JaxLlama(_jax_config(kw, mode))
    init = _jax_named(jm)
    hcg = HybridCommunicateGroup(dp_degree=dp, mp_degree=mp,
                                 sep_degree=sep,
                                 devices=jax.devices()[:dp * mp * sep])
    mesh = hcg.jax_mesh
    place_model(jm, mesh)
    opt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                           parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda m, b: m(*b)[0], opt)
    losses, params, grads = [], [], None
    for ids, labels in _batches(dp, ignore):
        batch = tuple(shard_batch(mesh, paddle.to_tensor(a), P("dp", "sep"))
                      for a in (ids, labels))
        if grads is None:
            grads = _jax_grads(jm, batch)
        losses.append(float(np.asarray(step(batch)._value)))
        params.append(_jax_named(jm))
    set_current_mesh(None)
    from paddle_tpu.distributed import mesh as jmesh
    jmesh._HCG = None
    return init, losses, params, grads


def _launch(tmp, world, cases):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    (tmp / "cases.json").write_text(json.dumps(cases))
    cfg = LaunchConfig(str(script), [str(tmp), str(BATCH), str(SEQ),
                                     str(STEPS)],
                       nproc_per_node=world, log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": REPO + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs


def _assemble(d, world, mode):
    """Each step's global parameters (JAX's layout) from every rank's
    regions; a region two ranks hold must hold the same bits."""
    out = {}
    for r in range(world):
        z = np.load(d / f"params{r}_{mode}.npz")
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port job and the JAX runs they are held to."""
    root = tmp_path_factory.mktemp("sep_train")
    jax_runs, by_world, done = {}, {2: {}, 4: {}}, {}
    for name, (dp, mp, sep, kw, jmode, ignore, train_step, ck) in \
            CASES.items():
        modes = (jmode,) if train_step else MODES
        for m in ((jmode,) if jmode else MODES):
            key = (json.dumps(kw, sort_keys=True), m, ignore, dp, mp, sep)
            if key not in done:
                done[key] = _jax_run(kw, m, ignore, dp, mp, sep)
            jax_runs[(name, m)] = done[key]
        init = str(root / f"{name}_init.npz")
        first = jax_runs[(name, jmode or "ring")][0]
        np.savez(init, **{k: v.numpy() for k, v in params_from_jax(
            first).items()})
        by_world[dp * mp * sep][name] = {
            "dp": dp, "mp": mp, "sep": sep,
            "kw": dict(BASE, **kw), "modes": ",".join(modes),
            "ignore": ignore, "train_step": train_step, "ckpt": ck,
            "init": init}
    jobs = {}
    for world, cases in by_world.items():
        tmp = root / f"w{world}"
        tmp.mkdir()
        _launch(tmp, world, cases)
        for name, c in cases.items():
            d = tmp / name
            recs = [json.loads((d / f"rank{r}.json").read_text())
                    for r in range(world)]
            params = {m: _assemble(d, world, m) for m in c["modes"].split(",")}
            jobs[name] = (recs, params, d)
    return jax_runs, jobs


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", [n for n in CASES
                                  if not CASES[n][6]])
def test_sep_steps_match_jax(runs, name, mode):
    """Each mode's losses and parameters against JAX's run on the
    matching mesh (its mode, or every mode at sep 2); the ranks agree
    and ran the exchanges the mode implies."""
    jax_runs, jobs = runs
    jmode = CASES[name][4]
    _, jlosses, jparams, _ = jax_runs[(name, jmode or mode)]
    recs, params, _ = jobs[name]
    runs_ = [next(r for r in rec["runs"] if r["mode"] == mode)
             for rec in recs]
    for rec, run in zip(recs, runs_):
        assert run["failed"] == []
        np.testing.assert_allclose(run["losses"], jlosses, rtol=TOL)
        assert run["losses"] == runs_[0]["losses"] or \
            rec["dp_rank"] != recs[0]["dp_rank"]
        for got in run["exchanges"]:
            calls = {k: v["calls"] for k, v in got.items()}
            assert calls == run["expected_exchanges"]
        assert run["eager_reason"] is None
    for step in range(1, STEPS + 1):
        for n, w in jparams[step - 1].items():
            assert _relnorm(params[mode][str(step)][n], w) <= TOL, \
                (name, mode, step, n)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", [n for n in CASES
                                  if not CASES[n][6]])
def test_sep_gradients_match_jax(runs, name, mode):
    """Step 1's gradients after the sum over sep and the dp mean, before
    the update (every rank's regions put together; the ranks that hold a
    region hold the same bits), against the gradients of JAX's loss on
    the matching mesh, per tensor. A loss whose backward multiplies by
    S, or a mean over sep where a sum is due, scales a gradient by S or
    1/S, which the parameters after AdamW, blind to a common scale,
    would not show."""
    jax_runs, jobs = runs
    jgrads = jax_runs[(name, CASES[name][4] or mode)][3]
    _, params, _ = jobs[name]
    got = params[mode]["grad"]
    assert set(got) == set(jgrads)
    for n, w in jgrads.items():
        assert _relnorm(got[n], w) <= TOL, \
            (name, mode, n, _relnorm(got[n], w))


def test_train_step_runs_eagerly_and_matches_jax(runs):
    jax_runs, jobs = runs
    _, jlosses, jparams, _ = jax_runs[("sep2_train_step", "ring")]
    recs, params, _ = jobs["sep2_train_step"]
    for rec in recs:
        (run,) = rec["runs"]
        assert "sep process group" in run["eager_reason"]
        assert "runs eagerly" in run["eager_reason"]
        np.testing.assert_allclose(run["losses"], jlosses, rtol=TOL)
    for n, w in jparams[-1].items():
        assert _relnorm(params["ring"][str(STEPS)][n], w) <= TOL, n


def test_ignore_index_gives_the_sequence_mean(runs):
    """The loss of labels with -100 spread unevenly over the pieces is
    the sequence's mean over its valid tokens (JAX's, above), not the
    mean of the pieces' means, which differs here."""
    jax_runs, jobs = runs
    recs, _, _ = jobs["sep2"]
    ids, labels = _batches(1, True)[0]
    m = LlamaForCausalLM(llama_tiny_config(**BASE), device="cpu")
    m.load_state_dict(params_from_jax(jax_runs[("sep2", "ring")][0]))
    with torch.no_grad():
        logits = m(torch.from_numpy(ids))
    lab = torch.from_numpy(labels).long()
    tok = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), lab.reshape(-1),
        ignore_index=-100, reduction="none").reshape(lab.shape)
    valid = (lab != -100).float()
    half = SEQ // 2
    means = [float(tok[:, p].sum() / valid[:, p].sum())
             for p in (slice(0, half), slice(half, SEQ))]
    whole = float(tok.sum() / valid.sum())
    assert abs(np.mean(means) - whole) > 10 * TOL * abs(whole)
    for rec in recs:
        np.testing.assert_allclose(rec["runs"][0]["losses"][0], whole,
                                   rtol=TOL)


@pytest.mark.parametrize("name", ["sep2", "sep4", "sep2dp2", "sep2mp2"])
def test_sampler_defaults_to_the_dp_axis(runs, name):
    _, jobs = runs
    recs, _, _ = jobs[name]
    dp = CASES[name][0]
    for rec in recs:
        assert rec["sampler"] == [dp, rec["dp_rank"]]


def test_sep_checkpoint_loads_in_jax_and_back(runs):
    """Written once (one shard a region: the mp halves of a split tensor,
    one copy of a replicated one), JAX's names and global shapes, loads
    in JAX's ``load_state_dict`` bit for bit and back at sep 2 x mp 2."""
    jax_runs, jobs = runs
    recs, params, d = jobs["sep2mp2"]
    final = params["ring"][str(STEPS)]
    meta = json.loads((d / "ckpt" / "metadata.json").read_text())
    init = jax_runs[("sep2mp2", "ring")][0]
    specs = LlamaForCausalLM(llama_tiny_config(
        **dict(BASE, **CASES["sep2mp2"][3])), device="cpu").partition_specs()
    for n, v in init.items():
        assert meta[n]["shape"] == list(v.shape), n
        split = specs.get(n) is not None and "mp" in specs[n]
        assert len(meta[n]["shards"]) == (2 if split else 1), n
    tgt = {n: paddle.to_tensor(np.zeros_like(v)) for n, v in init.items()}
    jckpt.load_state_dict(tgt, str(d / "ckpt"))
    for n, v in final.items():
        np.testing.assert_array_equal(np.asarray(tgt[n]._value), v,
                                      err_msg=n)
    for rec in recs:
        assert rec["reload"]["regions_checked"] > 0


def _one_step(**kw):
    torch.manual_seed(0)
    m = LlamaForCausalLM(llama_tiny_config(**BASE, **kw), device="cpu")
    opt = AdamW(learning_rate=LR, weight_decay=WD, parameters=m.parameters())
    step = TrainStep(m, lambda mm, b: mm(*b)[0], opt)
    ids, labels = _batches(1, True)[0]
    loss = step((torch.from_numpy(ids), torch.from_numpy(labels)))
    return float(loss), m, step


@pytest.mark.parametrize("mode", MODES)
def test_sequence_parallel_without_a_group_changes_no_bit(mode):
    a, ma, step = _one_step(sequence_parallel=True,
                            sequence_parallel_mode=mode)
    b, mb, _ = _one_step()
    assert a == b
    for (n, p), (_, q) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(p, q), n
    assert step.eager_reason is None
    for layer in ma.llama.layers:
        layer.self_attn.sep_group = Group([0, 1], gid=98)
    assert "sep process group" in step.eager_reason


@pytest.mark.parametrize("other", ["pp_degree", "sharding_degree"])
def test_init_refuses_sep_beside_pp_or_sharding(other):
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "sep_degree": 2, other: 2}
    with pytest.raises(NotImplementedError, match=r"A\.6 \(e5\)"):
        fleet.init(is_collective=True, strategy=st)


def test_model_checks_for_a_sep_group():
    """``check_sep_degree``: a model that is not sequence-parallel, heads
    Ulysses cannot split, a sliding window under megatron."""
    plain = LlamaForCausalLM(llama_tiny_config(**BASE), device="cpu")
    with pytest.raises(ValueError, match="not sequence-parallel"):
        plain.check_sep_degree(2)
    uly = LlamaForCausalLM(llama_tiny_config(
        **BASE, sequence_parallel=True, sequence_parallel_mode="ulysses"),
        device="cpu")
    uly.check_sep_degree(4)
    with pytest.raises(ValueError, match="not divisible by sep degree"):
        uly.check_sep_degree(4, mp_degree=2)
    win = LlamaForCausalLM(llama_tiny_config(
        **BASE, sequence_parallel=True, sliding_window=4), device="cpu")
    with pytest.raises(NotImplementedError, match=r"A\.6 \(e5\)"):
        win.check_sep_degree(2)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        win.sep_group = Group([0, 1], gid=99)
        win._rope_rows(200)
