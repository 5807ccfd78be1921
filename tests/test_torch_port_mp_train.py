"""Tensor-parallel (mp) training of the port's Llama against the JAX
package, on the CPU.

Port side: ``tools/port_mp_worker.py``'s ``train`` in a gloo job of 2
ranks (mp 2) and one of 4 (dp 2 x mp 2), ``launch_pod`` of the worker
below: ``fleet.init``, ``fleet.distributed_model`` of a whole
``llama_tiny_config(tensor_parallel=True)`` loaded with the JAX model's
weights (``convert.params_from_jax``), AdamW (lr 1e-4, wd 0.01), 3
steps on ``RandomState(0)``'s batches. JAX side: the same model, weights
and batches through JAX's ``TrainStep`` on a 2-device ``mp`` mesh (a
2 x 2 ``dp`` x ``mp`` one for the 4-rank job), parameters placed by
their partition specs. Held in fp32:

- each step's loss within 1e-5 relative of JAX's and of one port rank
  (the worker's reference run on rank 0), and each step's parameters,
  gathered over the mp group, within 1e-5 (norm of the difference over
  the norm, per tensor) of both; step 1's gradients of one port rank
  the same; all eight combinations of trunk (layers or the stacked trunk
  with recompute), attention (MHA or GQA with 2 kv heads, one a rank)
  and head (the vocab-parallel fused head or the unfused one, tied
  once);
- the replicated parameters (the norms) bit-identical across ranks after
  every step, and each mp slice across its dp group;
- the vocab-parallel fused head against JAX's
  ``parallel_fused_linear_cross_entropy`` (loss, dh, dw) with labels in
  both slices and ignored ones;
- the mp checkpoint (``save_state_dict(convert.jax_state_dict(model))``)
  loads in JAX's ``load_state_dict`` with JAX's global shapes, at one
  port rank, and back at mp 2, bit for bit;
- ``tensor_parallel=True`` with no mp group leaves a one-rank step's
  bits as ``tensor_parallel=False`` gives them; a degree that splits no
  head evenly is refused; ``TrainStep`` runs an mp-split model eagerly
  and says why; the cache path refuses a training split."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import optimizer as joptimizer
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_current_mesh)
from paddle_tpu.distributed.sharding_utils import place_model, shard_batch
from paddle_tpu.incubate.nn.fused_ce import \
    parallel_fused_linear_cross_entropy as jax_pfce
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch.convert import jax_state_dict, params_from_jax
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.communication import Group
from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.optimizer import AdamW

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
LR, WD = 1e-4, 0.01             # tools/port_mp_worker.py's
STEPS, BATCH, SEQ = 3, 2, 16
# every combination of trunk (layers, or the stacked trunk with full
# recompute), attention (MHA, or GQA at 2 kv heads: one a rank) and head
# (the vocab-parallel fused head, or the unfused one); one of them tied
_TRUNKS = {"layers": {}, "stacked": {"scan_layers": True, "recompute": True}}
_ATTN = {"mha": {}, "gqa": {"num_key_value_heads": 2}}
_HEADS = {"fused": {}, "unfused": {"fused_head_ce": False}}
CASES = {f"{t}_{a}_{h}": {**tk, **ak, **hk}
         for t, tk in _TRUNKS.items() for a, ak in _ATTN.items()
         for h, hk in _HEADS.items()}
CASES["stacked_mha_unfused"]["tie_word_embeddings"] = True
DP_CASE = "stacked_gqa_fused"
CKPT_CASE = "layers_mha_fused"
PFCE = dict(n=12, d=16, v=64, chunks=4)

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import tools.port_mp_worker as W
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.incubate.nn import parallel_fused_linear_cross_entropy

out, mp = sys.argv[1], int(sys.argv[2])
with open(os.path.join(out, "cases.json")) as f:
    cases = json.load(f)
dist.init_parallel_env(device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": -1, "mp_degree": mp}
fleet.init(is_collective=True, strategy=st)
hcg = fleet.get_hybrid_communicate_group()
store = C._get_store()
cpu = torch.device("cpu")
for name, c in cases.items():
    d = os.path.join(out, name)
    os.makedirs(d, exist_ok=True)
    argv = ["--out", d, "--config", "tiny", "--kw", json.dumps(c["kw"]),
            "--device", "cpu", "--batch", sys.argv[3], "--seq", sys.argv[4],
            "--steps", sys.argv[5], "--mp", str(mp), "--tag", name]
    run = argv + ["--init", os.path.join(out, c["init"]), "--reference",
                  "--save-params"]
    if c["ckpt"]:
        run += ["--ckpt", os.path.join(d, "ckpt")]
    args = W.parse(run)
    rec = W.train(args, W.config(args), cpu, rank, world, hcg, store)
    if c["ckpt"]:
        C.barrier()
        args = W.parse(argv + ["--seed", "9", "--load",
                               os.path.join(d, "ckpt")])
        model, _ = W.build(args, W.config(args), cpu)
        fleet.distributed_model(model)
        rec["reload"] = W.load_and_check(args, model, rank)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
if world == mp:
    z = np.load(os.path.join(out, "pfce.npz"))
    h = torch.tensor(z["h"], requires_grad=True)
    rows = z["w"].shape[0] // mp
    w = torch.tensor(z["w"][rank * rows:(rank + 1) * rows],
                     requires_grad=True)
    loss = parallel_fused_linear_cross_entropy(
        h, w, torch.from_numpy(z["labels"]), hcg.get_model_parallel_group(),
        num_chunks=int(z["chunks"]))
    loss.backward()
    np.savez(os.path.join(out, f"pfce{rank}.npz"), loss=loss.detach().numpy(),
             dh=h.grad.numpy(), dw=w.grad.numpy())
C.barrier()
C.destroy_process_group()
'''


def _batches(dp, vocab=512):
    """The worker's batches: step k's global rows of RandomState(0)."""
    n = dp * BATCH * STEPS
    ids = np.random.RandomState(0).randint(0, vocab, (n, SEQ)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    g = dp * BATCH
    return [(ids[k * g:(k + 1) * g], labels[k * g:(k + 1) * g])
            for k in range(STEPS)]


def _jax_named(jm):
    return {n: np.asarray(p._value) for n, p in jm.named_parameters()}


def _jax_run(kw, dp, mp):
    """JAX's model on a dp x mp mesh: (initial weights, losses, each
    step's parameters), weights in JAX's layout."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=True, **kw))
    init = _jax_named(jm)
    hcg = HybridCommunicateGroup(dp_degree=dp, mp_degree=mp,
                                 devices=jax.devices()[:dp * mp])
    mesh = hcg.jax_mesh
    place_model(jm, mesh)
    opt = joptimizer.AdamW(learning_rate=LR, weight_decay=WD,
                           parameters=jm.parameters())
    step = JaxTrainStep(jm, lambda m, b: m(*b)[0], opt)
    losses, params = [], []
    for ids, labels in _batches(dp):
        batch = tuple(shard_batch(mesh, paddle.to_tensor(a), P("dp"))
                      for a in (ids, labels))
        losses.append(float(np.asarray(step(batch)._value)))
        params.append(_jax_named(jm))
    set_current_mesh(None)
    from paddle_tpu.distributed import mesh as jmesh
    jmesh._HCG = None
    return init, losses, params


def _launch(tmp, world, mp, cases):
    script = tmp / "worker.py"
    script.write_text(WORKER)
    (tmp / "cases.json").write_text(json.dumps(cases))
    cfg = LaunchConfig(str(script), [str(tmp), str(mp), str(BATCH),
                                     str(SEQ), str(STEPS)],
                       nproc_per_node=world, log_dir=str(tmp / "log"),
                       envs={"OMP_NUM_THREADS": "1",
                             "PYTHONPATH": REPO + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:] for p in (tmp / "log").iterdir()}
    assert rc == 0, logs


def _pfce_inputs():
    rs = np.random.RandomState(5)
    labels = rs.randint(0, PFCE["v"], (PFCE["n"],)).astype(np.int32)
    labels[:3] = [3, 40, -100]
    return {"h": rs.randn(PFCE["n"], PFCE["d"]).astype(np.float32),
            "w": (rs.randn(PFCE["v"], PFCE["d"]) * 0.5).astype(np.float32),
            "labels": labels, "chunks": np.int32(PFCE["chunks"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both port jobs and the JAX runs they are held to."""
    jax_runs, cases2, cases4 = {}, {}, {}
    root = tmp_path_factory.mktemp("mp_train")
    for name, kw in CASES.items():
        jax_runs[name] = _jax_run(kw, 1, 2)
        init = f"{name}_init.npz"
        np.savez(root / init, **{k: v.numpy() for k, v in params_from_jax(
            jax_runs[name][0]).items()})
        cases2[name] = {"kw": kw, "init": f"../{init}",
                        "ckpt": name == CKPT_CASE}
    jax_runs["dp2"] = _jax_run(CASES[DP_CASE], 2, 2)
    cases4["dp2"] = dict(cases2[DP_CASE], ckpt=False)
    np.savez(root / "pfce.npz", **_pfce_inputs())
    jobs = {}
    for tag, world, mp, cases in (("mp2", 2, 2, cases2),
                                  ("dp2mp2", 4, 2, cases4)):
        tmp = root / tag
        tmp.mkdir()
        for c in cases.values():
            c["init"] = str(root / c["init"].lstrip("./"))
        if tag == "mp2":
            (tmp / "pfce.npz").write_bytes((root / "pfce.npz").read_bytes())
        _launch(tmp, world, mp, cases)
        for name in cases:
            recs = [json.loads((tmp / name / f"rank{r}.json").read_text())
                    for r in range(world)]
            jobs[name] = (
                recs, dict(np.load(tmp / name / "params.npz")), tmp / name)
    return jax_runs, jobs, root


def _relnorm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(CASES) + ["dp2"])
def test_mp_steps_match_jax_and_one_rank(runs, name):
    jax_runs, jobs, _ = runs
    _, jlosses, jparams = jax_runs[name]
    recs, params, _ = jobs[name]
    np.testing.assert_allclose(recs[0]["losses"], jlosses, rtol=TOL)
    for rec in recs:
        np.testing.assert_allclose(rec["losses"], recs[0]["losses"],
                                   rtol=0, atol=0)
    ref = recs[0]
    assert all(rec["failed"] == [] for rec in recs)
    assert ref["grad_check"]["max"] <= TOL
    assert all(c["rel"] <= TOL for c in ref["loss_check"])
    assert all(c["max"] <= TOL for c in ref["param_check"])
    assert len(ref["param_check"]) == STEPS
    for step in range(1, STEPS + 1):
        want = params_from_jax(jparams[step - 1])
        for n, w in want.items():
            assert _relnorm(params[f"{step}/{n}"], w.numpy()) <= TOL, \
                (name, step, n)


@pytest.mark.parametrize("name", list(CASES) + ["dp2"])
def test_replicated_parameters_bit_identical_across_ranks(runs, name):
    _, jobs, _ = runs
    recs, _, _ = jobs[name]
    for rec in recs[1:]:
        assert rec["replicated_digests"] == recs[0]["replicated_digests"]
    by_mp = {}
    for rec in recs:
        by_mp.setdefault(rec["mp_rank"], []).append(rec["slice_digests"])
    for digests in by_mp.values():
        assert all(d == digests[0] for d in digests)
    assert recs[0]["slice_digests"] != recs[1]["slice_digests"]


def test_split_shapes_and_collective_counts(runs):
    """Each rank holds half of every split tensor; a step runs 2 mp
    all-reduces a layer forward, 2 behind c_identity backward, 1 for the
    embedding and 3 + 1 for the fused head (4L + 5); with full recompute
    the backward repeats each layer's first all-reduce only (torch's
    checkpoint stops its recompute at the last saved tensor it needs),
    5L + 5; the unfused head gathers its logits and runs the vocab-
    parallel cross-entropy's 3 all-reduces and c_identity's 1."""
    _, jobs, _ = runs
    L = llama_tiny_config().num_hidden_layers
    for name in CASES:
        count = (5 if name.startswith("stacked") else 4) * L \
            + (6 if name.endswith("unfused") else 5)
        recs, _, _ = jobs[name]
        for rec in recs:
            assert all(s["mp_collectives"] == count for s in rec["step_s"])
            assert rec["local_params"] < rec["params"]
    recs, _, _ = jobs["layers_gqa_unfused"]
    assert recs[0]["split"]["llama.layers.0.self_attn.k_proj.weight"] == \
        [64, 128]


def test_vocab_parallel_fused_head_matches_jax(runs):
    _, _, root = runs
    z = _pfce_inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("mp",))
    lab = jax.numpy.asarray(z["labels"])
    loss, (dh, dw) = jax.value_and_grad(
        lambda h, w: jax_pfce(h, w, lab, mesh=mesh, axis="mp",
                              num_chunks=PFCE["chunks"]), argnums=(0, 1))(
        jax.numpy.asarray(z["h"]), jax.numpy.asarray(z["w"]))
    rows = PFCE["v"] // 2
    for r in range(2):
        got = np.load(root / "mp2" / f"pfce{r}.npz")
        np.testing.assert_allclose(got["loss"], np.asarray(loss), rtol=TOL)
        np.testing.assert_allclose(got["dh"], np.asarray(dh), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["dw"], np.asarray(dw)[
            r * rows:(r + 1) * rows], rtol=TOL, atol=TOL)


def test_mp_checkpoint_loads_in_jax_one_rank_and_mp2(runs):
    jax_runs, jobs, _ = runs
    recs, params, d = jobs[CKPT_CASE]
    path = str(d / "ckpt")
    final = {k.split("/", 1)[1]: v for k, v in params.items()
             if k.startswith(f"{STEPS}/")}
    meta = json.loads((d / "ckpt" / "metadata.json").read_text())
    init = jax_runs[CKPT_CASE][0]
    for n, v in init.items():                # JAX's names and shapes
        assert meta[n]["shape"] == list(v.shape), n
    tgt = {n: paddle.to_tensor(np.zeros_like(v)) for n, v in init.items()}
    jckpt.load_state_dict(tgt, path)
    port = params_from_jax({n: np.asarray(t._value) for n, t in tgt.items()})
    for n, v in final.items():
        np.testing.assert_array_equal(port[n].numpy(), v, err_msg=n)
    one = LlamaForCausalLM(llama_tiny_config(**CASES[CKPT_CASE]),
                           device="cpu", seed=9)
    ckpt.load_state_dict(jax_state_dict(one), path)
    for n, p in one.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), final[n],
                                      err_msg=n)
    for rec in recs:
        assert rec["reload"]["regions_checked"] > 0


def _one_step(tensor_parallel):
    torch.manual_seed(0)
    m = LlamaForCausalLM(llama_tiny_config(tensor_parallel=tensor_parallel),
                         device="cpu")
    opt = AdamW(learning_rate=LR, weight_decay=WD, parameters=m.parameters())
    step = TrainStep(m, lambda mm, b: mm(*b)[0], opt)
    ids, labels = _batches(1)[0]
    loss = step((torch.from_numpy(ids), torch.from_numpy(labels)))
    return float(loss), {n: p.detach().clone()
                         for n, p in m.named_parameters()}


def test_tensor_parallel_without_a_group_changes_no_bit():
    a, pa = _one_step(True)
    b, pb = _one_step(False)
    assert a == b
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n


def test_degree_refusals_and_eager_train_step():
    m = LlamaForCausalLM(llama_tiny_config(num_key_value_heads=2),
                         device="cpu")
    m.check_mp_degree(2)
    with pytest.raises(ValueError, match="num_key_value_heads=2"):
        m.check_mp_degree(4)
    with pytest.raises(ValueError, match="num_attention_heads=4"):
        m.check_mp_degree(3)
    step = TrainStep(m, lambda mm, b: mm(*b)[0],
                     AdamW(learning_rate=LR, parameters=m.parameters()))
    assert step.eager_reason is None
    m.llama.layers[0].mp_group = Group([0, 1], gid=99)
    assert "runs eagerly" in step.eager_reason
    m.mp_group = m.llama.layers[0].mp_group      # a training split
    ids = torch.zeros(1, 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="tp="):
        m(ids, cache=m.init_kv_cache(1, 8), pos=0)
