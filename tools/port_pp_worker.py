#!/usr/bin/env python3
"""One rank of a pipeline-parallel (pp) training job on the port.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --log_dir LOG tools/port_pp_worker.py --out DIR [options]

``fleet.init`` with ``pp_degree=--pp`` and ``mp_degree=--mp`` (dp the
rest of the world), a whole ``LlamaForCausalLM`` with
``pipeline_parallel=True`` built from ``--seed`` (or ``--init``, an npz
of the port's state dict), ``fleet.distributed_model`` (each rank keeps
its stage's rows, split over mp inside them), AdamW through
``fleet.distributed_optimizer``, and ``--steps`` eager steps: the
user's loop, unchanged (``loss = model(ids, labels)[0]``,
``loss.backward()``, the dp sync where dp > 1, ``opt.step()``); the
schedule runs inside the forward and the backward
(``distributed.pipeline``). The ranks of one dp coordinate take the
same batch (``tools/port_mp_worker.py``'s ``batches``: step k's rows of
``RandomState(--seed)``'s ids, labels rolled by one; ``--ignore`` sets
some labels to -100, unevenly across the microbatches).

``--train-step`` runs each step as ``jit.TrainStep`` (eager under a pp
group, which it says; the step's seconds are then one part).
``--vpp 1,2`` runs the job once a ``virtual_pp`` value, in order, each
from the same weights (the (V, L/V, ...) storage holds them in the same
order). ``--pp 1 --microbatched`` runs the schedule's microbatches on
each rank without a pp group: the run a pp x dp or pp x mp job is held
to bit for bit.

``--config headline`` is ``tools/port_train_bench.py``'s
``headline_big_config("full")`` with ``pipeline_parallel=True``,
``pp_num_microbatches=--micro`` (bf16, bf16 AdamW moments, full
recompute; ``--layers`` cuts the depth); ``--config tiny`` the fp32
``llama_tiny_config`` with ``--kw``'s fields (JSON).

After every step each rank puts on the job's store the SHA-256 of every
parameter it holds, as the region of JAX's global tensor that
``convert.jax_state_dict`` gives it. ``--reference`` (pp alone, dp = mp
= 1): first, rank 0 runs the same steps on one rank with the whole model
from the same weights twice: with the schedule's microbatches in the
same order (``one_rank_schedule``), keeping each step's parameters in
JAX's layout on the host, and on the whole batch (JAX's S = 1
semantics). Then it holds every region that every rank published to
the first run's bits, and the first run's losses and parameters to the
whole-batch run's within ``tol`` (the stages equal the first run bit for
bit, so their distance from the whole-batch run is the first run's).

``--save-params``: each rank writes each step's regions and losses to
``<out>/params<rank>_v<V>.npz`` (with ``--reference``, rank 0 also the
microbatched run's whole parameters, ``reference.npz``). ``--ckpt
DIR``: after the first ``--vpp`` value's steps,
``distributed.save_state_dict(convert.jax_state_dict(model), DIR)``
(JAX's layout and global shapes) and each rank's regions with their
digests in ``DIR/regions<r>.json``. ``--load DIR`` instead of training:
build the model (split at ``--pp``, whole at one rank), load ``DIR``
into ``jax_state_dict(model)`` and require every saved region's digest
(``tools/port_mp_worker.py``'s ``load_and_check``).

Each rank writes ``<out>/rank<r>.json``: per ``virtual_pp`` value the
losses, each step's seconds by part (the wait at the barrier that
starts every step on all ranks together; forward and backward; within
them the seconds waiting on the hops (receives, and sends not yet
taken), the loss broadcast and the shared-weight all-reduce, each less
its staging copies (``pipeline.pipeline_stats``); the dp sync; AdamW),
its sends and receives and
their bytes and route, launch counts a step against the counts the
schedule implies (``expected_launches``), peak device memory of the
steps and the memory resting after the last step; the checks. It
imports nothing of JAX.

Tolerances against the whole-batch run. fp32 (``--config tiny``): 1e-5
(the microbatched products sum the same terms per row; only the
parameters' gradients add M microbatch sums). bf16: the products of a
microbatch (2048 rows) and of the batch (8192) may take other cuBLAS
kernels, whose sums round otherwise, and each parameter's gradient is
the bf16 sum of M = 4 microbatch gradients where the batch's GEMM
rounds once: 3 more roundings of u = 2^-8 at every weight gradient, and
once the first product differs every later bf16 rounding on the path
rounds other inputs, as under mp. The gradients then differ like mp's
(3.6e-2); AdamW's first steps move each parameter by about lr sign(g),
so the parameters differ where a sign flips: ``port_mp_worker``'s
``PARAM_TOL_BF16`` = 9e-3 (its derivation) and ``LOSS_TOL_BF16`` =
2^-9, both under phase 16's 5e-2."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):      # run as a script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tools.port_mp_worker import (LR, WD, agree, batches,  # noqa: E402
                                  load_and_check, rel, regions, sha,
                                  tolerances)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", choices=("headline", "tiny"),
                    default="headline")
    ap.add_argument("--kw", default="{}")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--vpp", default="1")
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--ignore", action="store_true")
    ap.add_argument("--microbatched", action="store_true")
    ap.add_argument("--train-step", action="store_true")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--save-params", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--load", default=None)
    ap.add_argument("--tag", default="run",
                    help="the store keys' prefix (one per run of a job)")
    return ap.parse_args(argv)


def config(args, vpp=1):
    from paddle_tpu_torch.models import llama_tiny_config
    if args.config == "headline":
        from tools.port_train_bench import headline_big_config
        cfg = headline_big_config("full")
    else:
        cfg = llama_tiny_config(**json.loads(args.kw))
    cfg.tensor_parallel = args.mp > 1 or cfg.tensor_parallel
    cfg.pipeline_parallel = True
    cfg.pp_num_microbatches = args.micro
    if args.layers:
        cfg.num_hidden_layers = args.layers
    cfg.virtual_pp = vpp
    cfg.__post_init__()
    return cfg


def build(args, cfg, device):
    """The whole model from ``--seed`` (or ``--init``) and its AdamW."""
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(cfg, device=device, seed=args.seed)
    if args.init:
        import numpy as np
        with np.load(args.init) as z:
            sd = {k: torch.from_numpy(z[k]) for k in z}
        for n, p in model.named_parameters():     # the (V, L/V) storage
            sd[n] = sd[n].reshape(p.shape)
        model.load_state_dict(sd)
    return model, lambda m: AdamW(learning_rate=LR, weight_decay=WD,
                                  parameters=m.parameters(),
                                  multi_precision=False)


def data(args, cfg, dp, dp_rank, device):
    out = batches(args, cfg, dp, dp_rank, device)
    if not args.ignore:
        return out
    # -100 in a few rows' spans: the microbatches hold unequal counts of
    # valid labels, so a mean of microbatch means differs from the
    # batch's mean
    for mine, glob in out:
        for lab in (mine[1], glob[1]):
            lab[0, : lab.shape[1] // 2] = -100
            if lab.shape[0] > 2:
                lab[2, 1:4] = -100
    return out


def expected_launches(cfg, S, stage, n_tensors) -> dict:
    """The kernels a stage launches in one step: each of its L/S layers
    runs every microbatch (M of them) through its forward, the full
    recompute's repeat and the backward: RMSNorm 4 a layer forward (2 +
    the repeat's 2), 2 backward; RoPE 3 (forward, repeat, backward);
    flash forward 2, dq and dkv 1. The last stage adds the final norm on
    the merged batch (1 forward, 1 backward). AdamW: one a parameter
    tensor the stage holds (each stack counts one)."""
    lm = cfg.num_hidden_layers // S * cfg.pp_num_microbatches
    last = 1 if stage == S - 1 else 0
    return {"rms_norm": 4 * lm + last, "rms_norm_bwd": 2 * lm + last,
            "rope": 3 * lm, "flash_attention_fwd": 2 * lm,
            "flash_attention_bwd_dq": lm, "flash_attention_bwd_dkv": lm,
            "adamw": n_tensors}


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _jax_params(model) -> dict:
    """The whole model's parameters in JAX's layout, on the host."""
    from paddle_tpu_torch.convert import jax_state_dict
    return {k: v.detach().to("cpu", copy=True)
            for k, v in jax_state_dict(model).items()}


def run_reference(args, device, dp_batches):
    """Rank 0's one-rank runs of the steps (module docstring): per step
    the microbatched run's loss and JAX-layout parameters, then the
    whole-batch run's losses and the per-tensor relative norms between
    the two runs' parameters."""
    import torch
    out = {"losses": [], "params": [], "whole_losses": [], "param_rel": []}
    cfg = config(args, 1)
    for one_rank in (True, False):
        model, make_opt = build(args, cfg, device)
        model.llama.layers.one_rank_schedule = one_rank
        opt = make_opt(model)
        for step, (_, glob) in enumerate(dp_batches):
            loss = model(*glob)[0]
            loss.backward()
            opt.step()
            opt.clear_grad()
            params = _jax_params(model)
            if one_rank:
                out["losses"].append(float(loss.detach()))
                out["params"].append(params)
            else:
                out["whole_losses"].append(float(loss.detach()))
                want = out["params"][step]
                rels = sorted(((rel(want[k], v), k)
                               for k, v in params.items()), reverse=True)
                out["param_rel"].append(
                    {"max": rels[0][0], "worst": rels[0][1],
                     "median": rels[len(rels) // 2][0]})
            del loss
        del model, opt
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def my_regions(model) -> dict:
    """``{JAX name: [region, global shape, sha]}`` of every parameter
    this rank holds."""
    from paddle_tpu_torch.convert import jax_state_dict
    from paddle_tpu_torch.distributed.sharding import ShardedTensor
    out = {}
    for k, v in jax_state_dict(model).items():
        if isinstance(v, ShardedTensor):
            out[k] = [v.region, list(v.shape), sha(v.local)]
        else:
            out[k] = [[[0, d] for d in v.shape], list(v.shape), sha(v)]
    return out


def hold_to_reference(store, tag, world, step, ref_params, failed) -> dict:
    """Rank 0: every rank's published regions of ``step`` against the
    microbatched reference's bits (module docstring)."""
    checked, bad = 0, []
    for r in range(world):
        got = json.loads(store.get(f"pp/{tag}/regions{step}/{r}"))
        for k, (region, shape, digest) in got.items():
            full = ref_params[k].reshape(shape)
            piece = full[tuple(slice(a, b) for a, b in region)]
            checked += 1
            if sha(piece) != digest:
                bad.append(f"rank {r} {k} {region}")
    if bad or not checked:
        failed.append(f"{tag} step {step}: regions differ from the one-rank"
                      f" microbatched run: {bad[:8]} ({checked} checked)")
    return {"checked": checked, "differ": len(bad)}


def train(args, vpp, device, rank, world, hcg, store, ref, data_steps):
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import pipeline as pl
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients

    cfg = config(args, vpp)
    tag = f"{args.tag}/v{vpp}"
    pp = hcg.get_pipe_parallel_group()
    dp_group = hcg.get_data_parallel_group()
    dp = hcg.get_data_parallel_world_size()
    S = hcg.get_pipe_parallel_world_size()
    stage = hcg.get_stage_id()
    model, make_opt = build(args, cfg, device)
    full_params = sum(p.numel() for p in model.parameters())
    if args.microbatched:
        model.llama.layers.one_rank_schedule = True
    model = fleet.distributed_model(model)
    inner = getattr(model, "_layers", model)
    opt = fleet.distributed_optimizer(make_opt(inner))
    n_tensors = len(list(inner.parameters()))
    train_step = None
    if args.train_step:
        from paddle_tpu_torch.jit import TrainStep
        train_step = TrainStep(model, lambda m, b: m(*b)[0], opt)
    rec = {"vpp": vpp, "stage": stage, "pp": S, "dp": dp,
           "mp": hcg.get_model_parallel_world_size(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "dp_rank": hcg.get_data_parallel_rank(),
           "layers": cfg.num_hidden_layers, "micro": cfg.pp_num_microbatches,
           "params": full_params,
           "local_params": sum(p.numel() for p in inner.parameters()),
           "param_tensors": n_tensors, "losses": [], "step_s": [],
           "launches": [], "p2p": [], "reference_checks": [],
           "expected_launches": expected_launches(cfg, S, stage, n_tensors),
           "eager_reason": train_step.eager_reason if train_step else None}
    peak, failed, saved = [0.0], [], {}

    def training_peak():
        if device.type == "cuda":
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step, (mine, _) in enumerate(data_steps, 1):
        ops.reset_launch_counts()
        pl.reset_pipeline_stats()
        C.reset_counters()
        _sync(device)
        # the ranks start each step together, so that no step's waits
        # hold the other ranks' work between steps (the loss agreement,
        # the region digests); the seconds this rank waited for them
        tb = time.perf_counter()
        C.barrier()
        t0 = time.perf_counter()
        if train_step is not None:      # forward, backward and update
            loss = train_step(mine)
        else:
            loss = model(*mine)[0]
            loss.backward()
        _sync(device)
        t1 = time.perf_counter()
        hops = pl.pipeline_stats()
        routes = C.route_counts()
        staged = C.stage_stats()
        if dp > 1:
            fused_allreduce_gradients(list(inner.parameters()),
                                      group=dp_group)
        _sync(device)
        t2 = time.perf_counter()
        if train_step is None:
            opt.step()
        _sync(device)
        t3 = time.perf_counter()
        launches = ops.launch_counts()
        opt.clear_grad()
        training_peak()
        if device.type == "cuda":
            rec["resting_mem_gb"] = torch.cuda.memory_allocated(device) / 1e9
        lval = float(loss.detach())
        if dp > 1:
            t = torch.tensor([lval], dtype=torch.float64)
            C.all_reduce(t, group=dp_group)
            lval = float(t[0]) / dp
        del loss
        rec["losses"].append(lval)
        rec["launches"].append({k: v for k, v in launches.items() if v})
        wait = hops["recv_wait_s"] + hops["send_wait_s"]
        other = hops["broadcast_s"] + hops["shared_s"]
        rec["step_s"].append({
            "fwd_bwd": t1 - t0, "p2p_wait": wait,
            "recv_wait": hops["recv_wait_s"],
            "broadcast": hops["broadcast_s"], "shared": hops["shared_s"],
            "compute": t1 - t0 - wait - other, "dp_sync": t2 - t1,
            "adamw": t3 - t2, "start_wait": t0 - tb})
        rec["p2p"].append({
            "sends": hops["sends"], "recvs": hops["recvs"],
            "bytes_sent": hops["bytes_sent"],
            "bytes_received": hops["bytes_received"],
            "routes": {op: routes.get(op, {}) for op in ("send", "recv")},
            "staged_calls": staged["calls"], "staged_bytes": staged["bytes"]})
        agree(store, f"{tag}/loss{step}", list(range(world)), rank,
              repr(lval))
        mine_regions = my_regions(inner)
        store.set(f"pp/{tag}/regions{step}/{rank}", json.dumps(mine_regions))
        if args.save_params:
            from paddle_tpu_torch.convert import jax_state_dict
            from paddle_tpu_torch.distributed.sharding import ShardedTensor
            for k, v in jax_state_dict(inner).items():
                local = v.local if isinstance(v, ShardedTensor) else v
                saved[f"{step}/{k}"] = local.detach().float().cpu() \
                    .numpy().copy()
                saved[f"region/{k}"] = __import__("numpy").array(
                    mine_regions[k][0])
                saved[f"shape/{k}"] = __import__("numpy").array(
                    mine_regions[k][1])
    C.barrier()
    if ref is not None:         # after the steps: they time no check
        for step in range(1, len(data_steps) + 1):
            rec["reference_checks"].append(hold_to_reference(
                store, tag, world, step, ref["params"][step - 1], failed))
    if device.type == "cuda":
        rec["peak_mem_gb"] = peak[0] / 1e9
    if ref is not None:
        tol = tolerances(next(inner.parameters()).dtype)
        rec["tol"] = tol
        rec["reference_losses"] = ref["losses"]
        rec["whole_losses"] = ref["whole_losses"]
        rec["param_rel"] = ref["param_rel"]
        if rec["losses"] != ref["losses"]:
            failed.append(f"{tag}: losses {rec['losses']} differ from the "
                          f"one-rank microbatched run's {ref['losses']}")
        for a, b in zip(ref["losses"], ref["whole_losses"]):
            if abs(a - b) > tol["loss"] * abs(b):
                failed.append(f"{tag}: loss {a} vs the whole batch's {b}")
        for step, c in enumerate(ref["param_rel"], 1):
            if c["max"] > tol["param"]:
                failed.append(f"{tag} step {step}: parameters vs the whole "
                              f"batch's: {c}")
    if not all(x == x and abs(x) != float("inf") for x in rec["losses"]):
        failed.append(f"{tag}: non-finite loss: {rec['losses']}")
    if saved:
        import numpy as np
        np.savez(os.path.join(args.out, f"params{rank}_v{vpp}.npz"),
                 losses=np.array(rec["losses"]), **saved)
    if args.ckpt and vpp == int(args.vpp.split(",")[0]):
        from paddle_tpu_torch.convert import jax_state_dict
        from paddle_tpu_torch.distributed import checkpoint as ck
        from paddle_tpu_torch.distributed.checkpoint import atomic_json_dump
        sd = jax_state_dict(inner)
        t0 = time.perf_counter()
        ck.save_state_dict(sd, args.ckpt)
        rec["save_s"] = time.perf_counter() - t0
        rec["saved_regions"] = len(regions(sd, rank))
        atomic_json_dump(os.path.join(args.ckpt, f"regions{rank}.json"),
                         regions(sd, rank))
    rec["failed"] = failed
    del model, inner, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from paddle_tpu_torch.distributed import (fleet, get_rank,
                                              get_world_size,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.checkpoint import atomic_json_dump

    t_start = time.perf_counter()
    env = init_parallel_env(device=args.device)
    device = env.device
    rank, world = get_rank(), get_world_size()
    pp = args.pp if world > 1 else 1
    mp = args.mp if world > 1 else 1
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": -1, "mp_degree": mp,
                         "pp_degree": pp}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    os.makedirs(args.out, exist_ok=True)
    rec = {"rank": rank, "world": world, "backend": env.backend}
    if args.load:
        cfg = config(args, int(args.vpp.split(",")[0]))
        model, _ = build(args, cfg, device)
        if pp > 1 or mp > 1:
            fleet.distributed_model(model)
        rec.update(load_and_check(args, model, rank))
        if device.type == "cuda":
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    else:
        dp, dp_rank = hcg.get_data_parallel_world_size(), \
            hcg.get_data_parallel_rank()
        data_steps = data(args, config(args), dp, dp_rank, device)
        store = C._get_store()
        ref = None
        if args.reference:
            if dp > 1 or mp > 1:
                raise ValueError("--reference holds a pp-only job (dp = mp "
                                 "= 1) to one rank")
            if rank == 0:
                t0 = time.perf_counter()
                ref = run_reference(args, device, data_steps)
                rec["reference_s"] = time.perf_counter() - t0
                if args.save_params:
                    import numpy as np
                    np.savez(os.path.join(args.out, "reference.npz"), **{
                        f"{s}/{k}": v.float().numpy()
                        for s, ps in enumerate(ref["params"], 1)
                        for k, v in ps.items()},
                        losses=np.array(ref["losses"]))
            C.barrier()
        rec["runs"] = [train(args, int(v), device, rank, world, hcg, store,
                             ref, data_steps)
                       for v in args.vpp.split(",")]
        rec["failed"] = [f for r in rec["runs"] for f in r["failed"]]
    rec["seconds"] = time.perf_counter() - t_start
    atomic_json_dump(os.path.join(args.out, f"rank{rank}.json"), rec)
    if rec.get("failed"):
        raise AssertionError(f"rank {rank}: " + "; ".join(rec["failed"]))
    C.barrier()
    C.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
