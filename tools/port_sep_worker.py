#!/usr/bin/env python3
"""One rank of a sequence-parallel (sep) training job on the port.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --log_dir LOG tools/port_sep_worker.py --out DIR [options]

``fleet.init`` with ``sep_degree=--sep`` and ``mp_degree=--mp`` (dp the
rest of the world), a whole ``LlamaForCausalLM`` with
``sequence_parallel=True`` built from ``--seed`` (or ``--init``, an npz
of the port's state dict), ``fleet.distributed_model`` (the sep group
handed to the attention, the RoPE rows and the loss; split over mp where
mp > 1), AdamW through ``fleet.distributed_optimizer``, and ``--steps``
eager steps of the user's loop, unchanged (``loss = model(ids,
labels)[0]``, ``loss.backward()`` (the sep exchanges and, at its end,
the sum of the gradients over the sep group inside), the dp sync where
dp > 1, ``opt.step()``). ``--modes ring,ulysses,megatron`` runs the job
once a ``sequence_parallel_mode``, in order, each from the same weights.

Data: step k's global batch is ``tools/port_mp_worker.py``'s (rows of
``RandomState(--seed)``'s ids, labels rolled by one over the whole
sequence, ``--seq`` tokens); each rank passes the piece ``[r s/S, (r+1)
s/S)`` of its dp rank's rows, r its sep rank. ``--ignore`` sets labels
to -100 unevenly over the pieces (:func:`ignore_labels`).

``--config headline`` is ``tools/port_train_bench.py``'s
``headline_big_config("full")`` (bf16, bf16 AdamW moments, full
recompute, the stacked trunk) with ``max_position_embeddings`` raised
to ``--seq``; ``--config tiny`` the fp32 ``llama_tiny_config`` with
``--kw``'s fields (JSON).

After every step the ranks of a sep group must hold the same loss and
bit-identical parameters (SHA-256 digests over the job's store).
``--reference`` (sep alone, dp = mp = 1): first, rank 0 runs the same
steps on one rank with the whole model from the same weights on the
unsplit batch, keeping each step's loss and parameters (JAX's layout)
and step 1's gradients on the host; then rank 0 holds each mode's
losses, step 1's gradients (after the sum over the group, before the
update) and each step's parameters to them within ``tol`` (per tensor,
the norm of the difference over the norm; the gradients' norm ratios
are recorded beside it: a sum over sep missed or taken twice, or a loss
whose backward multiplies by S, puts one at 1/S or S, which AdamW's
update, blind to a common scale, would not show in the parameters).
``--train-step`` runs each step as ``jit.TrainStep`` (eager under a sep
group, which it says).

``--save-params``: each rank writes each step's parameters and step 1's
gradients after the sum over sep and the dp mean (this rank's regions
of JAX's global tensors; the gradients not under ``--train-step``) and
the losses to ``<out>/params<rank>_<mode>.npz``. ``--ckpt DIR``: after
the first mode's steps, ``distributed.save_state_dict(convert.jax_state_dict(
model), DIR)`` and each rank's regions with their digests in
``DIR/regions<r>.json``. ``--load DIR`` instead of training: build the
model (taking the sep group, split at ``--mp``), load ``DIR`` into
``jax_state_dict(model)`` and require every saved region's digest.

Each rank writes ``<out>/rank<r>.json``: per mode the losses, each
step's seconds by part (the wait at the barrier that starts every step
on all ranks together; forward and backward, and within them each kind
of sep exchange's calls, bytes and seconds (``sep_ops.sep_stats``: the
ring's hops, the all-to-alls, the gathers and their reduce-scatters, the
loss's all-reduce, the gradients' sum over the group at the end of the
backward); the dp sync; AdamW), launch counts a step against the counts
the mode implies (:func:`expected_launches`), the exchanges against
:func:`expected_exchanges`, peak device memory of the steps and the
memory resting after the last step, the checks. It imports nothing of
JAX.

Tolerances against the one-rank run: fp32 (``--config tiny``) 1e-5 (the
blocks merge the same terms in another order and each gradient is the
sum of S ranks' shares). bf16: the ring and megatron merge each block's
bf16 output in fp32 and round again, and each parameter's gradient is
the fp32 sum of S bf16 shares rounded once where one rank's GEMM rounds
the whole; once one rounding differs every later one on the path
rounds other inputs, as under mp: ``tools/port_mp_worker.py``'s
``LOSS_TOL_BF16`` = 2^-9, ``GRAD_TOL_BF16`` = 5e-2 and
``PARAM_TOL_BF16`` = 9e-3 (their derivation there). A gradient S times
too large or too small is (S - 1) or (1 - 1/S) of its norm away, 0.5 or
more at S = 2, ten times the gradient tolerance."""
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
                                  digest, load_and_check, regions, rel,
                                  tolerances)
from tools.port_pp_worker import _jax_params, my_regions  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", choices=("headline", "tiny"),
                    default="headline")
    ap.add_argument("--kw", default="{}")
    ap.add_argument("--sep", type=int, default=2)
    ap.add_argument("--mp", type=int, default=1)
    ap.add_argument("--modes", default="ring,ulysses,megatron")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--ignore", action="store_true")
    ap.add_argument("--train-step", action="store_true")
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--save-params", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--load", default=None)
    ap.add_argument("--tag", default="run",
                    help="the store keys' prefix (one per run of a job)")
    return ap.parse_args(argv)


def config(args, mode="ring"):
    from paddle_tpu_torch.models import llama_tiny_config
    if args.config == "headline":
        from tools.port_train_bench import headline_big_config
        cfg = headline_big_config("full")
        cfg.max_position_embeddings = max(cfg.max_position_embeddings,
                                          args.seq)
    else:
        cfg = llama_tiny_config(**json.loads(args.kw))
    cfg.tensor_parallel = args.mp > 1 or cfg.tensor_parallel
    cfg.sequence_parallel = True
    cfg.sequence_parallel_mode = mode
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
            model.load_state_dict({k: torch.from_numpy(z[k]) for k in z})
    return model, lambda m: AdamW(learning_rate=LR, weight_decay=WD,
                                  parameters=m.parameters(),
                                  multi_precision=False)


def ignore_labels(lab):
    """-100 over most of row 0's first half (the first piece at sep 2
    holds more of them than the second) and over row 1's last 3 labels,
    in place: the pieces hold unequal counts of valid labels, so a mean
    of the ranks' means differs from the sequence's mean."""
    s = lab.shape[1]
    lab[0, 1:s // 2 + 2] = -100
    if lab.shape[0] > 1:
        lab[1, s - 3:] = -100
    return lab


def data(args, cfg, dp, dp_rank, S, sep_rank, device):
    """Per step (this rank's piece of its dp rank's rows, the dp rank's
    whole rows, the global batch)."""
    out = []
    for mine, glob in batches(args, cfg, dp, dp_rank, device):
        if args.ignore:
            ignore_labels(mine[1])
            for r in range(dp):
                ignore_labels(glob[1][r * args.batch:(r + 1) * args.batch])
        sl = args.seq // S
        piece = tuple(t[:, sep_rank * sl:(sep_rank + 1) * sl].contiguous()
                      for t in mine)
        out.append((piece, mine, glob))
    return out


def _blocks(mode, S, rank) -> int:
    """Flash blocks a layer's attention runs on sep rank ``rank``: the
    causal ring its diagonal and past pieces, megatron its diagonal and
    its prefix, Ulysses one over the whole sequence."""
    return {"ring": rank + 1, "megatron": 1 + (rank > 0),
            "ulysses": 1}[mode]


def expected_launches(cfg, S, rank, n_tensors) -> dict:
    """The kernels one step launches on sep rank ``rank``: a layer runs
    its blocks through its forward, the full recompute's repeat and the
    backward (flash forward 2 a block, dq and dkv 1), RMSNorm 4 a layer
    forward (2 + the repeat's 2) and 2 backward, RoPE 3 (forward,
    repeat, backward); the final norm 1 and 1; AdamW one a parameter
    tensor. Without recompute the repeats drop out."""
    L = cfg.num_hidden_layers
    f = 2 if cfg.recompute else 1
    blk = L * _blocks(cfg.sequence_parallel_mode, S, rank)
    return {"rms_norm": 2 * f * L + 1, "rms_norm_bwd": 2 * L + 1,
            "rope": (f + 1) * L, "flash_attention_fwd": f * blk,
            "flash_attention_bwd_dq": blk, "flash_attention_bwd_dkv": blk,
            "adamw": n_tensors}


def expected_exchanges(cfg, S) -> dict:
    """The sep exchanges of one step by kind (every rank alike): a layer
    runs its forward's, the full recompute's repeat of them and their
    backward (the ring's S - 1 hops, Ulysses' 3 all-to-alls, megatron's
    one gather and, backward, its reduce-scatter); the loss's all-reduce
    and the gradients' sum once."""
    L = cfg.num_hidden_layers
    f = 2 if cfg.recompute else 1
    mode = cfg.sequence_parallel_mode
    out = {"hop": 0, "all_to_all": 0, "all_gather": 0, "reduce_scatter": 0,
           "all_reduce": 1, "grad_sum": 1}
    if mode == "ring":
        out["hop"] = (f + 1) * L * (S - 1)
    elif mode == "ulysses":
        out["all_to_all"] = 3 * (f + 1) * L
    else:
        out["all_gather"] = f * L
        out["reduce_scatter"] = L
    return out


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_reference(args, device, data_steps):
    """Rank 0's one-rank run on the unsplit batch (``sequence_parallel``
    is inert without a group, so one run serves every mode): ``{"losses",
    "grads", "params"}``, step 1's gradients by the port's names and each
    step's parameters in JAX's layout, on the host."""
    import torch
    model, make_opt = build(args, config(args), device)
    opt = make_opt(model)
    out = {"losses": [], "grads": None, "params": []}
    for _, mine, _ in data_steps:
        loss = model(*mine)[0]
        loss.backward()
        if out["grads"] is None:
            out["grads"] = {n: p.grad.detach().to("cpu", copy=True)
                            for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        out["losses"].append(float(loss.detach()))
        out["params"].append(_jax_params(model))
        del loss
    del model, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _hold(model, want: dict, device) -> dict:
    """Per-tensor relative norms of the model's parameters (JAX's layout)
    against ``want``: the largest, its tensor and the median."""
    from paddle_tpu_torch.convert import jax_state_dict
    got = jax_state_dict(model)
    rels = sorted(((rel(got[k].detach(), v.to(device)), k)
                   for k, v in want.items()), reverse=True)
    return {"max": rels[0][0], "worst": rels[0][1],
            "median": rels[len(rels) // 2][0]}


def _hold_grads(model, want: dict, tol: float, device) -> dict:
    """Per-tensor relative norms of the model's gradients against
    ``want`` (the port's names, on the host): the largest, its tensor
    and the median, held to ``tol``, and the range of the norms' ratios
    (module docstring)."""
    rels, ratios = [], []
    for n, p in model.named_parameters():
        g, w = p.grad.float(), want[n].to(device).float()
        rels.append((rel(g, w), n))
        ratios.append(float(g.norm() / w.norm().clamp(min=1e-30)))
        del g, w
    rels.sort(reverse=True)
    return {"max": rels[0][0], "worst": rels[0][1], "tol": tol,
            "median": rels[len(rels) // 2][0], "ratio_min": min(ratios),
            "ratio_max": max(ratios)}


def jax_grads(model) -> dict:
    """``{JAX name: this rank's region of the gradient}`` as fp32 numpy:
    ``convert.jax_state_dict`` read over the gradients (each parameter's
    data swapped for its gradient while it runs)."""
    from paddle_tpu_torch.convert import jax_state_dict
    from paddle_tpu_torch.distributed.sharding import ShardedTensor
    params = list(model.parameters())
    data = [p.data for p in params]
    try:
        for p in params:
            p.data = p.grad
        return {k: (v.local if isinstance(v, ShardedTensor) else v)
                .detach().float().cpu().numpy().copy()
                for k, v in jax_state_dict(model).items()}
    finally:
        for p, d in zip(params, data):
            p.data = d


def check_grads(args, model, ref, tol, device, rec, saved, peak):
    """Step 1's gradients, after the sum over sep and the dp mean:
    against rank 0's one-rank run (``ref``, on rank 0 under
    ``--reference``) and, under ``--save-params``, into ``saved`` (JAX's
    layout, this rank's regions). Out of the steps' peak memory."""
    import numpy as np
    import torch
    if device.type == "cuda":
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated(device))
    if ref is not None:
        rec["grad_check"] = _hold_grads(model, ref["grads"], tol["grad"],
                                        device)
    if args.save_params:
        mine = my_regions(model)
        for k, v in jax_grads(model).items():
            saved[f"grad/{k}"] = v
            saved[f"region/{k}"] = np.array(mine[k][0])
            saved[f"shape/{k}"] = np.array(mine[k][1])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def train(args, mode, device, rank, world, hcg, store, ref, data_steps):
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed import fleet, sep_ops
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients

    cfg = config(args, mode)
    tag = f"{args.tag}/{mode}"
    sep = hcg.get_sep_parallel_group()
    S = hcg.get_sep_parallel_world_size()
    sep_rank = hcg.get_sep_parallel_rank()
    dp_group = hcg.get_data_parallel_group()
    dp = hcg.get_data_parallel_world_size()
    model, make_opt = build(args, cfg, device)
    full_params = sum(p.numel() for p in model.parameters())
    model = fleet.distributed_model(model)
    inner = getattr(model, "_layers", model)
    opt = fleet.distributed_optimizer(make_opt(inner))
    n_tensors = len(list(inner.parameters()))
    tol = tolerances(next(inner.parameters()).dtype)
    train_step = None
    if args.train_step:
        from paddle_tpu_torch.jit import TrainStep
        train_step = TrainStep(model, lambda m, b: m(*b)[0], opt)
    rec = {"mode": mode, "sep": S, "sep_rank": sep_rank, "dp": dp,
           "dp_rank": hcg.get_data_parallel_rank(),
           "mp": hcg.get_model_parallel_world_size(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "layers": cfg.num_hidden_layers, "tokens": args.seq // S,
           "params": full_params,
           "local_params": sum(p.numel() for p in inner.parameters()),
           "param_tensors": n_tensors, "losses": [], "step_s": [],
           "launches": [], "exchanges": [], "reference_checks": [],
           "expected_launches": expected_launches(cfg, S, sep_rank,
                                                  n_tensors),
           "expected_exchanges": expected_exchanges(cfg, S),
           "eager_reason": train_step.eager_reason if train_step else None}
    peak, failed, saved = [0.0], [], {}
    members = sep.ranks if sep is not None else [rank]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step, (piece, _, _) in enumerate(data_steps, 1):
        ops.reset_launch_counts()
        sep_ops.reset_sep_stats()
        C.reset_counters()
        _sync(device)
        tb = time.perf_counter()
        C.barrier()
        t0 = time.perf_counter()
        if train_step is not None:      # forward, backward and update
            loss = train_step(piece)
        else:
            loss = model(*piece)[0]
            loss.backward()
        _sync(device)
        t1 = time.perf_counter()
        ex = sep_ops.sep_stats()
        if dp > 1:
            fused_allreduce_gradients(list(inner.parameters()),
                                      group=dp_group)
        _sync(device)
        t2 = time.perf_counter()
        if step == 1 and train_step is None:
            check_grads(args, inner, ref if rank == 0 else None, tol,
                        device, rec, saved, peak)
        _sync(device)
        t2a = time.perf_counter()
        if train_step is None:
            opt.step()
        _sync(device)
        t3 = time.perf_counter()
        launches = ops.launch_counts()
        opt.clear_grad()
        if device.type == "cuda":
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)
            rec["resting_mem_gb"] = torch.cuda.memory_allocated(device) / 1e9
        lval = float(loss.detach())
        del loss
        agree(store, f"sep/{tag}/loss{step}/{members[0]}", members, rank,
              repr(lval))
        agree(store, f"sep/{tag}/params{step}/{members[0]}", members, rank,
              digest(sorted(inner.named_parameters())))
        if dp > 1:
            t = torch.tensor([lval], dtype=torch.float64)
            C.all_reduce(t, group=dp_group)
            lval = float(t[0]) / dp
        rec["losses"].append(lval)
        rec["launches"].append({k: v for k, v in launches.items() if v})
        rec["exchanges"].append(ex)
        rec["step_s"].append({
            "fwd_bwd": t1 - t0, "dp_sync": t2 - t1, "adamw": t3 - t2a,
            "start_wait": t0 - tb,
            "exchanges": sum(v["seconds"] for k, v in ex.items()
                             if k != "grad_sum"),
            "grad_sum": ex["grad_sum"]["seconds"]})
        if ref is not None and rank == 0:
            rec["reference_checks"].append(
                _hold(inner, ref["params"][step - 1], device))
        if args.save_params:
            from paddle_tpu_torch.convert import jax_state_dict
            from paddle_tpu_torch.distributed.sharding import ShardedTensor
            import numpy as np
            mine = my_regions(inner)
            for k, v in jax_state_dict(inner).items():
                local = v.local if isinstance(v, ShardedTensor) else v
                saved[f"{step}/{k}"] = local.detach().float().cpu() \
                    .numpy().copy()
                saved[f"region/{k}"] = np.array(mine[k][0])
                saved[f"shape/{k}"] = np.array(mine[k][1])
    C.barrier()
    if device.type == "cuda":
        rec["peak_mem_gb"] = peak[0] / 1e9
    for step, got in enumerate(rec["exchanges"], 1):
        calls = {k: v["calls"] for k, v in got.items()}
        if calls != rec["expected_exchanges"]:
            failed.append(f"{tag} step {step}: exchanges {calls}, expected "
                          f"{rec['expected_exchanges']}")
    if ref is not None and rank == 0:
        rec["tol"] = tol
        rec["reference_losses"] = ref["losses"]
        for a, b in zip(rec["losses"], ref["losses"]):
            if not abs(a - b) <= tol["loss"] * abs(b):
                failed.append(f"{tag}: loss {a} vs one rank's {b}")
        c = rec.get("grad_check")
        if c is not None and not c["max"] <= tol["grad"]:
            failed.append(f"{tag} step 1: gradients vs one rank's: {c}")
        for step, c in enumerate(rec["reference_checks"], 1):
            if not c["max"] <= tol["param"]:
                failed.append(f"{tag} step {step}: parameters vs one "
                              f"rank's: {c}")
    if not all(x == x and abs(x) != float("inf") for x in rec["losses"]):
        failed.append(f"{tag}: non-finite loss: {rec['losses']}")
    if saved:
        import numpy as np
        np.savez(os.path.join(args.out, f"params{rank}_{mode}.npz"),
                 losses=np.array(rec["losses"]), **saved)
    if args.ckpt and mode == args.modes.split(",")[0]:
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
    handle = getattr(inner, "_sep_grad_sum", None)
    if handle is not None:
        handle.remove()
    del model, inner, opt, train_step
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
    sep = args.sep if world > 1 else 1
    mp = args.mp if world > 1 else 1
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": -1, "mp_degree": mp,
                         "sep_degree": sep}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    os.makedirs(args.out, exist_ok=True)
    rec = {"rank": rank, "world": world, "backend": env.backend}
    if args.load:
        model, _ = build(args, config(args, args.modes.split(",")[0]),
                         device)
        if world > 1:
            fleet.distributed_model(model)
        rec.update(load_and_check(args, model, rank))
        if device.type == "cuda":
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    else:
        dp, dp_rank = hcg.get_data_parallel_world_size(), \
            hcg.get_data_parallel_rank()
        data_steps = data(args, config(args), dp, dp_rank,
                          hcg.get_sep_parallel_world_size(),
                          hcg.get_sep_parallel_rank(), device)
        store = C._get_store()
        ref = None
        if args.reference:
            if dp > 1 or mp > 1:
                raise ValueError("--reference holds a sep-only job (dp = mp "
                                 "= 1) to one rank")
            if rank == 0:
                t0 = time.perf_counter()
                ref = run_reference(args, device, data_steps)
                rec["reference_s"] = time.perf_counter() - t0
            C.barrier()
        rec["runs"] = [train(args, m, device, rank, world, hcg, store, ref,
                             data_steps) for m in args.modes.split(",")]
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
