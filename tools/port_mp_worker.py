#!/usr/bin/env python3
"""One rank of a tensor-parallel (mp) training job on the port.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --log_dir LOG tools/port_mp_worker.py --out DIR [options]

``fleet.init`` with ``mp_degree=--mp`` (dp the rest of the world), a
whole ``LlamaForCausalLM`` built from ``--seed`` (or ``--init``, an npz
of the port's state dict), ``fleet.distributed_model`` (each rank keeps
its mp slice), AdamW through ``fleet.distributed_optimizer``, and
``--steps`` eager steps: forward and backward (the mp collectives inside,
``distributed.fleet.mp_ops``), the dp sync where dp > 1, ``opt.step()``.
The ranks of one dp coordinate take the same batch: step k's rows of
``RandomState(--seed)``'s ids, labels rolled by one.

``--config headline`` is ``tools/port_train_bench.py``'s
``headline_big_config("full")`` with ``tensor_parallel=True`` (bf16, bf16
AdamW moments, full recompute, the stacked trunk; ``--layers`` cuts the
depth), ``--config tiny`` the fp32 ``llama_tiny_config`` with ``--kw``'s
fields (JSON). After every step the ranks exchange over the job's store a
SHA-256 digest of the replicated parameters (every rank's must be equal)
and of their mp slices (equal across the ranks of a dp group).

``--reference``: first, rank 0 runs the same steps on one rank with the
whole model from the same weights, on the global batch of each step, and
keeps its losses, step 1's gradients and each step's parameters on the
host; then, while the mp job steps, it holds the mp loss, step 1's
gradients (gathered over the mp group) and each step's gathered
parameters to them: loss within ``tol["loss"]`` relative, each tensor's
norm of the difference over its norm within ``tol["grad"]`` and
``tol["param"]`` (why these values: below); for a bf16 model also
step 1's gradients against fp32 ones (the accuracy check, below).
``--save-params``: rank 0 writes each step's gathered parameters and
the losses to ``<out>/params.npz`` (fp32 models). ``--ckpt DIR``: after
the steps, ``distributed.save_state_dict(convert.jax_state_dict(model),
DIR)`` (JAX's layout and global shapes) and each rank's regions with
their digests in ``DIR/regions<r>.json``. ``--load DIR`` instead of
training: build the model (split at ``--mp``, whole at one rank), load
``DIR`` into ``jax_state_dict(model)`` and require every saved region's
digest of the loaded tensors.

Each rank writes ``<out>/rank<r>.json``: losses, digests, each step's
seconds by part (forward and backward, the mp collectives' count, bytes
and seconds within them, the dp sync, AdamW), launch counts a step,
peak device memory of the steps (the checks' gathers left out) and the
memory resting after the last step, the reference checks. It imports
nothing of JAX.

Tolerances. In fp32 (``--config tiny``) the mp run differs from one rank
only in the order of sums (a row-split product adds its halves' partial
sums): 1e-5 everywhere. In bf16 the row-split products (o and down,
2 a layer) and the gradients behind ``c_identity`` (2 a layer) round
each rank's partial output to bf16 before the sum, where one rank's
product rounds once: one more rounding of unit roundoff u = 2^-8 at each
of 4L sites (sqrt(4L) u = 3.1e-2 at L = 16 from those alone). But once
the first split product's output differs, every later bf16 rounding on
the path (about 36 a layer: forward, recompute and backward) rounds
other inputs, so the two runs' gradients differ like two draws of a
random walk over all of them: 3.6e-2 to 3.7e-2 for every tensor of the
headline model at L = 16 on an H100, where data parallelism, which
leaves each sample's arithmetic as it is, differs by 2.9e-3. The
gradient tolerance is chip_smoke's phase 16 bound for a bf16
data-parallel gradient, 5e-2 (``GRAD_TOL_BF16``); a missing all-reduce
moves a gradient by its own size. Beside it, the accuracy
check: rank 0 also computes step 1's gradients of the same weights in
fp32, and each mp gradient's distance from them may be at most
``ACC_RATIO`` = 1.5 times one rank's bf16 gradient's: the mp route adds
its 4L roundings to the roughly 36L a bf16 step makes on the path
(forward, recompute and backward), sqrt(40 / 36) = 1.05 of one rank's
error, and the two runs' errors are two draws of one random walk, whose
ratio spreads (1.16 at the tiny bf16 model's norm weight on the CPU);
a missing all-reduce or a wrong slice puts the ratio at 10 or more. The
loss is a mean over the batch's tokens, which averages
these errors out: u/2 = 2^-9 (``LOSS_TOL_BF16``). A parameter moves by
at most lr (1 + wd |p|) a step under AdamW (|m^/sqrt(v^)| <= 1.0013 at
steps 1 and 2), and bf16 stores it to half an ulp, 2^-9 relative: the
parameter tolerance is half the relative norm that two steps with
updates of random relative sign would leave on N(0, 0.02) weights,
(2 steps) (2 lr) sqrt(1/2) / 0.02 / 2 = 7.1e-3 at lr 1e-4, plus one
such rounding (``PARAM_TOL_BF16`` = 9e-3): a gradient that agrees no
better than chance fails it."""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

if __package__ in (None, ""):      # run as a script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

LR, WD = 1e-4, 0.01
FP32_TOL = 1e-5
LOSS_TOL_BF16 = 2.0 ** -9
GRAD_TOL_BF16 = 5e-2
PARAM_TOL_BF16 = 9e-3
ACC_RATIO = 1.5


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", choices=("headline", "tiny"),
                    default="headline")
    ap.add_argument("--kw", default="{}")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--mp", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--save-params", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--load", default=None)
    ap.add_argument("--tag", default="run",
                    help="the store keys' prefix (one per run of a job)")
    return ap.parse_args(argv)


def tolerances(dtype) -> dict:
    import torch
    if dtype == torch.float32:
        return {"loss": FP32_TOL, "grad": FP32_TOL, "param": FP32_TOL}
    return {"loss": LOSS_TOL_BF16, "grad": GRAD_TOL_BF16,
            "param": PARAM_TOL_BF16}


def config(args):
    from paddle_tpu_torch.models import llama_tiny_config
    if args.config == "headline":
        from tools.port_train_bench import headline_big_config
        cfg = headline_big_config("full")
        cfg.tensor_parallel = True
    else:
        cfg = llama_tiny_config(**json.loads(args.kw))
    if args.layers:
        cfg.num_hidden_layers = args.layers
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


def batches(args, cfg, dp, dp_rank, device):
    """Step k's batch of this dp rank and step k's global batch (every
    dp rank's, in dp order)."""
    import numpy as np
    import torch
    n = dp * args.batch * args.steps
    ids = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (n, args.seq)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    out = []
    for k in range(args.steps):
        g0, g1 = k * dp * args.batch, (k + 1) * dp * args.batch
        r0 = g0 + dp_rank * args.batch
        mine = tuple(torch.from_numpy(a[r0:r0 + args.batch]).to(device)
                     for a in (ids, labels))
        glob = tuple(torch.from_numpy(a[g0:g1]).to(device)
                     for a in (ids, labels))
        out.append((mine, glob))
    return out


def sha(t) -> str:
    import torch
    t = t.detach().contiguous()
    return hashlib.sha256(t.view(torch.uint8).cpu().numpy()).hexdigest()


def digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        h.update(name.encode())
        h.update(sha(t).encode())
    return h.hexdigest()


def agree(store, tag, members, me, value: str):
    """Publish ``value`` under ``tag`` and raise unless every member's
    (global ranks) is equal to it."""
    store.set(f"mp/{tag}/{me}", value)
    got = [store.get(f"mp/{tag}/{r}").decode() for r in members]
    if len(set(got)) != 1:
        raise AssertionError(f"rank {me}: {tag} differs across ranks "
                             f"{members}: {got}")


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def gather_full(model, tensors, mp) -> dict:
    """``{name: whole tensor}``: each mp-split tensor of ``tensors``
    (``name -> tensor``, the parameters' shapes) all-gathered over the mp
    group along its split dimension; the others as they are. A
    collective: every rank of the mp group calls it."""
    from paddle_tpu_torch.distributed.fleet import mp_ops
    from paddle_tpu_torch.distributed.mesh import spec_dim
    out, split = {}, getattr(model, "_mp_split", {})
    for name, t in tensors.items():
        if name in split:
            dim = spec_dim(split[name][0])
            out[name] = mp_ops._all_gather(t.detach(), mp, dim)
        else:
            out[name] = t.detach()
    return out


def run_reference(args, cfg, device, data, make_opt):
    """Rank 0's one-rank run on each step's global batch: (losses, step
    1's gradients, each step's parameters, step 1's gradients of the
    same model in fp32 or None for an fp32 model), all on the host."""
    import torch
    model, _ = build(args, cfg, device)
    grads32 = None
    if next(model.parameters()).dtype != torch.float32:
        model.float()           # bf16 -> fp32 is exact: the same weights
        model(*data[0][1])[0].backward()
        grads32 = {n: p.grad.detach().to("cpu", copy=True)
                   for n, p in model.named_parameters()}
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        model, _ = build(args, cfg, device)
    opt = make_opt(model)
    losses, grads, params = [], None, []
    for _, glob in data:
        loss = model(*glob)[0]
        loss.backward()
        if grads is None:
            grads = {n: p.grad.detach().to("cpu", copy=True)
                     for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
        params.append({n: p.detach().to("cpu", copy=True)
                       for n, p in model.named_parameters()})
    del model, opt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return losses, grads, params, grads32


def check(kind, got: dict, want: dict, tol: float, failed: list) -> dict:
    """Per-tensor relative norms of ``got`` against ``want``: the
    largest, its tensor, the median and the three worst; past ``tol``
    the check is added to ``failed`` (the run raises at its end, after
    every check has been recorded)."""
    rels = sorted(((rel(got[n].cpu(), w), n) for n, w in want.items()),
                  reverse=True)
    out = {"max": rels[0][0], "worst": rels[0][1], "tol": tol,
           "median": rels[len(rels) // 2][0],
           "top3": [[n, r] for r, n in rels[:3]]}
    if out["max"] > tol:
        failed.append(f"{kind} against one rank: {out}")
    return out


def accuracy(got: dict, one: dict, fp32: dict, failed: list) -> dict:
    """How far the mp gradients (``got``) and one rank's (``one``) lie
    from the fp32 gradients of the same weights and batch, per tensor:
    the mp gradient must be as accurate as one rank's, within
    ``ACC_RATIO`` (past it the check is added to ``failed``)."""
    ratios, e_one, e_mp = {}, [], []
    for n, w in fp32.items():
        a, b = rel(got[n].cpu(), w), rel(one[n], w)
        e_mp.append(a)
        e_one.append(b)
        ratios[n] = a / max(b, 1e-30)
    worst = max(ratios, key=ratios.get)
    out = {"ratio_max": ratios[worst], "worst": worst, "tol": ACC_RATIO,
           "one_rank_median": sorted(e_one)[len(e_one) // 2],
           "one_rank_max": max(e_one),
           "mp_median": sorted(e_mp)[len(e_mp) // 2], "mp_max": max(e_mp)}
    if out["ratio_max"] > ACC_RATIO:
        failed.append(f"step 1's gradients against fp32: {out}")
    return out


def regions(sd, rank) -> dict:
    """``{key: {"region", "sha"}}`` of the tensors this rank writes of a
    ``jax_state_dict`` (its first-holder regions; the replicated tensors
    on rank 0)."""
    from paddle_tpu_torch.distributed.sharding import ShardedTensor
    out = {}
    for k, v in sd.items():
        if isinstance(v, ShardedTensor):
            if v.replica == 0:
                out[k] = {"region": v.region, "sha": sha(v.local)}
        elif rank == 0:
            out[k] = {"region": [[0, d] for d in v.shape], "sha": sha(v)}
    return out


def load_and_check(args, model, rank) -> dict:
    """Load ``--load`` into ``jax_state_dict(model)`` and hold every
    saved region that this rank's tensors cover to its digest."""
    from paddle_tpu_torch.convert import jax_state_dict
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.distributed.sharding import ShardedTensor
    sd = jax_state_dict(model)
    t0 = time.perf_counter()
    ck.load_state_dict(sd, args.load)
    seconds = time.perf_counter() - t0
    saved = {}
    for name in sorted(os.listdir(args.load)):
        if name.startswith("regions") and name.endswith(".json"):
            with open(os.path.join(args.load, name)) as f:
                for k, v in json.load(f).items():
                    saved.setdefault(k, []).append(v)
    checked, bad = 0, []
    for k, v in sd.items():
        if isinstance(v, ShardedTensor):
            local, base = v.local, v.region
        else:
            local, base = v, [[0, d] for d in v.shape]
        for rec in saved.get(k, []):
            reg = rec["region"]
            if any(a < b0 or b > b1 for (a, b), (b0, b1) in zip(reg, base)):
                continue
            piece = local[tuple(slice(a - b0, b - b0)
                                for (a, b), (b0, _) in zip(reg, base))]
            checked += 1
            if sha(piece) != rec["sha"]:
                bad.append(k)
    if bad or not checked:
        raise AssertionError(f"rank {rank}: loaded regions differ from the "
                             f"saved ones: {bad} ({checked} checked)")
    return {"regions_checked": checked, "load_s": seconds,
            "regions_saved": sum(len(v) for v in saved.values())}


def train(args, cfg, device, rank, world, hcg, store):
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import mp_ops
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients

    mp = hcg.get_model_parallel_group()
    dp_group = hcg.get_data_parallel_group()
    dp, dp_rank = hcg.get_data_parallel_world_size(), \
        hcg.get_data_parallel_rank()
    data = batches(args, cfg, dp, dp_rank, device)
    model, make_opt = build(args, cfg, device)
    tol = tolerances(next(model.parameters()).dtype)
    rec = {"rank": rank, "world": world, "mp": mp_ops.mp_degree(mp),
           "dp": dp, "mp_rank": hcg.get_model_parallel_rank(),
           "dp_rank": dp_rank, "losses": [], "replicated_digests": [],
           "slice_digests": [], "step_s": [], "launches": [], "tol": tol,
           "layers": cfg.num_hidden_layers,
           "params": sum(p.numel() for p in model.parameters())}
    ref = None
    if args.reference:
        if rank == 0:
            t0 = time.perf_counter()
            ref = run_reference(args, cfg, device, data, make_opt)
            rec["reference_s"] = time.perf_counter() - t0
        C.barrier()
    model = fleet.distributed_model(model)
    inner = getattr(model, "_layers", model)
    opt = fleet.distributed_optimizer(make_opt(inner))
    split = getattr(inner, "_mp_split", {})
    rec["split"] = {n: list(s[1]) for n, s in split.items()}
    rec["local_params"] = sum(p.numel() for p in inner.parameters())
    rec["param_tensors"] = len(list(inner.parameters()))
    replicated = [n for n, _ in inner.named_parameters() if n not in split]
    mp_members = mp.ranks if mp is not None else [rank]
    dp_members = dp_group.ranks if dp_group is not None else [rank]
    saved, peak, failed = {}, [0.0], []

    def training_peak():
        """The peak of the training parts since the last call (the
        checks' gathers between them are left out)."""
        if device.type == "cuda":
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step, (mine, _) in enumerate(data, 1):
        ops.reset_launch_counts()
        mp_ops.reset_mp_stats()
        _sync(device)
        t0 = time.perf_counter()
        loss = model(*mine)[0]
        loss.backward()
        _sync(device)
        t1 = time.perf_counter()
        comm = mp_ops.mp_stats()
        if dp > 1:
            fused_allreduce_gradients(list(inner.parameters()),
                                      group=dp_group)
        _sync(device)
        t2 = time.perf_counter()
        launches = ops.launch_counts()
        training_peak()
        if step == 1 and args.reference:
            grads = gather_full(inner, {n: p.grad for n, p in
                                        inner.named_parameters()}, mp)
            if ref is not None:
                rec["grad_check"] = check("step 1's gradients", grads,
                                          ref[1], tol["grad"], failed)
                if ref[3] is not None:
                    rec["accuracy"] = accuracy(grads, ref[1], ref[3],
                                               failed)
            del grads
        ops.reset_launch_counts()
        training_peak()
        _sync(device)
        t3 = time.perf_counter()
        opt.step()
        _sync(device)
        t4 = time.perf_counter()
        launches = {k: launches.get(k, 0) + v
                    for k, v in ops.launch_counts().items()}
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
        rec["step_s"].append({
            "fwd_bwd": t1 - t0, "mp_collectives": comm["all_reduce"]
            + comm["all_gather"], "mp_bytes": comm["bytes"],
            "mp_s": comm["seconds"], "dp_sync": t2 - t1,
            "adamw": t4 - t3})
        named = dict(inner.named_parameters())
        d = digest([(n, named[n]) for n in replicated])
        agree(store, f"{args.tag}/replicated{step}", list(range(world)),
              rank, d)
        rec["replicated_digests"].append(d)
        s = digest([(n, named[n]) for n in split])
        agree(store, f"{args.tag}/slices{step}/mp{rec['mp_rank']}",
              dp_members, rank, s)
        rec["slice_digests"].append(s)
        if args.reference or args.save_params:
            full = gather_full(inner, named, mp)
            if ref is not None:
                rec.setdefault("loss_check", []).append(
                    {"mp": lval, "one_rank": ref[0][step - 1],
                     "rel": abs(lval - ref[0][step - 1])
                     / abs(ref[0][step - 1]), "tol": tol["loss"]})
                if rec["loss_check"][-1]["rel"] > tol["loss"]:
                    failed.append(f"step {step}'s loss against one rank: "
                                  f"{rec['loss_check'][-1]}")
                rec.setdefault("param_check", []).append(
                    check(f"step {step}'s parameters", full,
                          ref[2][step - 1], tol["param"], failed))
            if args.save_params and rank == 0:
                for n, t in full.items():
                    saved[f"{step}/{n}"] = t.float().cpu().numpy().copy()
            del full
    if device.type == "cuda":
        rec["peak_mem_gb"] = peak[0] / 1e9
    rec["mp_members"] = mp_members
    if not all(x == x and abs(x) != float("inf") for x in rec["losses"]):
        failed.append(f"non-finite loss: {rec['losses']}")
    if saved:
        import numpy as np
        np.savez(os.path.join(args.out, "params.npz"),
                 losses=np.array(rec["losses"]), **saved)
    if args.ckpt:
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
    return rec


def main(argv=None) -> int:
    args = parse(argv)
    from paddle_tpu_torch.distributed import (fleet, get_rank,
                                              get_world_size,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.checkpoint import atomic_json_dump

    t_start = time.perf_counter()
    env = init_parallel_env(device=args.device)
    device = env.device
    rank, world = get_rank(), get_world_size()
    mp = args.mp if world > 1 else 1
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": -1, "mp_degree": mp}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = config(args)
    os.makedirs(args.out, exist_ok=True)
    if args.load:
        import torch
        model, _ = build(args, cfg, device)
        if mp > 1:
            fleet.distributed_model(model)
        rec = {"rank": rank, "world": world, "mp": mp,
               **load_and_check(args, model, rank)}
        if device.type == "cuda":
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    else:
        rec = train(args, cfg, device, rank, world, hcg, C._get_store())
    rec["backend"] = env.backend
    rec["seconds"] = time.perf_counter() - t_start
    atomic_json_dump(os.path.join(args.out, f"rank{rank}.json"), rec)
    if rec.get("failed"):
        raise AssertionError(f"rank {rank}: " + "; ".join(rec["failed"]))
    C.barrier()
    C.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
