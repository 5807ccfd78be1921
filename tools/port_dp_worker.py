#!/usr/bin/env python3
"""One rank of a data-parallel training job on the port.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --log_dir LOG tools/port_dp_worker.py --out DIR [options]

The manual data-parallel loop of the reference (``tests/
test_process_golden.py`` in the JAX package): ``init_parallel_env``, a
per-rank shard of the data through ``DistributedBatchSampler``,
``DataLoader`` and ``device_prefetch``, ``DataParallel``, forward and
backward, ``fleet.utils.fused_allreduce_gradients`` (bucketed unless
``--sync tensor``), then ``opt.step()`` (AdamW). The step is eager: a
gloo or store collective cannot sit inside a captured CUDA graph.

Model: ``--config headline`` is ``tools/port_train_bench.py``'s
``headline_big_config("full")`` (a pure-bf16 build, bf16 AdamW moments;
``--layers`` cuts the depth), ``--config tiny`` the 2-layer
``llama_tiny_config`` in fp32 (``--init`` loads its weights from an npz
of the port's state dict). Data: ``ranks x batch x steps`` sequences of
``--seq`` tokens from ``RandomState(--seed)``, labels rolled by one.

After every step the ranks exchange a SHA-256 digest of their parameters
over the job's store and stop unless they are equal. ``--reference``:
before step 1, rank 0 computes on one rank the gradient of the global
batch (every rank's first batch) and of each rank's half; after step
1's sync its gradient must equal the mean of the halves bit for bit (the
sync's only rounding is the mean's) and lie within ``GRAD_TOL`` of the
global batch's. ``--ckpt-dir``/``--ckpt-step`` write each rank's atomic
checkpoint after that step and resume from it at start;
``--fail-rank``/``--fail-step`` make that rank exit with code 3 after
that step on the first launch (the elastic relaunch's failure).
``--store-checks``: a 64 MiB p2p round trip between ranks 0 and 1
through the store, a subset-group collective and ``ElasticManager``
membership.

Each rank writes ``<out>/rank<r>.json`` (losses, digests, the step's
seconds by part, the sync's bytes, launch counts, collective routes,
peak memory, checks) and, with ``--save-params``, ``<out>/rank<r>-
<sync>.npz`` (its final parameters, fp32 models only). It imports
nothing of JAX."""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
import warnings

if __package__ in (None, ""):      # run as a script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

# the synced gradient against the one-rank global batch's, per tensor
# (norm of the difference over the norm): the two differ only in where
# bf16 rounds after products whose summation order follows the batch
# shape (the halves' mean itself is checked bit for bit)
GRAD_TOL = 5e-2
P2P_ELEMS = 16 << 20            # a 64 MiB fp32 tensor
LR, WD = 1e-4, 0.01


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", choices=("headline", "tiny"),
                    default="headline")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--sync", default="bucketed")
    ap.add_argument("--bucket-mb", type=int, default=25)
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-step", type=int, default=0)
    ap.add_argument("--fail-rank", type=int, default=-1)
    ap.add_argument("--fail-step", type=int, default=0)
    ap.add_argument("--store-checks", action="store_true")
    ap.add_argument("--save-params", action="store_true")
    return ap.parse_args(argv)


def build(args, device):
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
    from paddle_tpu_torch.optimizer import AdamW
    if args.config == "headline":
        from tools.port_train_bench import headline_big_config
        cfg = headline_big_config("full")
    else:
        cfg = llama_tiny_config()
    if args.layers:
        cfg.num_hidden_layers = args.layers
    model = LlamaForCausalLM(cfg, device=device, seed=args.seed)
    if args.init:
        import numpy as np
        with np.load(args.init) as z:
            model.load_state_dict({k: torch.from_numpy(z[k]) for k in z})
    opt = AdamW(learning_rate=LR, weight_decay=WD,
                parameters=model.parameters(), multi_precision=False)
    return cfg, model, opt


def dataset(args, cfg, world):
    import numpy as np
    from paddle_tpu_torch import io
    n = world * args.batch * args.steps
    ids = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (n, args.seq)).astype(np.int32)
    return io.TensorDataset([ids, np.roll(ids, -1, axis=1)])


def digest(model) -> str:
    """SHA-256 of every parameter's bytes, in ``named_parameters`` order."""
    import torch
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def agree(store, tag, rank, world, value: str):
    """Publish ``value`` under ``tag`` and raise unless every rank's is
    equal to it."""
    store.set(f"dp/{tag}/{rank}", value)
    got = [store.get(f"dp/{tag}/{r}").decode() for r in range(world)]
    if len(set(got)) != 1:
        raise AssertionError(f"rank {rank}: {tag} differs across ranks: "
                             f"{got}")


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _grads(model, batch):
    """(loss, gradients) of one forward and backward; no update."""
    model.zero_grad(set_to_none=True)
    loss = model(*batch)[0]
    loss.backward()
    out = [p.grad.detach().clone() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def reference(model, ds, args, world, device):
    """Rank 0's one-rank gradients of step 1: the global batch (every
    rank's first batch, in rank order) and each rank's own half."""
    import torch
    from paddle_tpu_torch import io
    halves = []
    for r in range(world):
        idx = next(iter(io.DistributedBatchSampler(
            ds, args.batch, num_replicas=world, rank=r)))
        ids, labels = ds.tensors[0][idx], ds.tensors[1][idx]
        halves.append((torch.from_numpy(ids).to(device),
                       torch.from_numpy(labels).to(device)))
    glob = tuple(torch.cat([h[i] for h in halves]) for i in range(2))
    loss, g_global = _grads(model, glob)
    parts = [_grads(model, h)[1] for h in halves]
    mean = []
    for i, g in enumerate(g_global):
        total = parts[0][i].float()
        for p in parts[1:]:
            total = total + p[i].float()
        mean.append((total / world).to(g.dtype))
    return loss, g_global, mean


def _bits(t):
    import torch
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def check_reference(model, ref):
    """Step 1's synced gradients against the one-rank ones."""
    import torch
    _, g_global, mean = ref
    names = [n for n, _ in model.named_parameters()]
    rel, unequal = {}, []
    for n, p, gg, gm in zip(names, model.parameters(), g_global, mean):
        g = p.grad.detach()
        if g.dtype != gm.dtype or not torch.equal(_bits(g), _bits(gm)):
            unequal.append(n)
        d = (g.float() - gg.float()).norm() / gg.float().norm()
        rel[n] = float(d)
    worst = max(rel, key=rel.get)
    out = {"grad_rel_max": rel[worst], "grad_rel_worst": worst,
           "grad_rel_median": sorted(rel.values())[len(rel) // 2],
           "grad_tol": GRAD_TOL, "halves_mean_unequal": unequal}
    if unequal or rel[worst] > GRAD_TOL:
        raise AssertionError(f"step 1's synced gradient: {out}")
    return out


def store_checks(device, rank, world):
    """A 64 MiB p2p round trip 0 -> 1 -> 0 through the store, a
    collective of the subset group [1] (rank 0 takes no part), and
    ``ElasticManager`` membership of every rank."""
    import torch
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.elastic import ElasticManager
    store = C._get_store()
    out = {"store_native": store.is_native}
    gen = torch.Generator(device=device).manual_seed(1234)
    x = torch.randn(P2P_ELEMS, generator=gen, device=device)
    buf = torch.empty_like(x)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        if rank == 0:
            C.send(x, dst=1)
            C.recv(buf, src=1)
        elif rank == 1:
            C.recv(buf, src=0)
            C.send(buf, dst=0)
        _sync(device)
        out["p2p_round_trip_s"] = time.perf_counter() - t0
    out["bulk_warnings"] = sum("TCP store" in str(w.message)
                               for w in caught)
    out["p2p_bytes"] = x.numel() * x.element_size()
    out["p2p_equal"] = rank > 1 or bool(torch.equal(buf, x))
    g = C.new_group([1])
    if rank == 1:
        y = torch.arange(4, dtype=torch.float32, device=device)
        C.all_reduce(y, group=g)
        got = []
        C.all_gather(got, y, group=g)
        out["subset_ok"] = bool(torch.equal(y, torch.arange(
            4, dtype=torch.float32, device=device))) and len(got) == 1
    host, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    em = ElasticManager(host, int(port), node_id=f"rank{rank}",
                        heartbeat_interval=0.2, heartbeat_timeout=10.0)
    em.register()
    C.barrier()
    out["elastic_alive"] = sorted(em.alive_nodes())
    C.barrier()
    em.close()
    if out["elastic_alive"] != [f"rank{r}" for r in range(world)] \
            or not out["p2p_equal"] or out["bulk_warnings"] != 1 \
            or not out.get("subset_ok", True):
        raise AssertionError(f"rank {rank} store checks: {out}")
    return out


def train(args, sync, device, rank, world, restart, store):
    """One run of the job with gradient sync ``sync``; its record."""
    import torch
    from paddle_tpu_torch import io, ops
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.checkpoint import atomic_write
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients

    cfg, model, opt = build(args, device)
    dp = DataParallel(model, comm_buffer_size=args.bucket_mb)
    ds = dataset(args, cfg, world)
    loader = io.DataLoader(ds, batch_sampler=io.DistributedBatchSampler(
        ds, args.batch))
    start = 0
    ckpt = os.path.join(args.ckpt_dir, f"rank{rank}.pt") \
        if args.ckpt_dir else None
    if ckpt and os.path.exists(ckpt):
        state = torch.load(ckpt, map_location=device)
        model.load_state_dict(state["model"])
        opt.set_state_dict(state["opt"])
        start = state["step"]
    ref = reference(model, ds, args, world, device) \
        if args.reference and rank == 0 and start == 0 else None
    rec = {"sync": sync, "resumed_from": start, "losses": [],
           "digests": [], "step_s": []}
    bucket = args.bucket_mb << 20 if sync == "bucketed" else None
    if sync not in ("bucketed", "tensor"):
        raise ValueError(f"--sync {sync!r}: bucketed or tensor")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    C.reset_counters()
    for step, batch in enumerate(io.device_prefetch(loader, size=2,
                                                    device=device), 1):
        if step <= start:
            continue
        _sync(device)
        t0 = time.perf_counter()
        loss = dp(*batch)[0]
        loss.backward()
        _sync(device)
        t1 = time.perf_counter()
        before = C.stage_stats()
        fused_allreduce_gradients(list(dp.parameters()),
                                  bucket_bytes=bucket)
        _sync(device)
        t2 = time.perf_counter()
        after = C.stage_stats()
        if step == 1 and ref is not None:
            rec["reference"] = check_reference(model, ref)
            rec["reference"]["global_loss"] = ref[0]
            del ref
        opt.step()
        _sync(device)
        t3 = time.perf_counter()
        opt.clear_grad()
        rec["losses"].append(float(loss.detach()))
        rec["step_s"].append({
            "fwd_bwd": t1 - t0, "sync": t2 - t1, "adamw": t3 - t2,
            **{k: after[k] - before[k]
               for k in ("d2h_s", "transport_s", "h2d_s", "bytes")}})
        d = digest(model)
        agree(store, f"r{restart}/{sync}/digest{step}", rank, world, d)
        rec["digests"].append(d)
        if ckpt and step == args.ckpt_step:
            state = {"model": model.state_dict(),
                     "opt": opt.state_dict(), "step": step}
            os.makedirs(args.ckpt_dir, exist_ok=True)
            atomic_write(ckpt, lambda f: torch.save(state, f))
            C.barrier()          # every rank's checkpoint is written
        if restart == 0 and rank == args.fail_rank \
                and step == args.fail_step:
            print(f"rank {rank}: exiting after step {step} (the elastic "
                  f"relaunch's failure)", flush=True)
            sys.exit(3)
    rec["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    rec["routes"] = C.route_counts()
    if device.type == "cuda":
        rec["peak_mem_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["params"] = sum(p.numel() for p in model.parameters())
    rec["param_tensors"] = len(list(model.parameters()))
    rec["layers"] = cfg.num_hidden_layers
    if not all(x == x and abs(x) != float("inf") for x in rec["losses"]):
        raise AssertionError(f"non-finite loss: {rec['losses']}")
    if args.save_params:
        import numpy as np
        np.savez(os.path.join(args.out, f"rank{rank}-{sync}.npz"),
                 **{n: p.detach().cpu().numpy()
                    for n, p in model.named_parameters()})
    return rec


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from paddle_tpu_torch.distributed import (get_rank, get_world_size,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.checkpoint import atomic_json_dump

    t_start = time.perf_counter()
    env = init_parallel_env(device=args.device)
    device = env.device
    rank, world = get_rank(), get_world_size()
    restart = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
    store = C._get_store()
    out = {"rank": rank, "world": world, "restart": restart,
           "backend": env.backend, "device": str(device),
           "store_native": store.is_native, "runs": {}}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    for sync in args.sync.split(","):
        out["runs"][sync] = train(args, sync, device, rank, world,
                                  restart, store)
    if args.store_checks:
        out["store"] = store_checks(device, rank, world)
        out["routes"] = C.route_counts()
    out["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    atomic_json_dump(os.path.join(args.out, f"rank{rank}.json"), out)
    C.barrier()
    C.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
