#!/usr/bin/env python3
"""One rank of a group-sharded (ZeRO) training job on the port.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2 \\
        --log_dir LOG tools/port_zero_worker.py --out DIR [options]

From the same initial weights (``--seed``) and the same batches (the
data-parallel worker's: ``tools/port_dp_worker.py`` ``dataset``, through
``DistributedBatchSampler``, ``DataLoader`` and ``device_prefetch``),
each run builds the model and an AdamW with bf16 moments and trains
``--steps`` eager steps (over ``--data-steps`` steps of data, when
given):

- ``dp``: the data-parallel loop (bucketed ``fused_allreduce_gradients``,
  then ``opt.step()``), the reference; ``--dp-args`` runs
  ``tools/port_dp_worker.py``'s job (its arguments, on the same model and
  data) in this process first instead, and its digests are the
  reference (``chip_smoke.py`` phases 16 (a) and 17 (a) in one job);
- ``os``: ``group_sharded_parallel(model, opt, "os")``; it saves its
  state after step ``--steps`` - 1 with ``save_state_dict(...,
  async_save=True)`` + ``wait_async_save()`` into ``<out>/ckpt`` (the
  model's and the optimizer's state dicts);
- ``os_g``: built through ``fleet.init`` + ``fleet.distributed_model`` +
  ``fleet.distributed_optimizer`` with ``sharding_configs={"stage": 2}``;
- ``p_g_os``: ``group_sharded_parallel(model, opt, "p_g_os")``;
- ``load``: a fresh ``p_g_os`` run that loads ``<out>/ckpt`` and takes
  the ``os`` run's last step;
- ``gm``: ``fleet.distributed_optimizer`` with ``gradient_merge_configs=
  {"k_steps": 2}`` (and sharding stage 1): step 1's batch as two halves,
  two micro-steps; against ``gm_full``, the whole batch in one step. The
  merged gradient (before the step's reduction) is held to the whole
  batch's within ``GRAD_TOL`` (per tensor, relative norm). Both at
  ``--gm-layers`` layers when given.

After every step each rank takes a SHA-256 digest of its parameters (the
bytes copied to pinned host memory, hashed on a thread beside the next
step); at a run's end the ranks exchange them over the job's store and
stop unless they agree, and a sharded run's digests must equal the
``dp`` run's step for step (bit for bit: at 2
ranks a sum of two fp32 terms does not depend on its order, the mean by
2 is exact, AdamW is elementwise and a gather copies). Launch counts
are read each step. ``--load1`` instead runs on one rank: it loads
``<out>/ckpt`` into a plain (unsharded) model and optimizer, hashes
every region as the saving ranks did, and takes the ``os`` run's last
step from the mean of the two ranks' gradients.

Each rank writes ``<out>/rank<r>.json`` (``<out>/load1.json``; the
checkpoint ``--load1`` reads is ``--ckpt``, default ``<out>/ckpt``): per run
the losses, digests, the step's parts (forward+backward, each
collective's seconds, bytes and route, AdamW), peak and resting memory,
slot bytes and launches. It imports nothing of JAX."""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

if __package__ in (None, ""):      # run as a script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tools import port_dp_worker  # noqa: E402
from tools.port_dp_worker import agree, build, dataset, digest  # noqa: E402

GRAD_TOL = 5e-2          # bf16: the halves' sum against the whole batch


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--config", choices=("headline", "tiny"),
                    default="headline")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--data-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--init", default=None)
    ap.add_argument("--runs", default="dp,os,os_g,p_g_os,load,gm,gm_full")
    ap.add_argument("--gm-layers", type=int, default=None)
    ap.add_argument("--load1", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dp-args", default=None)
    return ap.parse_args(argv)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem(device):
    import torch
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 1e9


_POOL = None


def _host_bytes(tensors):
    """The tensors' bytes in one pinned host buffer, copied now."""
    import torch
    views = [t.detach().contiguous().view(torch.uint8).reshape(-1)
             for t in tensors]
    buf = torch.empty(sum(v.numel() for v in views), dtype=torch.uint8,
                      pin_memory=views[0].is_cuda if views else False)
    off = 0
    for v in views:
        buf[off:off + v.numel()].copy_(v, non_blocking=True)
        off += v.numel()
    if views and views[0].is_cuda:
        torch.cuda.synchronize(views[0].device)
    return buf, [v.numel() for v in views]


def _hash_later(tensors, names=None):
    """SHA-256 of the tensors' bytes (each after its name, when given:
    ``port_dp_worker.digest``'s layout), copied now and hashed on a
    thread: a future of the hex digest."""
    global _POOL
    from concurrent.futures import ThreadPoolExecutor
    if _POOL is None:
        _POOL = ThreadPoolExecutor(2)
    buf, sizes = _host_bytes(tensors)

    def run():
        h = hashlib.sha256()
        arr = buf.numpy()
        off = 0
        for i, n in enumerate(sizes):
            if names is not None:
                h.update(names[i].encode())
            h.update(arr[off:off + n])
            off += n
        return h.hexdigest()
    return _POOL.submit(run)


def _digest_later(model):
    named = list(model.named_parameters())
    return _hash_later([p for _, p in named], [n for n, _ in named])


def _hash(tensors) -> str:
    return _hash_later(list(tensors)).result()


def slot_regions(opt, n, rank):
    """Rank ``rank``'s region of every slot of ``opt`` (at degree ``n``,
    by the sharding rule), in parameter order: full slots are cut here,
    regions of a sharded optimizer pass as they are."""
    from paddle_tpu_torch.distributed.sharding import region, sharded_dim
    out = []
    plan = opt._shard_plan
    for p in opt._param_list:
        for _, v in sorted(opt._slots.get(id(p), {}).items()):
            if plan is None:
                shape = tuple(p.shape)
                d = sharded_dim(shape, n)
                if d is not None:
                    a, b = region(shape, d, n, rank)[d]
                    v = v.narrow(d, a, b - a)
            out.append(v)
    return out


def _dataset(args, cfg, world):
    """The data-parallel worker's data, ``--data-steps`` steps of it
    (default ``--steps``): a job that trains fewer steps than the
    data-parallel one sees its batches when it sizes the data as it did
    (each rank's shard is a contiguous range of the rows)."""
    return dataset(argparse.Namespace(
        **{**vars(args), "steps": args.data_steps or args.steps}), cfg,
        world)


def _loader(args, ds, world, rank=None):
    from paddle_tpu_torch import io
    kw = {} if rank is None else {"num_replicas": world, "rank": rank}
    return io.DataLoader(ds, batch_sampler=io.DistributedBatchSampler(
        ds, args.batch, **kw))


def _batches(args, ds, world, device, rank=None):
    from paddle_tpu_torch import io
    return list(io.device_prefetch(_loader(args, ds, world, rank), size=2,
                                   device=device))


def _wrap(run, args, model, opt):
    """The run's model and optimizer (module docstring)."""
    from paddle_tpu_torch.distributed import fleet, group_sharded_parallel
    if run in ("os", "p_g_os", "load"):
        level = "p_g_os" if run == "load" else run
        model, opt, _ = group_sharded_parallel(model, opt, level)
        return model, opt, model
    if run == "os_g":
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": -1}
        st.sharding = True
        st.sharding_configs = {"stage": 2}
        fleet.init(is_collective=True, strategy=st)
        dp = fleet.distributed_model(model)
        return dp, fleet.distributed_optimizer(opt), model
    if run in ("gm", "gm_full"):
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": -1}
        st.sharding = True
        st.sharding_configs = {"stage": 1}
        if run == "gm":
            st.gradient_merge = True
            st.gradient_merge_configs = {"k_steps": 2}
        fleet.init(is_collective=True, strategy=st)
        return model, fleet.distributed_optimizer(opt), model
    return model, opt, model


def _free(device):
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_run(run, args, device, rank, world, store, ref):
    """One run (module docstring); its record."""
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.checkpoint import (
        load_state_dict, save_state_dict, wait_async_save)
    from paddle_tpu_torch.distributed.fleet.utils import \
        fused_allreduce_gradients

    if run in ("gm", "gm_full") and args.gm_layers:
        cfg, model, opt = build(argparse.Namespace(
            **{**vars(args), "layers": args.gm_layers}), device)
    else:
        cfg, model, opt = build(args, device)
    fwd, opt, inner = _wrap(run, args, model, opt)
    plan = getattr(opt, "_shard_plan", None)
    if plan is not None:
        plan.timed = True
    ds = _dataset(args, cfg, world)
    batches = _batches(args, ds, world, device)
    rec = {"run": run, "losses": [], "digests": [], "steps": [],
           "level": None if plan is None else plan.level}
    start = 0
    if run == "load":
        t0 = time.perf_counter()
        opt.functional_state()
        sd = {"model": inner.state_dict(), "opt": opt.state_dict()}
        load_state_dict(sd, os.path.join(args.out, "ckpt"))
        inner.load_state_dict(sd["model"])
        opt.set_state_dict(sd["opt"])
        _sync(device)
        from paddle_tpu_torch.distributed import checkpoint as ck
        rec["load_s"] = time.perf_counter() - t0
        rec["load_max_buffer_bytes"] = ck._last_load_stats[
            "max_buffer_bytes"]
        rec["largest_region_bytes"] = max(
            [t.numel() * t.element_size() for t in slot_regions(
                opt, world, rank)]
            + [t.numel() * t.element_size() for t in plan.rest.values()])
        rec["loaded_slots"] = _hash(slot_regions(opt, world, rank))
        plan.gather(list(inner.parameters()))
        rec["loaded_params"] = digest(inner)
        plan.release(list(inner.parameters()))
        start = args.steps - 1
    steps = 1 if run in ("gm", "gm_full") else args.steps
    pending = []
    ops.reset_launch_counts()
    C.reset_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for step in range(start + 1, steps + 1):
        batch = batches[step - 1]
        if plan is not None:
            plan.stats.clear()
        base = ops.launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        if run == "gm":
            half = batch[0].shape[0] // 2
            losses = []
            for sl in (slice(0, half), slice(half, None)):
                loss = fwd(batch[0][sl], batch[1][sl])[0]
                loss.backward()
                losses.append(float(loss.detach()))
                if sl.start == 0:
                    opt.step()           # the first micro-step: merged
            loss = torch.tensor(sum(losses) / 2)
            merged = []
            orig = opt.inner_opt.step

            def keep_then_step():
                merged.extend(p.grad.detach().clone()
                              for p in inner.parameters())
                orig()
            opt.inner_opt.step = keep_then_step
        else:
            loss = fwd(*batch)[0]
            loss.backward()
        _sync(device)
        t1 = time.perf_counter()
        part = {"fwd_bwd": t1 - t0}
        if run == "dp":
            before = C.stage_stats()
            fused_allreduce_gradients(list(inner.parameters()),
                                      bucket_bytes=25 << 20)
            _sync(device)
            after = C.stage_stats()
            part["all_reduce"] = {
                "s": time.perf_counter() - t1,
                "bytes": sum(4 * p.numel() for p in inner.parameters()),
                "staged_bytes": after["bytes"] - before["bytes"],
                "route": C._route(None)}
        elif isinstance(fwd, DataParallel):
            fwd.sync_gradients()         # the sharded step owns it
        if run == "gm_full":
            rec["full_grads"] = [p.grad.detach().clone()
                                 for p in inner.parameters()]
        t2 = time.perf_counter()
        opt.step()
        _sync(device)
        t3 = time.perf_counter()
        if run == "gm":
            del opt.inner_opt.step
            rec["merged_grads"] = merged
        if plan is None:
            part["adamw"] = t3 - t2
        else:
            for k, v in plan.stats.items():
                part["adamw" if k == "adamw" else k] = \
                    v["s"] if k == "adamw" else dict(v)
        opt.clear_grad()
        part["step_s"] = t3 - t0
        part["launches"] = {k: v - base.get(k, 0) for k, v in
                            ops.launch_counts().items()
                            if v != base.get(k, 0)}
        part["resting_gb"] = _mem(device)
        rec["steps"].append(part)
        rec["losses"].append(float(loss.detach()))
        if plan is not None and plan.level == "p_g_os":
            rec["rest_numel"] = sum(p.numel() for p in inner.parameters())
            plan.gather(list(inner.parameters()))
            pending.append(_digest_later(inner))
            plan.release(list(inner.parameters()))
        else:
            pending.append(_digest_later(inner))
        if run == "os" and step == args.steps - 1:
            rec["saved_slots"] = _hash(slot_regions(opt, world, rank))
            rec["saved_params"] = pending[-1].result()
            path = os.path.join(args.out, "ckpt")
            _sync(device)
            t0 = time.perf_counter()
            save_state_dict({"model": inner.state_dict(),
                             "opt": opt.state_dict()}, path,
                            async_save=True)
            t1 = time.perf_counter()
            wait_async_save()
            t2 = time.perf_counter()
            rec["save"] = {"snapshot_s": t1 - t0, "write_s": t2 - t1,
                           "bytes": _dir_bytes(path, rank)}
    rec["digests"] = [f.result() for f in pending]
    agree(store, f"zero/{run}/digests", rank, world,
          ",".join(rec["digests"]))
    if ref is not None:
        want = ref["digests"][start:start + len(rec["digests"])]
        if rec["digests"] != want:
            raise AssertionError(f"{run}: params differ from dp's after "
                                 f"steps {start + 1}-{steps}")
    if device.type == "cuda":
        rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    rec["slot_bytes"] = sum(t.numel() * t.element_size()
                            for s in opt._slots.values() for t in s.values())
    rec["params"] = sum(_numel(plan, p) for p in inner.parameters())
    rec["param_tensors"] = len(list(inner.parameters()))
    rec["routes"] = C.route_counts()
    if not all(x == x and abs(x) != float("inf") for x in rec["losses"]):
        raise AssertionError(f"{run}: non-finite loss {rec['losses']}")
    return rec


def _numel(plan, p):
    import math
    return math.prod(plan.shape(p)) if plan is not None else p.numel()


def _dir_bytes(path, rank):
    return os.path.getsize(os.path.join(path, f"shard_{rank}.npz"))


def _grad_rel(got, want):
    rel = [float((g.float() - w.float()).norm() / w.float().norm())
           for g, w in zip(got, want)]
    return max(rel), sorted(rel)[len(rel) // 2]


def load_one_rank(args, device, world_saved=2):
    """``--load1``: the saved 2-rank state into a plain model and
    optimizer on one rank, its regions against the saving ranks', then
    the ``os`` run's last step from the two ranks' mean gradient."""
    import json
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.distributed import checkpoint as ck
    cfg, model, opt = build(args, device)
    t0 = time.perf_counter()
    opt.functional_state()
    sd = {"model": model.state_dict(), "opt": opt.state_dict()}
    ck.load_state_dict(sd, args.ckpt or os.path.join(args.out, "ckpt"))
    model.load_state_dict(sd["model"])
    opt.set_state_dict(sd["opt"])
    _sync(device)
    out = {"load_s": time.perf_counter() - t0,
           "load_max_buffer_bytes": ck._last_load_stats["max_buffer_bytes"],
           "loaded_params": digest(model),
           "loaded_slots": [_hash(slot_regions(opt, world_saved, r))
                            for r in range(world_saved)]}
    del sd
    ds = _dataset(args, cfg, world_saved)
    step = args.steps
    halves = [_batches(args, ds, world_saved, device, r)[step - 1]
              for r in range(world_saved)]
    ops.reset_launch_counts()
    grads = []
    for b in halves:
        model.zero_grad(set_to_none=True)
        model(*b)[0].backward()
        grads.append([p.grad for p in model.parameters()])
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            total = grads[0][i].float()
            for g in grads[1:]:
                total = total + g[i].float()
            p.grad = (total / world_saved).to(p.dtype)
    del grads
    opt.step()
    _sync(device)
    out["digest"] = digest(model)
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    with open(os.path.join(args.out, "load1.json"), "w") as f:
        json.dump(out, f)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from paddle_tpu_torch.distributed import (get_rank, get_world_size,
                                              init_parallel_env)
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.checkpoint import atomic_json_dump

    t_start = time.perf_counter()
    dp_args = None
    store_p2p = None
    if args.dp_args is not None:
        import shlex
        dp_args = port_dp_worker.parse(shlex.split(args.dp_args))
        store_p2p = port_dp_worker.store_p2p_before_init(dp_args)
    env = init_parallel_env(device=args.device)
    device = env.device
    if args.load1:
        rc = load_one_rank(args, device)
        C.destroy_process_group()
        return rc
    rank, world = get_rank(), get_world_size()
    store = C._get_store()
    out = {"rank": rank, "world": world, "backend": env.backend,
           "device": str(device), "runs": {}}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    ref = None
    if dp_args is not None:            # the data-parallel job, first
        dp = port_dp_worker.run(dp_args, env, t_start, store_p2p)
        ref = {"digests": dp["runs"]["bucketed"]["digests"]}
        del dp
        _free(device)
    for run in args.runs.split(","):
        t0 = time.perf_counter()
        rec = train_run(run, args, device, rank, world, store,
                        ref if run in ("os", "os_g", "p_g_os", "load")
                        else None)
        rec["seconds"] = time.perf_counter() - t0
        if run == "dp":
            ref = rec
        if run == "load":
            saved = out["runs"]["os"]
            rec["regions_equal"] = rec["loaded_slots"] \
                == saved["saved_slots"] and rec["loaded_params"] \
                == saved["saved_params"]
            rec["next_step_equal"] = rec["digests"][-1] \
                == saved["digests"][-1]
            if not (rec["regions_equal"] and rec["next_step_equal"]):
                raise AssertionError(f"rank {rank}: the loaded p_g_os "
                                     f"state or its next step differs")
        if run == "gm_full":
            gm = out["runs"]["gm"]
            mx, med = _grad_rel(gm.pop("merged_grads"),
                                rec.pop("full_grads"))
            gm.update(grad_rel_max=mx, grad_rel_median=med,
                      grad_tol=GRAD_TOL)
            if mx > GRAD_TOL:
                raise AssertionError(f"gradient merge: {mx} > {GRAD_TOL}")
        for k in ("merged_grads", "full_grads"):
            if k in rec and run != "gm":
                rec.pop(k)
        out["runs"][run] = rec
        _free(device)
    out["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    atomic_json_dump(os.path.join(args.out, f"rank{rank}.json"),
                     {**out, "runs": {k: {kk: vv for kk, vv in v.items()
                                          if kk != "merged_grads"}
                                      for k, v in out["runs"].items()}})
    C.barrier()
    C.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
