"""Group-sharded data parallelism (ZeRO stages 1, 2 and 3) over the
process group.

Counterpart of ``paddle_tpu/distributed/sharding/__init__.py``. The JAX
package shards over an axis of the current mesh (``"sharding"`` when its
degree is above 1, else ``"dp"``) and lets GSPMD place the slots. The
port keeps its mapping of JAX's SPMD data parallelism, one rank per
device over ``torch.distributed`` (``parallel``), so **the sharding axis
is the process group**: the world, the ``group=`` given, or fleet's
sharding (else data-parallel) group. At world size 1 nothing is sharded,
as in JAX without a mesh.

Each rank holds its region of every sharded tensor, chosen by JAX's
``_sharded_spec`` rule (:func:`sharded_dim`): the largest dimension the
degree divides (the first of equal ones), else none, and the tensor
stays whole on every rank. Rank r's region is the r-th of n equal pieces
along it, so a checkpoint's region table at degree n is JAX's
(:class:`ShardedTensor`).

The levels of :func:`group_sharded_parallel`, each a step that owns its
gradient reduction:

- ``"os"``: each rank's optimizer slots are its regions. The step
  mean-all-reduces the gradients bucket by bucket (the data-parallel
  sync, bit for bit), updates this rank's region of each parameter
  (AdamW's kernel on the region: a view where it is contiguous and
  aligned, else a contiguous copy) and all-gathers the parameters.
- ``"os_g"``: the step reduce-scatters the gradients instead (fp32
  buckets laid out rank-major, one ``reduce_scatter_tensor`` a bucket
  on the gloo or nccl route, an all-reduce on the store route); a rank
  keeps its gradient regions and the full gradients are freed.
- ``"p_g_os"``: the parameters rest as regions between steps
  (``p.data`` is empty). A forward pre-hook on the model all-gathers
  them, and the step releases them after the update. The model's
  ``state_dict()`` gives a :class:`ShardedTensor` for a parameter at
  rest, and ``load_state_dict`` takes one (or the full tensor).

``DataParallel.sync_gradients`` and ``fleet.utils.
fused_allreduce_gradients`` skip the parameters of a group-sharded
optimizer (a counted no-op: ``route_counts()["sync_gradients"]
["sharded_step"]``), so no gradient is reduced twice. The step is eager:
a gloo or store collective cannot sit in a captured CUDA graph."""
from __future__ import annotations

import collections
import os
import time
from typing import Optional

import torch

from .. import communication as C
from ..collectives.bucketing import IN_FLIGHT

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "ShardedTensor", "sharded_dim", "LEVELS"]

LEVELS = ("os", "os_g", "p_g_os")


def _group_size(group) -> int:
    return group.nranks if group is not None else C._world_size()


def _group_rank(group) -> int:
    return C._me(group)


def sharded_dim(shape, n: int) -> Optional[int]:
    """JAX's ``_sharded_spec`` rule: the largest dimension of ``shape``
    that ``n`` divides (the first of equal ones), or None when none does
    or ``n <= 1``."""
    if n <= 1 or len(shape) == 0:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -int(shape[i])):
        if int(shape[i]) % n == 0 and int(shape[i]) >= n:
            return i
    return None


def region(shape, dim: Optional[int], n: int, rank: int) -> list:
    """``[[start, stop], ...]`` of rank ``rank``'s piece: the whole
    tensor, but for the ``rank``-th of ``n`` pieces along ``dim``."""
    out = [[0, int(s)] for s in shape]
    if dim is not None:
        size = int(shape[dim]) // n
        out[dim] = [rank * size, (rank + 1) * size]
    return out


class ShardedTensor:
    """This rank's region of a tensor sharded over a process group, the
    port's counterpart of a ``jax.Array``'s addressable shard: ``shape``
    is the global shape, ``region`` this rank's ``[[start, stop], ...]``,
    ``local`` its values (a contiguous tensor of the region's shape).
    :meth:`full` all-gathers the global tensor over ``group`` (a
    collective: every member calls it). ``opt.state_dict()`` returns one
    for a sharded slot, a stage-3 model's ``state_dict()`` for a
    parameter at rest; ``distributed.save_state_dict`` writes the region
    and ``load_state_dict`` fills it from the saved pieces it
    overlaps. ``replica``: this rank's index among the ranks that hold
    the same region (an mp slice is held once a dp rank); only replica 0
    writes it."""

    def __init__(self, shape, local: torch.Tensor, region, group=None,
                 dim: Optional[int] = None, replica: int = 0):
        self.shape = tuple(int(s) for s in shape)
        self.local = local
        self.region = [[int(a), int(b)] for a, b in region]
        self.group = group
        self.dim = dim
        self.replica = replica

    @classmethod
    def shard(cls, full: torch.Tensor, group=None) -> "ShardedTensor":
        """This rank's region of ``full`` (a copy), by :func:`sharded_dim`
        over ``group``'s size."""
        n, r = _group_size(group), _group_rank(group)
        dim = sharded_dim(full.shape, n)
        reg = region(full.shape, dim, n, r)
        local = full if dim is None else \
            full.narrow(dim, reg[dim][0], reg[dim][1] - reg[dim][0])
        return cls(full.shape, local.detach().clone().contiguous(), reg,
                   group, dim)

    @property
    def dtype(self):
        return self.local.dtype

    def full(self) -> torch.Tensor:
        if self.dim is None:
            return self.local
        return _all_gather_cat(self.local.contiguous(), self.dim,
                               self.group)

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"region={self.region})")


def _start_gather(mine: torch.Tensor, group, n: int):
    """Start the all-gather of every member's 1-D ``mine`` (equal sizes):
    (task, the parts in group-rank order, filled once the task's
    ``wait()`` returns). The bytes travel as uint8 (gloo moves no int16,
    and a gather only copies)."""
    raw = mine.contiguous().view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    task = C._all_gather_flat(parts, raw, group)
    return task, [p.view(mine.dtype) for p in parts]


def _all_gather_flat(mine: torch.Tensor, group) -> list:
    task, parts = _start_gather(mine, group, _group_size(group))
    task.wait()
    return parts


def _all_gather_cat(local: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = _all_gather_flat(local.reshape(-1), group)
    return torch.cat([p.view(local.shape) for p in parts], dim)


def _sync_device(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _ZeroPlan:
    """The sharding of one optimizer's parameters over ``group`` at
    ``level`` (module docstring). ``stats`` adds up the step's parts
    since it was last cleared: seconds, bytes and the route of each
    collective, and AdamW's seconds (with ``timed`` every part ends in a
    device sync)."""

    def __init__(self, level, group, params, bucket_bytes):
        self.level = level
        self.group = group
        self.n, self.rank = _group_size(group), _group_rank(group)
        self.bucket_bytes = int(bucket_bytes)
        self.timed = False
        self._dim, self._shape = {}, {}
        self.rest = {}          # id(p) -> its region at rest (p_g_os)
        self._targets = {}      # id(p) -> the region a step updates
        self.stats = {}
        for p in params:
            self._dim[id(p)] = sharded_dim(p.shape, self.n)
            self._shape[id(p)] = tuple(p.shape)
            p._pt_zero = self

    # -- regions ------------------------------------------------------------
    def dim(self, p) -> Optional[int]:
        return self._dim.get(id(p))

    def shape(self, p) -> tuple:
        return self._shape[id(p)]

    def region(self, p) -> list:
        return region(self.shape(p), self.dim(p), self.n, self.rank)

    def narrow(self, p, t: torch.Tensor, rank: Optional[int] = None):
        """Rank ``rank``'s (default this rank's) region of ``t``, a
        tensor of p's global shape: a view."""
        d = self.dim(p)
        if d is None:
            return t
        size = self.shape(p)[d] // self.n
        return t.narrow(d, (self.rank if rank is None else rank) * size,
                        size)

    def local_param(self, p) -> torch.Tensor:
        """This rank's region of p's current value."""
        if id(p) in self.rest:
            return self.rest[id(p)]
        return self.narrow(p, p.data)

    def localize(self, p, value) -> torch.Tensor:
        """``value`` (a :class:`ShardedTensor` of this rank's region, the
        global tensor, or a region-shaped tensor) as p's region."""
        if isinstance(value, ShardedTensor):
            if value.region != self.region(p):
                raise ValueError(
                    f"a region {value.region} of a {value.shape} tensor "
                    f"for a parameter whose region here is "
                    f"{self.region(p)}: load the checkpoint with "
                    f"distributed.load_state_dict, which reshards")
            return value.local
        value = torch.as_tensor(value)
        if tuple(value.shape) == self.shape(p):
            return self.narrow(p, value)
        return value

    def sharded(self, params) -> list:
        return [p for p in params if self.dim(p) is not None]

    # -- the step -----------------------------------------------------------
    def _time(self, part, t0, dev, nbytes=0, route=None):
        if self.timed:
            _sync_device(dev)
        st = self.stats.setdefault(part, {"s": 0.0, "bytes": 0,
                                          "calls": 0})
        st["s"] += time.perf_counter() - t0
        st["bytes"] += int(nbytes)
        st["calls"] += 1
        if route is not None:
            st["route"] = route

    def sync(self, todo: dict, grads: dict) -> dict:
        """The step's gradient reduction over the group. ``os``: the mean
        all-reduce of the full gradients in place (DP's bucketed sync);
        otherwise each sharded gradient's mean region (the full one
        freed) and the others' full means."""
        from ..collectives.bucketing import allreduce_mean_, build_buckets
        if not grads:
            return grads
        dev = next(iter(grads.values())).device
        t0 = time.perf_counter()
        names = list(grads)
        whole = names if self.level == "os" else \
            [k for k in names if self.dim(todo[k]) is None]
        if whole:
            ts = [grads[k] for k in whole]
            allreduce_mean_(ts, self.group, self.bucket_bytes)
            self._time("all_reduce", t0, dev,
                       sum(4 * t.numel() for t in ts), C._route(self.group))
        if self.level == "os":
            return grads
        out = {k: grads[k] for k in whole}
        split = [k for k in names if k not in out]
        t0 = time.perf_counter()
        nbytes = 0
        pending = collections.deque()

        def finish():
            task, red, bucket = pending.popleft()
            task.wait()
            red /= self.n
            off = 0
            for k in bucket:
                g = grads[k]
                shape = [b - a for a, b in self.region(todo[k])]
                size = g.numel() // self.n
                out[k] = red[off:off + size].view(shape).to(g.dtype)
                off += size
                todo[k].grad = None       # the full gradient goes
                grads[k] = None

        for bucket in build_buckets(
                [(k, grads[k].numel() // self.n) for k in split],
                self.bucket_bytes):
            inp = torch.cat([
                self.narrow(todo[k], grads[k], r).reshape(-1).float()
                for r in range(self.n) for k in bucket])
            red = inp.new_empty(inp.numel() // self.n)
            pending.append((C._reduce_scatter_flat(red, inp, self.group),
                            red, bucket))
            nbytes += 4 * inp.numel()
            if len(pending) >= IN_FLIGHT:
                finish()
        while pending:
            finish()
        if split:
            route = C._route(self.group)
            self._time("reduce_scatter", t0, dev, nbytes,
                       f"reduce_scatter_tensor ({route})"
                       if route in ("gloo", "nccl")
                       else f"all_reduce, keep the region ({route})")
        return out

    def target(self, p) -> torch.Tensor:
        """The region of p that AdamW updates in place: the region at
        rest (``p_g_os``); else a view of ``p.data`` where it is
        contiguous and 16-byte aligned (what the kernel needs), or a
        contiguous copy, which the gather writes back."""
        if id(p) in self.rest:
            return self.rest[id(p)]
        view = self.narrow(p, p.data)
        if view.is_contiguous() and view.data_ptr() % 16 == 0:
            return view
        t = self._targets[id(p)] = view.contiguous()
        return t

    def apply(self, opt, p, g):
        """One parameter's update on this rank's region."""
        if self.level == "os":
            g = self.narrow(p, g)
        opt._apply(self.target(p), g, opt._ensure_slots(p),
                   opt._lr_tensor, opt._step_tensor)

    def finish(self, params, t0, dev):
        """After the updates: all-gather the updated regions into the
        full parameters (``os``, ``os_g``, and the unreleased ones of
        ``p_g_os``), or release the full parameters (``p_g_os``)."""
        self._time("adamw", t0, dev)
        params = self.sharded(params)
        t0 = time.perf_counter()
        full = [p for p in params if id(p) not in self.rest]
        nbytes = self._gather_into(
            full, lambda p: self._targets.get(id(p), self.narrow(p, p.data)))
        self._targets.clear()
        if full:
            self._time("all_gather", t0, dev, nbytes,
                       C._route(self.group))
        self.release([p for p in params if id(p) in self.rest])

    def release(self, params):
        """Free the full values of parameters at rest (``p_g_os``)."""
        for p in params:
            if id(p) in self.rest and p.data.numel():
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def gather(self, params):
        """All-gather the regions of the parameters at rest into full
        ``p.data`` (the stage-3 forward)."""
        todo = [p for p in params if id(p) in self.rest
                and p.data.numel() == 0 and self.dim(p) is not None]
        if not todo:
            return
        dev = todo[0].device
        t0 = time.perf_counter()
        for p in todo:
            p.data = torch.empty(self.shape(p), dtype=p.dtype,
                                 device=p.device)
        nbytes = self._gather_into(todo, lambda p: self.rest[id(p)])
        self._time("forward_all_gather", t0, dev, nbytes,
                   C._route(self.group))

    def _gather_into(self, params, mine) -> int:
        """Every member's region (``mine(p)``) of each of ``params`` into
        ``p.data``, one all-gather a bucket of one dtype (up to
        ``IN_FLIGHT`` in flight). Returns the bytes this rank
        contributed."""
        from ..collectives.bucketing import build_buckets
        nbytes = 0
        pending = collections.deque()

        def finish():
            task, parts, bps = pending.popleft()
            task.wait()
            for r, part in enumerate(parts):
                off = 0
                for p in bps:
                    dst = self.narrow(p, p.data, r)
                    size = dst.numel()
                    dst.copy_(part[off:off + size].view(dst.shape))
                    off += size

        by_dtype = {}
        for p in params:
            by_dtype.setdefault(p.dtype, []).append(p)
        for dtype, ps in by_dtype.items():
            esz = torch.empty((), dtype=dtype).element_size()
            idx = {id(p): p for p in ps}
            for bucket in build_buckets(
                    [(id(p), p.numel() // self.n) for p in ps],
                    self.bucket_bytes, elem_bytes=esz):
                bps = [idx[i] for i in bucket]
                flat = torch.cat([mine(p).reshape(-1) for p in bps])
                nbytes += flat.numel() * esz
                task, parts = _start_gather(flat, self.group, self.n)
                pending.append((task, parts, bps))
                if len(pending) >= IN_FLIGHT:
                    finish()
        while pending:
            finish()
        return nbytes

    def reduce_squares(self, todo: dict):
        """For the clips: ``{name: local sum of squares}`` -> the global
        sums, one all-reduce for every name whose gradient is a region
        (the others are whole on every rank)."""
        def fn(sq: dict) -> dict:
            names = [k for k in sq if self.level != "os"
                     and self.dim(todo[k]) is not None]
            if not names:
                return sq
            stacked = torch.stack([sq[k] for k in names])
            C.all_reduce(stacked, group=self.group)
            out = dict(sq)
            out.update(zip(names, stacked.unbind(0)))
            return out
        return fn

    def any_nonfinite(self, found: torch.Tensor) -> bool:
        """GradScaler's found-inf, reduced over the group (every rank
        skips the same steps)."""
        flag = found.to(torch.float32).reshape(1)
        C.all_reduce(flag, op=C.ReduceOp.MAX, group=self.group)
        return bool(flag.item() > 0)

    # -- stage 3 at rest ------------------------------------------------------
    def shard_at_rest(self, params):
        """Hold ``params``' regions and free their full values."""
        for p in self.sharded(params):
            if id(p) not in self.rest:
                self.rest[id(p)] = self.narrow(p, p.data).clone()
        self.release(params)


def _plan_of(p) -> Optional[_ZeroPlan]:
    return getattr(p, "_pt_zero", None)


def not_sharded(params) -> list:
    """``params`` without those of a group-sharded optimizer, whose step
    reduces their gradients; a call that leaves some out is counted
    (``route_counts()["sync_gradients"]["sharded_step"]``) and moves no
    bytes for them."""
    params = list(params)
    rest = [p for p in params if _plan_of(p) is None]
    if len(rest) < len(params):
        C._note("sync_gradients", "sharded_step")
    return rest


def _gather_hook(module, args):
    """Forward pre-hook of a stage-3 model: gather its parameters."""
    by_plan = {}
    for p in module.parameters():
        plan = _plan_of(p)
        if plan is not None and plan.rest:
            by_plan.setdefault(id(plan), (plan, []))[1].append(p)
    for plan, ps in by_plan.values():
        plan.gather(ps)


def _state_dict_hook(module, state_dict, prefix, local_metadata):
    """A parameter at rest is saved as its :class:`ShardedTensor`."""
    for name, p in module.named_parameters():
        plan = _plan_of(p)
        key = prefix + name
        if plan is not None and id(p) in plan.rest and key in state_dict:
            state_dict[key] = ShardedTensor(
                plan.shape(p), plan.rest[id(p)].detach().clone(),
                plan.region(p), plan.group, plan.dim(p))
    return state_dict


def _load_pre_hook(module, state_dict, prefix, local_metadata, strict,
                   missing_keys, unexpected_keys, error_msgs):
    """A parameter at rest loads its region (from a ShardedTensor or the
    full tensor) and is released, so the next forward gathers it."""
    for name, p in module.named_parameters():
        plan = _plan_of(p)
        key = prefix + name
        if plan is not None and id(p) in plan.rest and key in state_dict:
            with torch.no_grad():
                plan.rest[id(p)].copy_(plan.localize(p, state_dict[key]))
            plan.release([p])
            state_dict[key] = p.detach()


def mark_stage3(model: torch.nn.Module):
    """Make ``model`` gather its parameters at rest before each forward
    and save and load them as regions (idempotent). Which parameters
    rest is the optimizer's plan's business (``group_sharded_parallel``
    with ``"p_g_os"``)."""
    if getattr(model, "_pt_stage3", False):
        return model
    model.register_forward_pre_hook(_gather_hook)
    model._register_state_dict_hook(_state_dict_hook)
    model.register_load_state_dict_pre_hook(_load_pre_hook)
    model._pt_stage3 = True
    for p in model.parameters():
        p._pt_stage3 = True
    return model


def _pick_axis():
    """JAX's ``_pick_axis`` over fleet's degrees: ``"sharding"`` if its
    degree is above 1, else ``"dp"`` if that is, else ``"sharding"``."""
    from ..mesh import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return "sharding"
    if hcg.axis_size("sharding") > 1:
        return "sharding"
    if hcg.axis_size("dp") > 1:
        return "dp"
    return "sharding"


def _pick_group(axis):
    """Fleet's process group of ``axis`` where fleet made one, else the
    world (None)."""
    from ..mesh import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    groups = getattr(hcg, "_groups", None) or {}
    return groups.get(axis)


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """Apply ZeRO-style group sharding over ``group`` (module docstring);
    level is one of ``"os"``, ``"os_g"``, ``"p_g_os"``. Returns
    ``(model, optimizer, scaler)`` as JAX's; ``model`` may be None to
    attach only the optimizer's plan (fleet marks a stage-3 model in
    ``distributed_model``). Under ``"p_g_os"`` the parameters of the
    model given, or those fleet marked, rest as regions. With
    ``CollectiveConfig.bucketed_grad_sync`` on, the optimizer also gets
    the in-graph ``BucketedGradSync`` hook, as in JAX. The bucket size of
    the step's collectives is the collectives config's
    ``bucket_bytes``; the other keywords are accepted for the
    reference's signature."""
    if level not in LEVELS:
        raise ValueError(
            f"level must be one of os / os_g / p_g_os, got {level!r}")
    from ..collectives import attach_grad_sync, collective_config
    axis = _pick_axis()
    if group is None:
        group = _pick_group(axis)
    attach_grad_sync(optimizer, axes=(axis,))
    if _group_size(group) <= 1:
        return model, optimizer, scaler
    params = [p for p in optimizer._param_list if p.requires_grad]
    plan = _ZeroPlan(level, group, params, collective_config().bucket_bytes)
    optimizer._shard_plan = plan
    # slots made before the wrap become regions (JAX re-places them)
    for p in params:
        slots = optimizer._slots.get(id(p))
        if slots:
            optimizer._slots[id(p)] = {
                k: plan.narrow(p, v).clone().contiguous()
                for k, v in slots.items()}
    if level == "p_g_os":
        if model is not None:
            mark_stage3(model)
        plan.shard_at_rest([p for p in params
                            if getattr(p, "_pt_stage3", False)])
    return model, optimizer, scaler


def save_group_sharded_model(model, output: str, optimizer=None):
    """Gather the model's (and the optimizer's) state and write it whole
    on rank 0 of the job: ``output/model.pdparams`` (and
    ``model.pdopt``), ``torch.save`` files of full tensors. Every rank
    calls it (the gathers are collectives)."""
    def whole(sd):
        return {k: v.full() if isinstance(v, ShardedTensor) else v
                for k, v in sd.items()}
    params = whole(model.state_dict())
    opt = whole(optimizer.state_dict()) if optimizer is not None else None
    if C._my_rank() != 0:
        return
    from ..checkpoint import atomic_write
    os.makedirs(output, exist_ok=True)
    atomic_write(os.path.join(output, "model.pdparams"),
                 lambda f: torch.save(params, f))
    if opt is not None:
        atomic_write(os.path.join(output, "model.pdopt"),
                     lambda f: torch.save(opt, f))
