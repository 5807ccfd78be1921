"""HiCCL-style hierarchical collectives over mesh axes.

Counterpart of ``paddle_tpu/distributed/collectives/hierarchical.py``.
A collective spanning two mesh levels, e.g. ("dp", "mp") where "mp" is
the fast inner level, decomposes (arXiv:2408.05962):

    all-reduce      = reduce-scatter(inner) ; all-reduce(outer)
                      ; all-gather(inner)
    reduce-scatter  = reduce-scatter(outer) ; reduce-scatter(inner)
    all-gather      = all-gather(inner) ; all-gather(outer)

In-program primitives (``hier_*``) take the per-shard tensors as a list
in linear-index order over ``plan.axes`` (outer-major), each on its
shard's device, and return the list every shard holds afterwards. Each
value is computed on the device of the shard that owns it and copied to
the others, so the copies are exact and every shard holds the same
bits. Sums add in a fixed order: within an inner group in inner rank
order, then across groups in outer order (a flat plan: rank order). The
host-level :func:`all_reduce` / :func:`all_gather` /
:func:`reduce_scatter` at the bottom take stacked per-device
contributions and return the global result, as JAX's do."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..mesh import Mesh, axis_devices, get_current_mesh

Axes = Union[str, Sequence[str]]


def _norm_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class HierarchyPlan:
    """How one logical collective maps onto mesh levels (JAX's).

    ``axes`` is the full scope (mesh order, outer -> inner). ``inner``
    is the fastest level (one axis name) and ``outer`` the remaining
    axes, or both None for a flat plan. ``inner_size`` / ``total_size``
    are the device counts used for padding and chunking."""
    axes: Tuple[str, ...]
    outer: Optional[Tuple[str, ...]]
    inner: Optional[str]
    inner_size: int
    total_size: int

    @property
    def flat(self) -> bool:
        return self.inner is None

    @property
    def mode(self) -> str:
        return "flat" if self.flat else "hierarchical"


def plan_hierarchy(axes: Axes, mesh: Optional[Mesh] = None,
                   hierarchy: Optional[str] = None) -> HierarchyPlan:
    """Pick the decomposition for a collective over ``axes``: axes are
    re-ordered to mesh order and degree-1 axes dropped; when >= 2 remain
    and ``hierarchy`` resolves to "auto", the innermost becomes the fast
    level, otherwise the plan is flat. Without a mesh the plan is flat
    over ``axes`` as given, of total size 1 (JAX's)."""
    from . import collective_config
    if hierarchy is None:
        hierarchy = collective_config().hierarchy
    mesh = mesh if mesh is not None else get_current_mesh()
    names = _norm_axes(axes)
    if mesh is None:
        return HierarchyPlan(names, None, None, 1, 1)
    sizes = mesh.shape
    for a in names:
        if a not in sizes:
            raise ValueError(
                f"axis {a!r} not in mesh axes {tuple(sizes)}")
    order = {a: i for i, a in enumerate(mesh.axis_names)}
    names = tuple(sorted(dict.fromkeys(names), key=order.__getitem__))
    live = tuple(a for a in names if sizes[a] > 1)
    total = int(np.prod([sizes[a] for a in live])) if live else 1
    if hierarchy != "auto" or len(live) < 2:
        return HierarchyPlan(live or names[-1:], None, None, 1, total)
    return HierarchyPlan(live, live[:-1], live[-1], sizes[live[-1]],
                         total)


# --------------------------------------------------------------------------
# in-program primitives (one tensor per shard)
# --------------------------------------------------------------------------

def pad_to_multiple(flat: torch.Tensor, multiple: int):
    """Zero-pad a 1-D tensor so ``multiple`` divides it; returns
    (padded, pad). Shared with the int8 bucketing of
    :mod:`.quantized`."""
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def _check(xs, plan: HierarchyPlan):
    if len(xs) != plan.total_size:
        raise ValueError(f"{len(xs)} shards for a plan over {plan.axes} "
                         f"of {plan.total_size} devices")


def _sum(parts: List[torch.Tensor], device) -> torch.Tensor:
    """``parts`` added in list order on ``device``."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


def _per_device(xs, fn) -> List[torch.Tensor]:
    """One result per shard, ``fn(device)`` computed once per distinct
    device: shards that share a device share the (read-only) tensor."""
    memo = {}
    for x in xs:
        if x.device not in memo:
            memo[x.device] = fn(x.device)
    return [memo[x.device] for x in xs]


def _groups(xs, plan: HierarchyPlan):
    """Shards as (outer groups) x (inner ranks)."""
    n = plan.inner_size
    return [xs[g * n:(g + 1) * n] for g in range(len(xs) // n)]


def hier_all_reduce(xs: List[torch.Tensor],
                    plan: HierarchyPlan) -> List[torch.Tensor]:
    """All-reduce (sum) over ``plan.axes``. Flat: the rank-order sum.
    Hierarchical: the flattened payload, zero-padded so the inner level
    divides it, is reduce-scattered within each inner group, all-reduced
    across the groups, and all-gathered back within each group."""
    _check(xs, plan)
    if plan.flat:
        total = _sum(xs, xs[0].device)
        return [total.to(x.device) for x in xs]
    shape = xs[0].shape
    n_in = plan.inner_size
    flats = [pad_to_multiple(x.reshape(-1), n_in) for x in xs]
    pad = flats[0][1]
    chunks = [f.chunk(n_in) for f, _ in flats]
    groups = _groups(list(range(len(xs))), plan)
    # reduce-scatter(inner): rank (g, i) sums chunk i over its group
    part = {(g, i): _sum([chunks[r][i] for r in members],
                         xs[members[i]].device)
            for g, members in enumerate(groups) for i in range(n_in)}
    # all-reduce(outer): chunk i summed over the groups, on rank (0, i)
    tot = [_sum([part[g, i] for g in range(len(groups))],
                xs[groups[0][i]].device) for i in range(n_in)]

    def gathered(dev):
        full = torch.cat([t.to(dev) for t in tot])
        return full[:full.numel() - pad].reshape(shape)
    return _per_device(xs, gathered)


def hier_reduce_scatter(xs: List[torch.Tensor],
                        plan: HierarchyPlan) -> List[torch.Tensor]:
    """Reduce-scatter (sum) along dim 0: in (N, ...) per shard, out
    (N/total, ...), the chunk of the shard's linear index (outer-major,
    the flat collective's assignment). Hierarchical plans scatter over
    the outer level first, then the inner one."""
    _check(xs, plan)
    n = plan.total_size
    if xs[0].shape[0] % max(n, 1):
        raise ValueError(
            f"reduce_scatter dim 0 ({xs[0].shape[0]}) not divisible by "
            f"device count {n} over axes {plan.axes}")
    if plan.flat:
        return [_sum([x.chunk(n)[d] for x in xs], xs[d].device)
                for d in range(n)]
    n_in = plan.inner_size
    groups = _groups(list(range(n)), plan)
    n_out = len(groups)
    out = []
    for g in range(n_out):
        for i in range(n_in):
            d = g * n_in + i
            # outer scatter: chunk g summed over the groups at inner
            # rank j, then inner scatter: sub-chunk i summed over j
            outer = [_sum([xs[groups[h][j]].chunk(n_out)[g]
                           for h in range(n_out)], xs[d].device)
                     for j in range(n_in)]
            out.append(_sum([o.chunk(n_in)[i] for o in outer],
                            xs[d].device))
    return out


def hier_all_gather(xs: List[torch.Tensor],
                    plan: HierarchyPlan) -> List[torch.Tensor]:
    """All-gather along dim 0: in (M, ...) per shard, out (M * total,
    ...) on every shard, shards in linear-index order. Hierarchical
    plans gather within the inner level first, then across the outer
    one, which keeps that order. Pure data movement: exact."""
    _check(xs, plan)
    if plan.flat:
        return _per_device(xs, lambda dev: torch.cat([y.to(dev)
                                                      for y in xs]))
    groups = _groups(xs, plan)
    return _per_device(xs, lambda dev: torch.cat(
        [torch.cat([y.to(dev) for y in grp]) for grp in groups]))


# --------------------------------------------------------------------------
# host-level wrappers (stacked contributions in, global result out)
# --------------------------------------------------------------------------

def _resolve(axes, mesh, hierarchy):
    mesh = mesh if mesh is not None else get_current_mesh()
    if mesh is None:
        raise ValueError(
            "collectives need a mesh: pass mesh= or build one via "
            "HybridCommunicateGroup / build_device_mesh")
    if axes is None:
        axes = tuple(a for a, s in mesh.shape.items() if s > 1) \
            or (mesh.axis_names[-1],)
    return mesh, plan_hierarchy(axes, mesh, hierarchy)


def _split(x, mesh: Mesh, plan: HierarchyPlan, op: str):
    """Stacked (n, ...) contributions as one tensor per shard device."""
    v = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x
    if v.shape[0] != plan.total_size:
        raise ValueError(
            f"{op} expects stacked contributions with dim 0 == "
            f"{plan.total_size} (devices over {plan.axes}), got "
            f"{tuple(v.shape)}")
    return v, [v[d].to(dev) for d, dev in
               enumerate(axis_devices(mesh, plan.axes))]


_om = None        # observability.metrics, imported on first call


def _note_metrics(op: str, plan: HierarchyPlan, v: torch.Tensor,
                  int8: bool = False):
    """The ``pt_collectives_*`` families (JAX's): calls and payload
    bytes by op and plan mode, and for the int8 path the bound of this
    payload. No-ops until metrics are enabled."""
    global _om
    if _om is None:
        from ...observability import metrics as _om
    om = _om
    if not om.enabled():
        return
    mode = plan.mode + (",int8" if int8 else "")
    om.counter("pt_collectives_calls_total",
               "host-level collective dispatches",
               labels=("op", "mode")).inc(op=op, mode=mode)
    om.counter("pt_collectives_bytes_total",
               "payload bytes handed to collectives (stacked "
               "contributions; algorithmic wire bytes are the comms "
               "microbench's job)",
               labels=("op", "mode")).inc(v.numel() * v.element_size(),
                                          op=op, mode=mode)
    if int8:
        from .quantized import int8_error_bound
        absmax = float(v.abs().max())
        om.gauge("pt_collectives_int8_error_bound",
                 "worst-case |dequant - fp32| of the most recent int8 "
                 "all-reduce payload").set(
            float(int8_error_bound(absmax, plan.total_size)))


def _record(name):
    from ...profiler import RecordEvent
    return RecordEvent(name)


def all_reduce(x, axes: Optional[Axes] = None, mesh: Optional[Mesh] = None,
               compress: Optional[str] = "__config__",
               hierarchy: Optional[str] = None) -> torch.Tensor:
    """Sum stacked per-device contributions: ``x`` (n_devices, *shape),
    row d device d's term (linear index over ``axes``). Returns (*shape)
    on the first shard's device, the sum every device holds.
    ``compress="int8"`` routes through the quantized wire format
    (:mod:`.quantized`); the default follows the global config."""
    from . import collective_config
    cfg = collective_config()
    if compress == "__config__":
        compress = cfg.compress
    mesh, plan = _resolve(axes, mesh, hierarchy)
    v, xs = _split(x, mesh, plan, "all_reduce")
    int8 = compress == "int8"
    _note_metrics("all_reduce", plan, v, int8=int8)
    with _record(f"collectives::all_reduce[{plan.mode}"
                 f"{',int8' if int8 else ''}]"):
        if int8:
            from .quantized import quantized_all_reduce
            return quantized_all_reduce(xs, plan,
                                        cfg.quant_bucket_size)[0]
        return hier_all_reduce(xs, plan)[0]


def reduce_scatter(x, axes: Optional[Axes] = None,
                   mesh: Optional[Mesh] = None,
                   hierarchy: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter stacked contributions: ``x`` (n_devices, N, ...).
    Returns (n_devices, N/n, ...): row d is the reduced chunk device d
    holds afterwards (so callers can check placement)."""
    mesh, plan = _resolve(axes, mesh, hierarchy)
    v, xs = _split(x, mesh, plan, "reduce_scatter")
    _note_metrics("reduce_scatter", plan, v)
    with _record(f"collectives::reduce_scatter[{plan.mode}]"):
        out = hier_reduce_scatter(xs, plan)
    return torch.stack([o.to(out[0].device) for o in out])


def all_gather(x, axes: Optional[Axes] = None, mesh: Optional[Mesh] = None,
               hierarchy: Optional[str] = None) -> torch.Tensor:
    """All-gather stacked shards: ``x`` (n_devices, M, ...). Returns
    (n_devices * M, ...), the concatenation every device holds."""
    mesh, plan = _resolve(axes, mesh, hierarchy)
    v, xs = _split(x, mesh, plan, "all_gather")
    _note_metrics("all_gather", plan, v)
    with _record(f"collectives::all_gather[{plan.mode}]"):
        return hier_all_gather(xs, plan)[0]
