"""The Megatron tensor-parallel layers over the mp process group.

Counterpart of ``paddle_tpu/distributed/fleet/meta_parallel.py:60-212``
with its names and signatures. The JAX layers hold the whole weight with
an ``"mp"`` partition spec and GSPMD inserts the collectives; here each
layer holds only this rank's slice of its weight, and the collectives are
explicit (``mp_ops``). The group is ``mp_group``, else fleet's
(``fleet.init(mp_degree=n)``), else none: with no group, or one of one
member, every layer is its serial version.

Weights keep Paddle's and JAX's ``(in, out)`` layout (``x @ W``), so a
JAX layer's full weight carries across by slicing alone
(``convert.params_from_jax_mp`` with :func:`mp_partition_specs`):

- ``ColumnParallelLinear``: W ``(in, out/n)`` split by output column,
  bias ``(out/n,)``; ``c_identity`` in front, and with ``gather_output``
  the columns all-gathered behind;
- ``RowParallelLinear``: W ``(in/n, out)`` split by input row, the
  partial products all-reduced, the bias (whole) added after; unless
  ``input_is_parallel``, the input is first split along its last axis;
- ``VocabParallelEmbedding``: the table ``(V/n, D)`` split by row, a
  masked lookup and an all-reduce;
- ``ParallelCrossEntropy``: per-token cross-entropy on logits split by
  class (the output of a ``ColumnParallelLinear(gather_output=False)``);
- ``ScatterOp``/``GatherOp``: this rank's slice of a tensor along
  ``axis`` and the concatenation back (Megatron's sequence-parallel
  pair); JAX states them as sharding constraints, which leave the
  global value as it is;
- ``mark_as_sequence_parallel_parameter`` and ``get_rng_state_tracker``:
  named seeds, and a ``rng_state(name)`` context under which the port's
  threefry draws (``paddle_tpu_torch.random.split_key``) take that
  stream, the previous one restored on exit (JAX's tracker: each entry
  starts again from the named seed's key).

Initial weights follow JAX's initializers on the global shape (Xavier
normal for the linears, N(0, 1) for the table, zero biases), drawn for
the local slice.

The pipeline part (JAX ``meta_parallel.py:214-516``): ``LayerDesc``,
``SharedLayerDesc`` and ``PipelineLayer``, which finds the model's
longest periodic trunk of structurally identical units
(``_layer_signature``, ``_find_periodic_trunk``), stacks the trunk's
parameters into ``(S, U, ...)`` leaves (``(S, V, U, ...)`` with
``num_virtual_pipeline_stages=V``) named as JAX names them, and runs
them through ``distributed.pipeline``'s schedules over fleet's pp
group. ``fleet.distributed_model`` splits it by stage: each rank keeps
its row of every leaf, the layers before the trunk (the prologue) on
the first stage and those after it (the epilogue) on the last; a
``SharedLayerDesc`` used on two stages lives on both, its gradient
summed between them after each backward (Paddle's shared-layer group).
The last stage's output is broadcast to every stage (JAX returns it
replicated). With no pp group the stacked trunk runs unit by unit in
global order."""
from __future__ import annotations

import contextlib
import math
import warnings

import torch
from torch import nn
from torch.func import functional_call

from ... import random as prandom
from ...device import resolve_device
from ..mesh import get_hybrid_communicate_group
from . import mp_ops
from .mp_ops import mp_degree

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy", "ScatterOp",
           "GatherOp", "mark_as_sequence_parallel_parameter",
           "get_rng_state_tracker", "mp_partition_specs", "LayerDesc",
           "SharedLayerDesc", "PipelineLayer"]


def _group(mp_group):
    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _split_size(total: int, n: int, what: str) -> int:
    if total % n:
        raise ValueError(f"{what}={total} does not split into mp degree {n}")
    return total // n


def _param(shape, std, device, dtype) -> nn.Parameter:
    p = nn.Parameter(torch.empty(shape, device=resolve_device(device),
                                 dtype=dtype or torch.float32))
    with torch.no_grad():
        if std:
            p.normal_(0.0, std)
        else:
            p.zero_()
    return p


class _MPLayer(nn.Module):
    # {parameter: its partition spec in the layer's (Paddle's) layout}
    _MP_SPECS: dict = {}

    def __init__(self, mp_group):
        super().__init__()
        self.mp_group = _group(mp_group)
        self.degree = mp_degree(self.mp_group)


class ColumnParallelLinear(_MPLayer):
    """W ``(in, out)`` split over mp by output column (JAX's
    ``P(None, "mp")``)."""
    _MP_SPECS = {"weight": (None, "mp"), "bias": ("mp",)}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        local = _split_size(out_features, self.degree, "out_features")
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = _param((in_features, local), std, device, dtype)
        self.bias = _param((local,), 0.0, device, dtype) if has_bias \
            else None

    def forward(self, x):
        out = torch.matmul(mp_ops.c_identity(x, self.mp_group), self.weight)
        if self.bias is not None:
            out = out + self.bias
        if self.gather_output:
            out = mp_ops.gather(out, self.mp_group, -1)
        return out


class RowParallelLinear(_MPLayer):
    """W ``(in, out)`` split over mp by input row (JAX's
    ``P("mp", None)``); the bias is whole on every rank."""
    _MP_SPECS = {"weight": ("mp", None), "bias": None}

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        local = _split_size(in_features, self.degree, "in_features")
        std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = _param((local, out_features), std, device, dtype)
        self.bias = _param((out_features,), 0.0, device, dtype) \
            if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = mp_ops.split(x, self.mp_group, -1)
        out = mp_ops.mp_allreduce(torch.matmul(x, self.weight),
                                  self.mp_group)
        if self.bias is not None:
            out = out + self.bias
        return out


class VocabParallelEmbedding(_MPLayer):
    """The ``(num_embeddings, embedding_dim)`` table split over mp by
    row (JAX's ``P("mp", None)``)."""
    _MP_SPECS = {"weight": ("mp", None)}

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        local = _split_size(num_embeddings, self.degree, "num_embeddings")
        self.weight = _param((local, embedding_dim), 1.0, device, dtype)

    def forward(self, x):
        return mp_ops.vocab_parallel_embedding(x, self.weight,
                                               self.mp_group)


class ParallelCrossEntropy(_MPLayer):
    """Per-token softmax cross-entropy (``reduction="none"``) of logits
    split over mp by class; tokens labelled ``ignore_index`` give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return mp_ops.parallel_cross_entropy(input, label, self.mp_group,
                                             self.ignore_index)


class ScatterOp:
    """This rank's slice of ``x`` along ``axis`` over the mp group (the
    gradient: the all-gather of the slices')."""

    @staticmethod
    def apply(x, axis=1):
        return mp_ops.split(x, _group(None), axis)


class GatherOp:
    """Every mp rank's slice concatenated along ``axis`` (the gradient:
    this rank's slice)."""

    @staticmethod
    def apply(x, axis=1):
        return mp_ops.gather(x, _group(None), axis)


def mark_as_sequence_parallel_parameter(param):
    param.sequence_parallel = True


def mp_partition_specs(model: nn.Module) -> dict:
    """``{parameter name: partition spec}`` of every parameter of
    ``model`` that a meta-parallel layer splits, in that layer's layout,
    beside the model's own ``partition_specs()`` where it has one."""
    out = dict(model.partition_specs()) \
        if hasattr(model, "partition_specs") else {}
    for mname, mod in model.named_modules():
        for pname, spec in getattr(mod, "_MP_SPECS", {}).items():
            if getattr(mod, pname, None) is not None:
                out[f"{mname}.{pname}" if mname else pname] = spec
    return out


class _RNGStateTracker:
    """Named seeds (JAX's tracker): ``add(name, seed)`` keeps the key of
    ``seed``; under ``rng_state(name)`` the port's draws take that key's
    stream, and the stream in use before comes back on exit. An unknown
    name leaves the draws as they are."""

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        self._states[name] = prandom.prng_key(seed)

    def rng_state(self, name="model-parallel-rng"):
        if name in self._states:
            return prandom.rng_context(self._states[name])
        return contextlib.nullcontext()


_RNG_TRACKER = _RNGStateTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER


# ---------------------------------------------------------------------------
# pipeline scaffolding
# ---------------------------------------------------------------------------

class LayerDesc:
    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedCall(nn.Module):
    """A ``SharedLayerDesc`` call site: every site reads the one shared
    layer. The first site owns (registers) it; later sites keep an
    unregistered reference. ``forward_func(shared_layer, x)`` runs at
    every site that declared one."""

    def __init__(self, shared_layer, forward_func=None, owns=False):
        super().__init__()
        if owns:
            self.shared = shared_layer
        object.__setattr__(self, "_shared", shared_layer)
        object.__setattr__(self, "_forward_func", forward_func)

    def forward(self, x):
        if self._forward_func is not None:
            return self._forward_func(self._shared, x)
        return self._shared(x)


class _Call(nn.Module):
    """A bare callable of the layer list (``F.relu``) as a module."""

    def __init__(self, fn):
        super().__init__()
        object.__setattr__(self, "_fn", fn)

    def forward(self, x):
        return self._fn(x)


def _layer_signature(layer):
    """Structural identity used to find the pipelinable trunk: two layers
    with equal signatures share one stage body. Includes scalar config
    attributes (Dropout(0.1) != Dropout(0.5)) and a bare callable's name
    (F.relu != F.gelu)."""
    if not isinstance(layer, nn.Module):
        return (getattr(layer, "__name__", type(layer).__name__),
                None, None, 0)
    params = tuple((n, tuple(p.shape), str(p.dtype))
                   for n, p in layer.named_parameters())
    config = tuple(sorted(
        (k, v) for k, v in vars(layer).items()
        if isinstance(v, (int, float, str, bool, type(None)))
        and not k.startswith("_")))
    bufs = tuple((n, tuple(b.shape)) for n, b in layer.named_buffers())
    return (type(layer).__name__, params, config, bufs)


def _find_periodic_trunk(sigs, min_units):
    """Longest contiguous periodic region of ``sigs``: (start, period,
    n_units) maximizing the covered length (ties: more units);
    n_units = 0 when no region has >= ``min_units`` units."""
    n = len(sigs)
    best = (0, 1, 0)
    for q in range(1, n // 2 + 1):
        i = 0
        while i + q <= n:
            k = 1
            while (i + (k + 1) * q <= n
                   and sigs[i + k * q:i + (k + 1) * q] == sigs[i:i + q]):
                k += 1
            if k >= 2:
                cov, best_cov = k * q, best[2] * best[1]
                if cov > best_cov or (cov == best_cov and k > best[2]):
                    best = (i, q, k)
                i += k * q
            else:
                i += 1
    return best if best[2] >= min_units else (0, 1, 0)


def _modules(items):
    return nn.ModuleList([l if isinstance(l, nn.Module) else _Call(l)
                          for l in items])


class PipelineLayer(nn.Module):
    """Stage-partitioned sequential model (module docstring). Built
    whole on every rank from the same seed; ``fleet.distributed_model``
    keeps a stage's part. ``num_microbatches`` (default S) microbatches
    go through the schedule; ``recompute_interval`` recomputes the
    trunk (each unit without a pp group, each stage's body per
    microbatch under one)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 num_microbatches=None, num_virtual_pipeline_stages=1,
                 **kwargs):
        super().__init__()
        self._descs = list(layers)
        self.loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self.num_microbatches = num_microbatches
        self._vpp = max(1, int(num_virtual_pipeline_stages or 1))
        self._recompute = bool(recompute_interval)
        self.pp_group = None        # set by fleet.distributed_model
        self._pp_shared = []        # (parameters, group) across stages
        built, shared = [], {}
        for d in self._descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name in shared:
                    built.append(_SharedCall(shared[d.layer_name],
                                             d.forward_func))
                else:
                    inst = d.build_layer()
                    shared[d.layer_name] = inst
                    built.append(
                        _SharedCall(inst, d.forward_func, owns=True)
                        if d.forward_func is not None else inst)
            elif isinstance(d, LayerDesc):
                built.append(d.build_layer())
            else:
                built.append(d)
        self._shared_layers = list(shared.values())
        n = len(built)
        per = max(1, n // self._num_stages)
        self._stage_of = [min(i // per, self._num_stages - 1)
                          for i in range(n)]
        for i, l in enumerate(built):
            if isinstance(l, nn.Module):
                for p in l.parameters():
                    p.pp_stage = self._stage_of[i]
        self._pipelined = False
        if self._num_stages > 1:
            self._try_build_trunk(built)
        if not self._pipelined:
            if self._num_stages > 1:
                warnings.warn(
                    "PipelineLayer: no periodic trunk of >= "
                    f"{self._num_stages} structurally identical units "
                    "found; falling back to sequential (un-pipelined) "
                    "execution. Stack identical blocks (LayerDesc of the "
                    "same class/shape) to enable the pipeline.",
                    stacklevel=2)
            self.run_function = _modules(built)

    # -- trunk construction -------------------------------------------------
    def _try_build_trunk(self, built):
        S, V = self._num_stages, self._vpp
        sigs = [_layer_signature(l) for l in built]
        start, q, k = _find_periodic_trunk(sigs, S)
        k_used = (k // (S * V)) * (S * V)
        if k_used < max(S * V, 2):
            return
        end = start + k_used * q
        # per-unit buffer state (BatchNorm's running statistics) cannot
        # be stacked: such a trunk stays unstacked
        for lay in built[start:end]:
            if isinstance(lay, nn.Module) and any(True for _ in
                                                  lay.buffers()):
                return
        protos = built[start:start + q]
        pindex = []
        for j in range(q):
            if not isinstance(protos[j], nn.Module):
                continue
            for pname, _ in protos[j].named_parameters():
                vals = [built[start + u * q + j].get_parameter(pname)
                        .detach() for u in range(k_used)]
                stacked = torch.stack(vals)
                if V > 1:
                    # stage s's chunk v is global chunk vS + s: (S, V, U)
                    U = k_used // (S * V)
                    leaf = stacked.reshape(V, S, U, *vals[0].shape
                                           ).transpose(0, 1)
                else:
                    leaf = stacked.reshape(S, k_used // S, *vals[0].shape)
                reg = f"trunk_{j}__{pname.replace('.', '__')}"
                self.register_parameter(reg, nn.Parameter(
                    leaf.contiguous()))
                pindex.append((j, pname, reg))
        if not pindex:
            return
        self.prologue = _modules(built[:start])
        self.epilogue = _modules(built[end:])
        object.__setattr__(self, "_protos", protos)
        self._pindex = pindex
        self._period = q
        self._units = k_used
        self._pipelined = True

    def get_stage_from_index(self, idx):
        return self._stage_of[idx]

    def partition_specs(self) -> dict:
        """The trunk leaves' split over the pp axis (dim 0, JAX's
        ``P("pp", ...)``); everything else is whole."""
        if not self._pipelined:
            return {}
        return {reg: ("pp",) for _, _, reg in self._pindex}

    # -- execution ----------------------------------------------------------
    def _unit_fwd(self, slices, h):
        """One trunk unit with its parameter values in the prototypes
        (``functional_call``; ``slices`` in ``_pindex`` order)."""
        i = 0
        for j, proto in enumerate(self._protos):
            if not isinstance(proto, nn.Module):
                h = proto(h)
                continue
            names = [pn for jj, pn, _ in self._pindex if jj == j]
            h = functional_call(proto, dict(zip(names,
                                                slices[i:i + len(names)])),
                                (h,))
            i += len(names)
        return h

    def _run_units(self, leaves, h, remat):
        for sl in zip(*(lf.unbind(0) for lf in leaves)):
            if remat:
                h = torch.utils.checkpoint.checkpoint(
                    self._unit_fwd, sl, h, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                h = self._unit_fwd(sl, h)
        return h

    def _leaves(self):
        return [self.get_parameter(reg) for _, _, reg in self._pindex]

    def _pp(self):
        from ..pipeline import pipeline_group
        g = self.pp_group or pipeline_group()
        if g is None or g.nranks == 1 or not self._pipelined:
            return None
        if g.nranks != self._num_stages:
            from ...utils.enforce import InvalidArgumentError
            raise InvalidArgumentError(
                f"PipelineLayer was built with num_stages="
                f"{self._num_stages} but the pp group has pp={g.nranks}",
                "re-build the model or the job so the degrees agree")
        if self.pp_group is None:
            raise RuntimeError(
                "PipelineLayer under a pp group of degree "
                f"{g.nranks}: split it by stage first "
                "(fleet.distributed_model(model))")
        return g

    def _forward(self, x, tail=None):
        """The forward; ``tail(out)`` runs on the last stage's output
        (the loss) before the broadcast to every stage."""
        if not self._pipelined:
            for fn in self.run_function:
                x = fn(x)
            return tail(x) if tail is not None else x
        g = self._pp()
        if g is None:
            for fn in self.prologue:
                x = fn(x)
            leaves = self._leaves()
            V = self._vpp
            flat = [(lf.transpose(0, 1) if V > 1 else lf)
                    .reshape(self._units, *lf.shape[3 if V > 1 else 2:])
                    for lf in leaves]
            x = self._run_units(flat, x, self._recompute)
            for fn in self.epilogue:
                x = fn(x)
            return tail(x) if tail is not None else x
        return self._forward_pp(x, g, tail)

    def _forward_pp(self, x, g, tail):
        from .. import pipeline as pl
        S, V = g.nranks, self._vpp
        first, last = g.rank == 0, g.rank == S - 1
        if first:
            for fn in self.prologue:
                x = fn(x)
        # the later stages build their buffers from the first's shape
        shape, dtype = pl.broadcast_meta(x if first else None, g, 0)
        local = [lf[0] for lf in self._leaves()]

        def stage_fn(params, h):
            return self._run_units(params, h, False)
        out = pl._schedule(
            stage_fn, local, x if first else None, group=g, V=V,
            num_microbatches=self.num_microbatches or S, shape=shape,
            dtype=dtype, device=local[0].device, remat=self._recompute,
            finish=(lambda: pl.sync_shared_gradients(self._pp_shared))
            if self._pp_shared else None)
        if last:
            out = pl.merge_microbatches(out)
            for fn in self.epilogue:
                out = fn(out)
            if tail is not None:
                out = tail(out)
        return pl.broadcast_from_last(out, g)

    def forward(self, x):
        return self._forward(x)

    def forward_loss(self, x, y, loss_fn):
        """``loss_fn(self(x), y)``, the loss computed on the last stage
        only and broadcast to every stage."""
        return self._forward(x, tail=lambda out: loss_fn(out, y))

    # -- the split by stage (fleet.distributed_model) -----------------------
    def split_for_pipeline(self, group):
        """Keep this stage's part (module docstring): the row of every
        trunk leaf, the prologue on the first stage, the epilogue on the
        last; a shared layer used on two stages lives on both, with a
        group of their ranks to sum its gradient over. Every rank of the
        job calls it (groups are made in one order)."""
        from .. import communication as C
        if not self._pipelined or group is None or group.nranks == 1:
            return {}
        S, s = group.nranks, group.rank
        if S != self._num_stages:
            from ...utils.enforce import InvalidArgumentError
            raise InvalidArgumentError(
                f"PipelineLayer was built with num_stages="
                f"{self._num_stages} but the pp group has pp={S}",
                "re-build the model or the job so the degrees agree")
        from ..mesh import spec_piece
        split = {}
        with torch.no_grad():
            for reg, spec in self.partition_specs().items():
                p = self.get_parameter(reg)
                split[reg] = (spec, tuple(p.shape))
                p.data = spec_piece(p.data, spec, s, S, "pp").clone()
        sections = {"prologue": 0, "epilogue": S - 1}
        users = {id(inst): set() for inst in self._shared_layers}
        for name, stage in sections.items():
            for site in getattr(self, name):
                inst = getattr(site, "_shared", site)
                if id(inst) in users:
                    users[id(inst)].add(stage)
        for name, stage in sections.items():
            if s != stage:
                setattr(self, name, nn.ModuleList())
        mine = {id(m) for m in self.modules()}
        for inst in self._shared_layers:
            stages = sorted(users[id(inst)])
            here = s in stages
            if here and id(inst) not in mine:
                for site in list(self.prologue) + list(self.epilogue):
                    if getattr(site, "_shared", None) is inst:
                        site.shared = inst       # now this stage owns it
                        break
            if len(stages) > 1:
                # every rank makes the group, in one order (ids agree)
                g = C.new_group([group.ranks[t] for t in stages])
                if here:
                    self._pp_shared.append((list(inst.parameters()), g))
        self.pp_group = group
        return split
