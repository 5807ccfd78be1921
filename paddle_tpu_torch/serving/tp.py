"""Tensor-parallel serving: the engines' programs sharded over a mesh.

Counterpart of ``paddle_tpu/serving/tp.py``. The slot-pool engines run
their decode block and prefill programs on one device, so the largest
servable model is one device's memory. This module shards the same
programs over a :class:`~paddle_tpu_torch.distributed.mesh.Mesh`:

- the KV cache shards its **kv-head axis** (dim 2 of the dense
  ``(S, max_len, kvh, d)`` pool, of the paged ``(num_blocks,
  block_size, kvh, d)`` arena and of the int8 arena's scales): each
  shard holds its own contiguous ``kvh / degree`` heads, so the paged
  kernels read a dense layout;
- q/k/v, gate/up and lm_head are column-sharded (shard ``s`` holds q
  heads ``[s H/d, (s+1) H/d)`` and kv heads ``[s kvh/d, ...)``, so
  GQA's head map stays shard-local); the slot state is replicated.

Two weight layouts, ``TPConfig.mode``:

- ``"exact"`` (default): o_proj / down_proj / the embedding stay
  replicated and the column shards' activations are all-gathered in
  front of them. Every collective is a copy, so sharded greedy and
  seeded-sampled streams equal the one-device engine's;
- ``"psum"``: o_proj / down_proj are row-sharded and the hidden state
  is all-reduced after each, optionally over the int8 wire format
  (``TPConfig.int8``, ``distributed.collectives.quantized``) whose
  runtime bound :meth:`engine.tp_int8_error_bound` reports and
  ``TPConfig.int8_max_error`` gates. Sums reassociate: not bit-exact.

The JAX package runs a ``shard_map`` program: every device runs the
model's forward and blocks at the collectives. The port has one
controller: :class:`ShardedModel` holds one copy of the model's module
tree per shard (the slices of the sharded weights, dim-0 slices of
``(out, in)`` weights being views; replicated weights shared by shards
on one device) and runs the model's own cache-path forward, a generator
split at the hook sites (``models/llama.py``), once per shard in
lockstep; at each site the hook of ``utils.tp_hooks`` runs the
collective over the shards' tensors. Replicated work runs once per
shard, as in SPMD. On the card, when every mesh device is the same card,
each program is still ONE CUDA graph (its capture records every shard's
launches), so the capture counts stay the unsharded engine's. Across
distinct cards each shard's work runs on a stream of its device forked
from and joined back into the capturing stream; that route is not
verified on hardware.

Everything is default-off: pass ``tp=TPConfig(...)`` (or ``tp=True``)
to ``ContinuousBatchingEngine`` / ``PagedEngine``, or set
``PT_SERVING_TP=1`` (``PT_SERVING_TP_AXES``, comma-separated, default
"mp"; ``PT_SERVING_TP_MODE``; ``PT_SERVING_TP_INT8``). An explicitly
passed backend is never rerouted by the env knobs. As in JAX, ``tp=``
is refused beside ``spec=``, ``megakernel=`` and ``Server(preemption=
True)``, and ``quant=`` composes only with the exact layout."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from .. import ops
from ..distributed.collectives.hierarchical import plan_hierarchy
from ..distributed.mesh import (Mesh, axis_devices, get_current_mesh,
                                spec_dim, spec_piece)
from ..observability import metrics as _om
from ..utils import tp_hooks
from ..utils.flags import env_bool, env_str
from ..utils.tp_hooks import (current_tp, maybe_gather,  # noqa: F401
                              maybe_gather_logits, maybe_reduce)
from .engine import ModelStepBackend, _serving_model
from .paging import PagedModelStepBackend
from .prefix_cache import KV_HEAD_AXIS
from .quant import _copy_tree, scale_pspec

__all__ = ["TPConfig", "resolve_tp_config", "ShardedLeaf", "ShardedModel",
           "ShardedModelStepBackend", "ShardedPagedStepBackend"]

_M_TP_DEVICES = _om.gauge(
    "pt_serving_tp_devices",
    "devices the serving decode block is sharded over (1 = TP off)")
_M_TP_AXIS = _om.gauge(
    "pt_serving_tp_mesh_axis_size",
    "mesh axis sizes of the serving TP mesh", labels=("axis",))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPConfig:
    """How to shard the serving programs (JAX's fields and checks).

    ``axes``: mesh axis names the weights and KV heads split over (the
    collective plan follows their mesh order; degree-1 axes drop).
    ``mode``: ``"exact"`` | ``"psum"``. ``int8``: compress the psum
    hidden-state all-reduce; ``int8_max_error`` arms the runtime gate on
    its bound. ``mesh``: default the current mesh
    (``distributed.mesh.get_current_mesh``)."""
    axes: Tuple[str, ...] = ("mp",)
    mode: str = "exact"
    int8: bool = False
    int8_max_error: Optional[float] = None
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.mode not in ("exact", "psum"):
            raise ValueError(f"TPConfig.mode={self.mode!r}; expected "
                             "'exact' or 'psum'")
        if self.int8 and self.mode != "psum":
            raise ValueError(
                "TPConfig.int8 compresses the hidden-state all-reduce, "
                "which only exists in mode='psum' (exact mode has no "
                "reduction to compress)")
        if isinstance(self.axes, str):
            object.__setattr__(self, "axes", (self.axes,))
        else:
            object.__setattr__(self, "axes", tuple(self.axes))


def resolve_tp_config(tp) -> Optional[TPConfig]:
    """The engine's ``tp`` argument: a TPConfig passes through, ``True``
    gives the defaults, ``False`` is off, ``None`` reads the
    ``PT_SERVING_TP`` knobs."""
    if isinstance(tp, TPConfig):
        return tp
    if tp is True:
        return TPConfig()
    if tp is False:
        return None
    if tp is not None:
        raise ValueError(f"tp={tp!r}: pass a TPConfig, True/False, or "
                         "None (env-controlled)")
    if not env_bool("PT_SERVING_TP"):
        return None
    axes = tuple(a.strip() for a in
                 env_str("PT_SERVING_TP_AXES", "mp").split(",")
                 if a.strip())
    return TPConfig(axes=axes or ("mp",),
                    mode=env_str("PT_SERVING_TP_MODE", "exact"),
                    int8=env_bool("PT_SERVING_TP_INT8"))


def _param_pspec(name: str, sharding_spec, mode: str,
                 axes: Tuple[str, ...]) -> tuple:
    """The serving split of one parameter from the model's
    ``partition_specs()`` entry (JAX's rules, in the port's ``(out,
    in)`` layout): out-dim (column, dim 0) shards stay sharded in both
    modes; in-dim (row, dim 1: o_proj, down_proj) shards replicate in
    exact mode and stay row-sharded in psum mode; the embedding table
    always replicates. Returns the spec with ``axes`` at the sharded
    dim, or ``()`` for a replicated parameter."""
    if sharding_spec is None:
        return ()
    dims = tuple(sharding_spec)
    idx = [i for i, d in enumerate(dims)
           if d == "mp" or (isinstance(d, (tuple, list)) and "mp" in d)]
    if not idx or "embed_tokens" in name or "embedding" in name:
        return ()
    i = idx[0]
    if mode == "exact" and i == 1:
        return ()                     # row-parallel weight: replicate
    return tuple(axes if j == i else None for j in range(len(dims)))


# ---------------------------------------------------------------------------
# the global view of a sharded KV leaf
# ---------------------------------------------------------------------------

class ShardedLeaf:
    """One KV cache leaf (a pool or arena tensor, or the int8 arena's
    scales) held as one contiguous tensor per shard, split on ``axis``
    (the kv-head axis), presented with the global leaf's shape and dtype:
    the port's counterpart of a JAX array sharded on a mesh. It takes the
    in-place operations the engines run on cache leaves (``zero_``,
    ``fill_``, ``copy_``, ``index_fill_``, ``index_copy_``, indexing the
    leading dims) shard by shard, and reads (``index_select``, ``max``,
    ``detach``) return global tensors on the first shard's device, so a
    snapshot or a payload holds the global arena."""

    def __init__(self, shards: List[torch.Tensor], axis: int = KV_HEAD_AXIS):
        self.shards = list(shards)
        self.axis = axis

    # -- the global tensor's metadata --------------------------------------
    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        s[self.axis] = sum(t.shape[self.axis] for t in self.shards)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def numel(self) -> int:
        return sum(t.numel() for t in self.shards)

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def is_floating_point(self) -> bool:
        return self.shards[0].is_floating_point()

    def shard_bytes(self) -> List[int]:
        return [t.numel() * t.element_size() for t in self.shards]

    # -- shard-wise views and writes ---------------------------------------
    def __getitem__(self, idx) -> "ShardedLeaf":
        idx = idx if isinstance(idx, tuple) else (idx,)
        if len(idx) > self.axis or not all(isinstance(i, (int, slice))
                                           for i in idx):
            raise IndexError(f"a sharded leaf is indexed by ints and "
                             f"slices on the dims before {self.axis}")
        dropped = sum(isinstance(i, int) for i in idx)
        return ShardedLeaf([t[idx] for t in self.shards],
                           self.axis - dropped)

    def view(self, dtype) -> "ShardedLeaf":
        return ShardedLeaf([t.view(dtype) for t in self.shards], self.axis)

    def _split(self, src: torch.Tensor):
        sizes = [t.shape[self.axis] for t in self.shards]
        return [p.to(t.device) for p, t in
                zip(torch.split(src, sizes, dim=self.axis), self.shards)]

    def zero_(self):
        for t in self.shards:
            t.zero_()
        return self

    def fill_(self, value):
        for t in self.shards:
            t.fill_(value)
        return self

    def copy_(self, src):
        if isinstance(src, ShardedLeaf):
            for t, p in zip(self.shards, src.shards):
                t.copy_(p)
        else:
            for t, p in zip(self.shards, self._split(src)):
                t.copy_(p)
        return self

    def index_fill_(self, dim: int, index: torch.Tensor, value):
        for t in self.shards:
            t.index_fill_(dim, index.to(t.device), value)
        return self

    def index_copy_(self, dim: int, index: torch.Tensor,
                    src: torch.Tensor):
        for t, p in zip(self.shards, self._split(src)):
            t.index_copy_(dim, index.to(t.device), p)
        return self

    # -- global reads --------------------------------------------------------
    def _cat(self, parts) -> torch.Tensor:
        dev = self.device
        return torch.cat([p.to(dev) for p in parts], dim=self.axis)

    def index_select(self, dim: int, index: torch.Tensor) -> torch.Tensor:
        return self._cat([t.index_select(dim, index.to(t.device))
                          for t in self.shards])

    def detach(self) -> torch.Tensor:
        """The global tensor (the shards concatenated on ``axis``, a
        copy): what a snapshot writes."""
        return self._cat([t.detach() for t in self.shards])

    clone = detach

    def max(self) -> torch.Tensor:
        return torch.stack([t.max().to(self.device) for t in self.shards]
                           ).max()


# ---------------------------------------------------------------------------
# the sharded model
# ---------------------------------------------------------------------------

class ShardedModel:
    """The serving model split over ``devices`` (one per shard, mesh
    linear-index order): :attr:`shards` holds one copy of the model's
    module tree per shard, whose parameters are that shard's slices
    (``specs``: :func:`_param_pspec` of each parameter) on its device.
    Called as the model is on the cache path, it runs
    ``LlamaForCausalLM._phases`` once per shard in lockstep
    (``tp_hooks.run_shards``) with ``spec`` active and returns the
    logits the first shard holds, on the model's device. Its KV caches
    are :class:`ShardedLeaf` leaves."""

    def __init__(self, model: nn.Module, specs: dict, devices: list,
                 spec: tp_hooks.TPSpec):
        self.config = model.config
        self.device = model.device
        self.devices = [torch.device(d) for d in devices]
        self.degree = d = len(devices)
        self.spec = spec
        self._streams = {}
        replicas = {}

        # a serving spec (``_param_pspec``) splits one dimension, over
        # the plan's axes: any named axis is that dimension
        def piece(t: torch.Tensor, pspec, s: int, dev) -> torch.Tensor:
            if spec_dim(pspec, None) is None:
                key = (id(t), dev)
                if key not in replicas:
                    replicas[key] = t.detach().to(dev)
                return replicas[key]
            part = spec_piece(t.detach(), pspec, s, d, None)
            # a dim-0 slice of a contiguous tensor is a contiguous view;
            # a row-parallel (dim 1) slice is copied once
            return part.contiguous().to(dev)

        self.shards = []
        for s, dev in enumerate(self.devices):
            tree = _copy_tree(model)
            for mname, mod in tree.named_modules():
                prefix = f"{mname}." if mname else ""
                for pname, p in list(mod._parameters.items()):
                    if p is None:
                        continue
                    pspec = specs.get(prefix + pname, ())
                    mod._parameters[pname] = nn.Parameter(
                        piece(p, pspec, s, dev), requires_grad=False)
                    if pspec and isinstance(mod, nn.Linear):
                        mod.out_features, mod.in_features = \
                            mod.weight.shape
                wspec = specs.get(prefix + "weight", ())
                for bname, b in list(mod._buffers.items()):
                    if b is None:
                        continue
                    bspec = ()
                    if bname == "codes":
                        bspec = wspec
                    elif bname == "scales":
                        bspec = scale_pspec(wspec, b)
                    mod._buffers[bname] = piece(b, bspec, s, dev)
                if "codes" in mod._buffers and wspec:
                    mod.out_features = mod._buffers["codes"].shape[0]
            self.shards.append(tree)

    # -- model surface the backends read -----------------------------------
    def parameters(self):
        for m in self.shards:
            yield from m.parameters()

    def buffers(self):
        for m in self.shards:
            yield from m.buffers()

    def _kv_leaf(self, shape, dtype) -> ShardedLeaf:
        local = list(shape)
        local[KV_HEAD_AXIS] //= self.degree
        return ShardedLeaf([torch.zeros(local, dtype=dtype, device=dev)
                            for dev in self.devices])

    def _dtype(self):
        return self.shards[0].llama.embed_tokens.weight.dtype

    def init_kv_cache(self, batch: int, max_len: int, dtype=None):
        """The dense pool (the model's ``init_kv_cache`` layout), each
        leaf a :class:`ShardedLeaf`."""
        c = self.config
        shape = (batch, max_len, c.num_key_value_heads, c.head_dim)
        dt = dtype or self._dtype()
        return [(self._kv_leaf(shape, dt), self._kv_leaf(shape, dt))
                for _ in range(c.num_hidden_layers)]

    def init_paged_kv_cache(self, num_blocks: int, block_size: int,
                            kv_int8: bool = False, dtype=None):
        """The paged arena (the model's ``init_paged_kv_cache`` layout:
        (k, v), or int8 (k, v) codes plus fp32 (k, v) scales), each leaf
        a :class:`ShardedLeaf`."""
        c = self.config
        shape = (num_blocks, block_size, c.num_key_value_heads, c.head_dim)
        if kv_int8:
            return [(self._kv_leaf(shape, torch.int8),
                     self._kv_leaf(shape, torch.int8),
                     self._kv_leaf(shape[:-1], torch.float32),
                     self._kv_leaf(shape[:-1], torch.float32))
                    for _ in range(c.num_hidden_layers)]
        dt = dtype or self._dtype()
        return [(self._kv_leaf(shape, dt), self._kv_leaf(shape, dt))
                for _ in range(c.num_hidden_layers)]

    # -- the sharded forward -------------------------------------------------
    def _on_shard(self, s: int):
        """The context shard ``s``'s work runs under: nothing on the
        controller's device or the CPU; on another card, a stream of that
        card forked from the current stream and joined back into it, so
        a capture records every card's work."""
        dev = self.devices[s]
        if dev == self.device or dev.type != "cuda":
            return contextlib.nullcontext()
        return _ForkedStream(self._streams, self.device, dev)

    def __call__(self, input_ids, cache, pos=None, block_table=None,
                 fused_decode=None, pad=None):
        # ``fused_decode`` is None: the sharded backends never fuse

        def to(x, dev):
            return x.to(dev) if isinstance(x, torch.Tensor) else x

        gens = []
        for s, (m, dev) in enumerate(zip(self.shards, self.devices)):
            with self._on_shard(s):
                local = [tuple(leaf.shards[s] for leaf in layer)
                         for layer in cache]
                gens.append(m._phases(to(input_ids, dev), local,
                                      to(pos, dev), to(block_table, dev),
                                      None, to(pad, dev)))
        with tp_hooks.active(self.spec):
            outs = tp_hooks.run_shards(gens, self._on_shard)
        return outs[0].to(self.device)


class _ForkedStream:
    """Run on ``dev``'s side stream, forked from and joined back into the
    current stream of ``home`` (a capture on ``home`` then records the
    side stream's work)."""

    def __init__(self, streams: dict, home, dev):
        if dev not in streams:
            streams[dev] = torch.cuda.Stream(dev)
        self.side = streams[dev]
        self.home = torch.cuda.current_stream(home)
        self.ctx = torch.cuda.stream(self.side)

    def __enter__(self):
        self.side.wait_stream(self.home)
        self.ctx.__enter__()

    def __exit__(self, *exc):
        self.ctx.__exit__(*exc)
        self.home.wait_stream(self.side)
        return False


# ---------------------------------------------------------------------------
# backend mixin
# ---------------------------------------------------------------------------

class _TPBackendMixin:
    """The tensor-parallel set-up shared by the dense and paged sharded
    backends: validation (JAX's ``_setup_tp``), the sharded serving
    model, the int8 bound probe and gate, and the collective
    accounting."""

    def _setup_tp(self, model, tp: TPConfig, quant):
        mesh = tp.mesh if tp.mesh is not None else get_current_mesh()
        if mesh is None:
            raise ValueError(
                "tensor-parallel serving needs a mesh: build one via "
                "HybridCommunicateGroup/build_device_mesh (sets the "
                "current mesh) or pass TPConfig(mesh=...)")
        sizes = mesh.shape
        for a in tp.axes:
            if a not in sizes:
                raise ValueError(f"TP axis {a!r} not in mesh axes "
                                 f"{tuple(sizes)}")
        plan = plan_hierarchy(tp.axes, mesh)
        if plan.total_size < 2:
            raise ValueError(
                f"TP axes {tp.axes} have total degree "
                f"{plan.total_size} on this mesh — nothing to shard "
                "(drop tp= or grow the mesh)")
        self.tp = tp
        self.tp_mesh = mesh
        self.tp_plan = plan
        self.tp_degree = d = plan.total_size
        self._tp_spec = tp_hooks.TPSpec(plan=plan, degree=d, mode=tp.mode,
                                        int8=tp.int8)
        table = model.partition_specs() \
            if hasattr(model, "partition_specs") else {}
        named = dict(model.named_parameters())
        specs = {n: _param_pspec(n, table.get(n), tp.mode, plan.axes)
                 for n in named}
        sharded = [(n, s) for n, s in specs.items() if s]
        if not sharded:
            raise ValueError(
                f"{type(model).__name__} carries no 'mp' partition "
                "specs — build it with tensor_parallel=True before "
                "sharding the serving programs")
        for n, s in sharded:
            dim = spec_dim(s, None)
            if named[n].shape[dim] % d:
                raise ValueError(
                    f"parameter {n} dim {dim} ({named[n].shape[dim]}) "
                    f"is not divisible by the TP degree {d}")
        cfg = getattr(model, "config", None)
        for attr in ("num_attention_heads", "num_key_value_heads"):
            hv = getattr(cfg, attr, None)
            if hv is not None and hv % d:
                raise ValueError(
                    f"{attr}={hv} not divisible by TP degree {d} — "
                    "head-axis sharding needs whole heads per device")
        if quant is not None and tp.mode != "exact":
            raise NotImplementedError(
                "weight-only serving quant composes with tp "
                "mode='exact' only — row-parallel (psum) shards split "
                "the quantized in dim; drop quant= or use mode='exact'")
        qmodel, bound = _serving_model(model, quant)
        devices = axis_devices(mesh, plan.axes)
        self._tp_model = ShardedModel(qmodel, specs, devices,
                                      self._tp_spec)
        self._tp_bound = bound
        self._int8_gate_pending = tp.int8 and \
            tp.int8_max_error is not None
        self._note_mesh_metrics()
        self._setup_collective_accounting(model)

    def _serving_copy(self, model, quant):
        """The model the programs run: the sharded one."""
        return self._tp_model, self._tp_bound

    def shard_kv_bytes(self) -> List[int]:
        """Device bytes of KV cache each shard holds."""
        per = [0] * self.tp_degree
        for t in self.caches():
            for s, b in enumerate(t.shard_bytes()):
                per[s] += b
        return per

    # -- observability -----------------------------------------------------
    def _note_mesh_metrics(self):
        if not _om.enabled():
            return
        _M_TP_DEVICES.set(self.tp_degree)
        sizes = self.tp_mesh.shape
        for a in self.tp_plan.axes:
            _M_TP_AXIS.set(sizes[a], axis=a)

    def _setup_collective_accounting(self, model):
        """Static per-token collective payloads (JAX's): each dispatch
        runs 2L + 1 collectives whatever its token count; exact mode
        moves L head gathers (h), L activation gathers (ff) and the
        logits gather (V) a token in fp32, psum mode 2L hidden-state
        all-reduces (h; ~1.03 B an element over int8) and the logits
        gather."""
        cfg = getattr(model, "config", None)
        self._tp_bytes_tok = 0
        self._tp_calls_dispatch = 0
        if cfg is None:
            return
        h, ff = cfg.hidden_size, cfg.intermediate_size
        V, L = cfg.vocab_size, cfg.num_hidden_layers
        if self.tp.mode == "exact":
            self._tp_bytes_tok = 4 * (L * (h + ff) + V)
        else:
            per_el = 1.03 if self.tp.int8 else 4
            self._tp_bytes_tok = int(2 * L * h * per_el + 4 * V)
        self._tp_calls_dispatch = 2 * L + 1

    def collective_accounting(self) -> dict:
        """``{"calls_per_dispatch": 2L + 1, "bytes_per_token": ...}``."""
        return {"calls_per_dispatch": self._tp_calls_dispatch,
                "bytes_per_token": self._tp_bytes_tok}

    def _note_collectives(self, op: str, dispatches: int, tokens: int):
        if not _om.enabled() or not self._tp_calls_dispatch:
            return
        mode = "tp_graph" + (",int8" if self.tp.int8 else "")
        _om.counter("pt_collectives_calls_total",
                    "host-level collective dispatches",
                    labels=("op", "mode")).inc(
            self._tp_calls_dispatch * dispatches, op=op, mode=mode)
        _om.counter("pt_collectives_bytes_total",
                    "payload bytes handed to collectives",
                    labels=("op", "mode")).inc(
            self._tp_bytes_tok * tokens, op=op, mode=mode)
        self._note_mesh_metrics()

    # -- int8 bound probe and gate -----------------------------------------
    def tp_int8_error_bound(self) -> float:
        """Runtime worst-case elementwise |int8 all-reduce - fp32| over
        one decode step's hidden-state hops from the LIVE cache and slot
        state (0.0 when the int8 hop is off). The probe is one eager
        decode step of its own, outside the captured programs (their
        capture counts stay 1), with the bound sink armed; it writes the
        K/V the next decode step writes (the same tokens at the same
        positions), and its kernel launches are taken back from the
        counts, as a capture's warm-up's are."""
        if not self.tp.int8:
            return 0.0
        st = self.state
        if "table" in st:
            aux = dict(block_table=torch.where(st["live"][:, None],
                                               st["table"], 0))
        else:
            aux = dict(pad=st["pad"])
        from ..models.generation import decode_step_logprobs
        counts = ops.launch_counts()
        sink: list = []
        tp_hooks._BOUND_SINK = sink
        try:
            decode_step_logprobs(self.model, st["tok"][:, None], self.cache,
                                 st["pos"], **aux)
        finally:
            tp_hooks._BOUND_SINK = None
            after = ops.launch_counts()
            ops.add_launch_counts({k: counts[k] - after[k] for k in after})
        if not sink:
            return 0.0
        return float(torch.stack([b.to(self.device) for b in sink]).max())

    def _check_int8_gate(self):
        if not self._int8_gate_pending:
            return
        bound = self.tp_int8_error_bound()
        limit = self.tp.int8_max_error
        if bound > limit:
            # the gate stays ARMED: a caller that catches this and
            # drives the engine again is refused again
            raise RuntimeError(
                f"int8 hidden-state all-reduce error bound {bound:.3e} "
                f"exceeds TPConfig.int8_max_error={limit:.3e} — run "
                "fp32 (int8=False) or raise the budget")
        self._int8_gate_pending = False


# ---------------------------------------------------------------------------
# sharded backends
# ---------------------------------------------------------------------------

class ShardedModelStepBackend(_TPBackendMixin, ModelStepBackend):
    """The dense backend with its decode block and per-bucket prefills
    sharded over the TP mesh: the pool and the prefill row shard their
    kv heads. Exact-mode streams equal :class:`ModelStepBackend`'s."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, tp: TPConfig, quant=None,
                 decode: bool = True):
        self._setup_tp(model, tp, quant)
        super().__init__(model, num_slots, max_len, decode_block,
                         megakernel=False, quant=quant, decode=decode)

    def decode_block(self) -> torch.Tensor:
        self._check_int8_gate()
        out = super().decode_block()
        self._note_collectives("tp_block", self.block_size,
                               self.block_size * self.num_slots)
        return out

    def prefill(self, ids, pad, key, temperature, top_k, top_p):
        out = super().prefill(ids, pad, key, temperature, top_k, top_p)
        self._note_collectives("tp_prefill", 1, ids.shape[1])
        return out


class ShardedPagedStepBackend(_TPBackendMixin, PagedModelStepBackend):
    """The paged twin: the shared arena (fp32, or int8 codes and scales)
    shards its kv heads, the block tables stay in the replicated slot
    state, and the decode block and the ONE prefill chunk program run
    sharded. Exact-mode streams equal the one-device paged engine's."""

    def __init__(self, model, num_slots: int, max_len: int,
                 decode_block: int, block_size: int, num_blocks: int,
                 prefill_chunk: int, kv_int8: bool, tp: TPConfig,
                 quant=None, decode: bool = True):
        self._setup_tp(model, tp, quant)
        super().__init__(model, num_slots, max_len, decode_block,
                         block_size, num_blocks, prefill_chunk, kv_int8,
                         megakernel=False, quant=quant, decode=decode)

    def decode_block(self) -> torch.Tensor:
        self._check_int8_gate()
        out = super().decode_block()
        self._note_collectives("tp_block", self.block_size,
                               self.block_size * self.num_slots)
        return out

    def prefill_chunk(self, *args, **kw):
        out = super().prefill_chunk(*args, **kw)
        self._note_collectives("tp_prefill", 1, self.prefill_chunk_len)
        return out
