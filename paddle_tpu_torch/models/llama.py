"""Llama-2: the KV-cache path (serving and ``generate()``) and the
training forward.

Counterpart of ``paddle_tpu/models/llama.py``: the config (the serving
and training fields), the RoPE tables, and the attention / MLP / decoder
layer / model / causal-LM modules, on the cache path (a dense cache or
the paged arena, with per-row left-pad counts and the sliding window)
and on the no-cache path (training, with the fused head +
cross-entropy), where ``scan_layers`` (or ``pipeline_parallel``) runs
the stacked trunk with per-layer recompute. Under a pp process group
(``fleet.init(pp_degree=S)``, then ``fleet.distributed_model``) the
trunk is JAX's pipeline: each rank holds its stage's rows of the stacks
and runs them through ``distributed.pipeline``'s schedule (FThenB, or
the interleaved one at ``virtual_pp > 1``); the embedding runs on the
first stage and the final norm, the head and the loss on the last, on
the merged batch as in JAX, and the loss (or logits) is broadcast to
every stage. Under a sep process group (``fleet.init(sep_degree=S)``,
``sequence_parallel=True``) each rank passes the contiguous piece ``[r
s/S, (r+1) s/S)`` of every sequence (JAX's ``P(None, "sep")`` batch):
RoPE takes the piece's rows of the tables, attention exchanges K/V over
the group in the config's mode (``distributed.context_parallel``: the
ring, Ulysses, or the megatron gather), and the loss is the whole
sequence's mean over its valid tokens, the same on every rank.
RMSNorm, RoPE and flash attention run the CUDA kernels on the GPU; the
projections are ``nn.Linear`` (``torch.matmul``), as the JAX package
leaves them to XLA. Parameter
names match the JAX model's ``named_parameters()``, so
``convert.params_from_jax`` maps one onto the other."""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..incubate.nn import (fused_linear_cross_entropy,
                           parallel_fused_linear_cross_entropy)
from ..nn import RMSNorm
from ..nn import functional as PF
from ..ops import plain_active, plain_as
from ..ops.decode_layer import decode_layer, kernel_viable
from ..ops.fused import fused_rope
from ..utils import tp_hooks
from .generation import GenerationMixin, cached_attention

__all__ = ["LlamaConfig", "LlamaDecoderStack", "LlamaForCausalLM",
           "LlamaModel",
           "llama_tiny_config", "llama_7b_config"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # the mesh fields, with the JAX defaults and checks. tensor_parallel
    # gives the partition table that a sharded serving engine reads and
    # that fleet.distributed_model splits the model by over an mp process
    # group (partition_specs; inert without one, as in JAX without a
    # mesh); pipeline_parallel builds the stacked trunk, which
    # fleet.distributed_model splits by stage over a pp process group
    # (pp_num_microbatches through the schedule; virtual_pp chunks a
    # stage, stored (V, L/V, ...) as JAX stores them) and which runs as
    # one stage without one; sequence_parallel with
    # sequence_parallel_mode picks the attention of a model that
    # fleet.distributed_model hands a sep process group (ring, ulysses,
    # megatron: distributed.context_parallel; inert without one, as in
    # JAX without a "sep" mesh axis)
    tensor_parallel: bool = True
    sequence_parallel: bool = False
    sequence_parallel_mode: str = "megatron"
    pipeline_parallel: bool = False
    pp_num_microbatches: int = 4
    virtual_pp: int = 1
    scan_layers: bool = False           # the stacked trunk
    recompute: bool = False             # per-layer checkpointing (stack)
    # "full": keep each layer's input only; "selective": also the linear
    # products (JAX's dots_with_no_batch_dims_saveable)
    recompute_granularity: str = "full"
    # Mistral-class sliding-window causal attention (None = full causal)
    sliding_window: Optional[int] = None
    # chunked fused lm-head + CE on the labels path (the (tokens, vocab)
    # logits never exist)
    fused_head_ce: bool = True
    fused_head_ce_chunks: int = 16
    dtype: str = "float32"

    def __post_init__(self):
        if self.sequence_parallel_mode not in ("megatron", "ring",
                                               "ulysses"):
            raise ValueError(
                f"unknown sequence_parallel_mode="
                f"{self.sequence_parallel_mode!r}; expected 'megatron', "
                f"'ring', or 'ulysses'")
        if self.sliding_window is not None and self.sliding_window <= 0:
            raise ValueError(
                f"sliding_window={self.sliding_window}; expected a "
                "positive window size or None (disabled)")
        if self.sliding_window is not None and self.sequence_parallel \
                and self.sequence_parallel_mode in ("ring", "ulysses"):
            raise ValueError(
                "sliding_window is not yet supported with ring/ulysses "
                "context parallelism (the CP kernels compute full causal "
                "attention); use sequence_parallel_mode='megatron' or "
                "disable the window")
        if self.recompute_granularity not in ("full", "selective"):
            raise ValueError(
                f"recompute_granularity="
                f"{self.recompute_granularity!r}; expected 'full' or "
                "'selective'")
        if self.pipeline_parallel and \
                self.sequence_parallel_mode in ("ring", "ulysses"):
            raise ValueError(
                "ring/ulysses attention runs its own shard_map and cannot "
                "nest inside the pipeline's manual pp region; use "
                "sequence_parallel_mode='megatron' with pipeline_parallel")
        if self.virtual_pp < 1:
            raise ValueError(f"virtual_pp={self.virtual_pp}; must be >= 1")
        if self.virtual_pp > 1 and not self.pipeline_parallel:
            raise ValueError("virtual_pp > 1 requires pipeline_parallel")
        if self.virtual_pp > 1 and \
                self.num_hidden_layers % self.virtual_pp != 0:
            raise ValueError(
                f"num_hidden_layers={self.num_hidden_layers} not "
                f"divisible by virtual_pp={self.virtual_pp}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def _sep_mean(tok, labels, sep):
    """The mean of the per-token losses ``tok`` over the valid labels of
    every rank of the sep group: the sum and the count summed over the
    group (one all-reduce, in ``tok``'s dtype, its gradient unchanged), so
    every rank holds the whole sequence's loss."""
    from ..distributed.sep_ops import sep_allreduce
    valid = (labels.long() != -100).to(tok.dtype).sum()
    both = sep_allreduce(torch.stack([tok.sum(), valid]), sep)
    return both[0] / torch.clamp(both[1], min=1.0)


def llama_tiny_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=512, hidden_size=128, intermediate_size=384,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, max_position_embeddings=256)
    base.update(kw)
    return LlamaConfig(**base)


def llama_7b_config(**kw) -> LlamaConfig:
    """Llama-2-7B's published shape (the dataclass defaults)."""
    return LlamaConfig(**kw)


def _rope_cache(config: LlamaConfig, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(max_position_embeddings, head_dim) fp32 cos/sin tables, computed
    as the JAX package does (fp32 throughout)."""
    d = config.head_dim
    inv = 1.0 / (config.rope_theta ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=device) / d))
    t = torch.arange(config.max_position_embeddings, dtype=torch.float32,
                     device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _apply_rope(q, k, cos, sin):
    """q/k (b, s, h, d): neox rotate-half at the tables' first s rows
    (positions 0..s-1, or a sep rank's piece when the caller sliced the
    tables) through the fused RoPE op, with the tables cast to q's dtype
    (JAX ``_apply_rope``)."""
    s = q.shape[1]
    return fused_rope(q, k, cos[:s].to(q.dtype), sin[:s].to(q.dtype))


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.sliding_window = config.sliding_window
        self.head_dim = config.head_dim
        h = config.hidden_size
        # the full width of the heads in front of o_proj (a tensor-
        # parallel shard holds a slice of them: tp_hooks.maybe_gather)
        self.width = h
        kv = config.num_key_value_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, kv, **kw)
        self.v_proj = nn.Linear(h, kv, **kw)
        self.o_proj = nn.Linear(h, h, **kw)
        # the training attention of a sep process group (set by
        # fleet.distributed_model): sequence_parallel_mode's
        self.sp_mode = config.sequence_parallel_mode \
            if config.sequence_parallel else None
        self.sep_group = None

    def forward(self, x, cos, sin, cache=None, pos=None, block_table=None,
                pad=None):
        return self.o_proj(self._attend(x, cos, sin, cache, pos,
                                        block_table, pad))

    def _attend(self, x, cos, sin, cache=None, pos=None, block_table=None,
                pad=None):
        """Everything in front of o_proj: q/k/v, RoPE and the attention
        of this module's heads, (b, s, heads * head_dim). The head count
        comes from the projections' widths, so a tensor-parallel shard
        (``serving.tp``) runs its slice of the heads over its slice of
        the KV cache."""
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, -1, self.head_dim)
        k = self.k_proj(x).view(b, s, -1, self.head_dim)
        v = self.v_proj(x).view(b, s, -1, self.head_dim)
        if cache is None:
            # training: causal flash attention over the whole sequence,
            # or over the sep group's pieces of it
            q, k = _apply_rope(q, k, cos, sin)
            g = self.sep_group
            if g is not None and g.nranks > 1:
                from ..distributed.context_parallel import sep_attention
                out = sep_attention(self.sp_mode, q, k, v, g)
            else:
                out = PF.scaled_dot_product_attention(
                    q, k, v, is_causal=True,
                    sliding_window=self.sliding_window)
            return out.reshape(b, s, -1)
        # a dense (k, v) cache, (k, v) arenas, or int8 (k, v) codes +
        # (k, v) scales
        out = cached_attention(q, k, v, cache[0], cache[1], pos,
                               scale=1.0 / math.sqrt(self.head_dim),
                               cos=cos, sin=sin, block_table=block_table,
                               kv_scales=cache[2:] or None,
                               window=self.sliding_window, pad=pad)
        return out.reshape(b, s, -1)


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        self.width = ff         # the activation's full width, as above
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(h, ff, **kw)
        self.up_proj = nn.Linear(h, ff, **kw)
        self.down_proj = nn.Linear(ff, h, **kw)

    def forward(self, x):
        return self.down_proj(self._act(x))

    def _act(self, x):
        """The activation in front of down_proj (a tensor-parallel
        shard's columns of it)."""
        return F.silu(self.gate_proj(x)) * self.up_proj(x)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)
        # the mp process group of a model split for training
        # (fleet.distributed_model); None runs the layer whole
        self.mp_group = None

    def forward(self, x, cos, sin, cache=None, pos=None, block_table=None,
                fused_decode=None, pad=None):
        """The layer; with a ``FusedDecode`` request
        (``ops.decode_layer``) the slot-pool decode shape goes through
        the fused decode-layer call instead (:meth:`_fused_decode`)."""
        return tp_hooks.run_local(self._phases(x, cos, sin, cache, pos,
                                               block_table, pad,
                                               fused_decode))

    def _decode_forward(self, x, cos, sin, cache, pos, block_table,
                        pad=None):
        return tp_hooks.run_local(self._phases(x, cos, sin, cache, pos,
                                               block_table, pad))

    def _phases(self, x, cos, sin, cache, pos, block_table, pad=None,
                fused_decode=None):
        """The layer as a generator split at the tensor-parallel hook
        sites of the JAX layer (``paddle_tpu/models/llama.py`` 223-225
        and 236-238 in front of and behind o_proj, 284-285 around
        down_proj): each ``yield`` hands ``(hook, tensor, *args)`` to
        the loop that runs it and resumes with the hook's result
        (``utils.tp_hooks``: :func:`~paddle_tpu_torch.utils.tp_hooks
        .run_local` for one device, ``run_shards`` for a mesh). The
        training route of an mp split (``mp_group``) yields its own
        hooks: ``mp_allreduce`` behind o_proj and down_proj, and
        ``c_identity`` at one more site in front of each pair of
        column-split products. A call the fused decode layer takes
        (:meth:`_fusable`) returns its result without yielding: the
        megakernel is never sharded."""
        if fused_decode is not None and self._fusable(x, cache, pos,
                                                      block_table, pad):
            return self._fused_decode(x, cos, sin, cache, pos, block_table,
                                      fused_decode, pad)
        attn, mlp, mp = self.self_attn, self.mlp, self.mp_group
        n = self.input_layernorm(x)
        if mp is not None:
            n = yield tp_hooks.mp_copy_in, n, mp
        a = attn._attend(n, cos, sin, cache, pos, block_table, pad)
        a = yield tp_hooks.maybe_gather, a, attn.width
        o = yield self._reduce_site(attn.o_proj(a))
        h = x + o
        n = self.post_attention_layernorm(h)
        if mp is not None:
            n = yield tp_hooks.mp_copy_in, n, mp
        m = mlp._act(n)
        m = yield tp_hooks.maybe_gather, m, mlp.width
        d = yield self._reduce_site(mlp.down_proj(m))
        return h + d

    def _reduce_site(self, t):
        """The hook behind a row-split product: the training route's
        all-reduce over the mp group, else serving's."""
        if self.mp_group is not None:
            return tp_hooks.mp_reduce, t, self.mp_group
        return tp_hooks.maybe_reduce, t

    def _fusable(self, x, cache, pos, block_table, pad=None) -> bool:
        """Whether this call is the slot-pool decode shape the fused
        layer covers (the JAX ``_markable``): s == 1, per-row positions,
        no sliding window, and a block table (paged) or per-row pad
        counts (dense). Prefill chunks (s > 1) stay unfused."""
        return (cache is not None
                and (block_table is not None or pad is not None)
                and x.shape[1] == 1 and isinstance(pos, torch.Tensor)
                and pos.dim() == 1
                and self.self_attn.sliding_window is None)

    def _plain_linears(self) -> bool:
        """Whether the seven projections are ``nn.Linear``s (fp32 or
        bf16 weights the fused call can read), not weight-only codes."""
        a, m = self.self_attn, self.mlp
        return all(isinstance(p, nn.Linear)
                   for p in (a.q_proj, a.k_proj, a.v_proj, a.o_proj,
                             m.gate_proj, m.up_proj, m.down_proj))

    def _decode_layer_weights(self):
        """The fused call's weights in ``ops.decode_layer.WEIGHT_NAMES``
        order, as ``nn.Linear`` stores them (out, in)."""
        a, m = self.self_attn, self.mlp
        return (self.input_layernorm.weight, a.q_proj.weight,
                a.k_proj.weight, a.v_proj.weight, a.o_proj.weight,
                self.post_attention_layernorm.weight, m.gate_proj.weight,
                m.up_proj.weight, m.down_proj.weight)

    def _fused_decode(self, x, cos, sin, cache, pos, block_table, fused,
                      pad=None):
        """The fused decode-layer route (JAX ``_marked_decode`` and the
        call the fusion pass splices). A CUDA call the card's kernel
        takes launches the megakernel once (``kernel_calls`` counts it);
        any other (the CPU, the dense mode, which the kernel never takes,
        as ``kernel_viable`` refuses it in JAX, or a shape it refuses)
        runs the unfused math, as the JAX engine runs its captured jaxpr
        where its kernel is not viable. Either way ``rewrites`` counts
        the layer."""
        fused.rewrites += 1
        if block_table is None or not self._plain_linears():
            # the dense mode, or projections a weight-only quantized
            # engine swapped for codes (the fused call reads fp32
            # weights; JAX pins the unfused body under quant too)
            return self._decode_forward(x, cos, sin, cache, pos,
                                        block_table, pad)
        mode = "paged_int8" if len(cache) == 4 else "paged"
        wts = self._decode_layer_weights()
        if x.device.type == "cuda" and kernel_viable(mode, x, cache, wts):
            out = decode_layer(
                mode, x, cos, sin, self.input_layernorm.eps,
                self.post_attention_layernorm.eps, pos, block_table,
                *cache, *wts, scratch=fused.scratch)[0]
            if not plain_active():
                fused.kernel_calls += 1
            return out
        return self._decode_forward(x, cos, sin, cache, pos, block_table)


# the products the selective policy keeps: nn.Linear on a 3-D input
# reaches aten.mm (aten.addmm with a bias); the batched attention
# products (aten.bmm) and everything else are recomputed
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _save_products(ctx, op, *args, **kwargs):
    """Selective recompute, JAX's ``dots_with_no_batch_dims_saveable``:
    save the products without batch dimensions, recompute the rest. The
    kernels are ctypes launches the dispatcher never sees; what it sees
    of them is the ``torch.empty`` of their outputs, which this policy
    recomputes, so they rerun as JAX reruns a ``pallas_call``."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


class LlamaDecoderStack(nn.Module):
    """The stacked decoder trunk (JAX ``LlamaDecoderStack`` on one
    stage). One prototype layer gives the structure and is kept off the
    module's parameters; each of its parameters becomes one stacked
    (L, ...) parameter named as JAX names it
    (``self_attn__q_proj__weight``), a linear stack in torch's (L, out,
    in) layout. The forward takes every layer's slices with one
    ``unbind(0)`` a stack (its backward is one ``stack``; indexing
    ``w[i]`` would give each layer a zero-filled (L, ...) gradient) and
    runs the prototype on them through ``torch.func.functional_call``,
    as JAX's ``_layer_fwd`` runs the scan body. ``config.recompute``
    checkpoints each layer: "full" keeps the layer's input only,
    "selective" also its linear products (:func:`_save_products`). The
    recompute runs under the plain-version choice of the forward it
    repeats (``ops.plain_as``)."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        layers = [LlamaDecoderLayer(config, **kw)
                  for _ in range(config.num_hidden_layers)]
        # structure donor only: its parameters are replaced by the slices
        # at every call, so it lives on the meta device, unregistered
        object.__setattr__(self, "_proto",
                           LlamaDecoderLayer(config, device="meta",
                                             dtype=dtype))
        self._pnames = [n for n, _ in self._proto.named_parameters()]
        L, V = config.num_hidden_layers, config.virtual_pp
        for n in self._pnames:
            stacked = torch.stack([layer.get_parameter(n).detach()
                                   for layer in layers])
            if V > 1:       # JAX's VPP storage: (V, L/V, ...)
                stacked = stacked.reshape(V, L // V, *stacked.shape[1:])
            self.register_parameter(n.replace(".", "__"),
                                    nn.Parameter(stacked))
        # the pp process group once fleet.distributed_model split the
        # stacks by stage, and the parameters held on two stages whose
        # gradients it sums after the backward (the tied embedding)
        self.pp_group = None
        self.pp_shared = []
        # run the schedule's microbatches on this rank (no group): the
        # run a pp step is held to bit for bit
        self.one_rank_schedule = False

    @property
    def mp_group(self):
        """The prototype layer's mp group (the slices it runs are this
        rank's)."""
        return self._proto.mp_group

    @mp_group.setter
    def mp_group(self, group):
        self._proto.mp_group = group

    @property
    def sep_group(self):
        """The prototype layer's sep group (its attention's)."""
        return self._proto.self_attn.sep_group

    @sep_group.setter
    def sep_group(self, group):
        self._proto.self_attn.sep_group = group

    def _leaves(self) -> list:
        return [self.get_parameter(n.replace(".", "__"))
                for n in self._pnames]

    def _checkpoint_kw(self) -> dict:
        # the layer draws no random numbers: no RNG state to keep
        kw = dict(use_reentrant=False, preserve_rng_state=False)
        if self.config.recompute_granularity == "selective":
            kw["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_products)
        return kw

    def _run_layers(self, leaves, x, cos, sin, plain):
        """The layers whose slices ``leaves`` stack (one ``unbind`` a
        stack), each checkpointed under ``config.recompute``."""
        kw = self._checkpoint_kw()
        for layer in zip(*(p.unbind(0) for p in leaves)):
            if self.config.recompute:
                x = checkpoint(self._layer_fwd, x, cos, sin, plain, *layer,
                               **kw)
            else:
                x = self._layer_fwd(x, cos, sin, plain, *layer)
        return x

    def pp_active(self) -> bool:
        return self.pp_group is not None and self.pp_group.nranks > 1

    def forward(self, x, cos, sin, shape=None):
        """``x`` (b, s, hidden) through the trunk. Under a pp group:
        ``x`` on the first stage only (None elsewhere, ``shape`` its
        shape), and the merged output on the last stage (an empty
        anchor elsewhere)."""
        plain = plain_active()
        if self.pp_active() or self.one_rank_schedule:
            return self._pipeline(x, cos, sin, plain, shape)
        leaves = self._leaves()
        if self.config.virtual_pp > 1:      # flattened layer order
            leaves = [p.reshape(-1, *p.shape[2:]) for p in leaves]
        return self._run_layers(leaves, x, cos, sin, plain)

    def _pipeline(self, x, cos, sin, plain, shape):
        """JAX's pipelined trunk over the pp group (``llama.py:511-564``):
        the batch in ``pp_num_microbatches`` microbatches through this
        stage's rows, FThenB at ``virtual_pp == 1``, else interleaved;
        with no group (``one_rank_schedule``) the microbatches run through
        every layer in sequence."""
        from ..distributed import pipeline as pl
        c = self.config
        g = self.pp_group if self.pp_active() else None
        S = g.nranks if g is not None else 1
        V = c.virtual_pp if g is not None else 1
        L = c.num_hidden_layers
        if L % (S * c.virtual_pp) != 0:
            raise ValueError(f"num_hidden_layers={L} not divisible by "
                             f"pp degree {S} x virtual_pp {c.virtual_pp}")
        leaves = self._leaves()
        if g is None and c.virtual_pp > 1:
            leaves = [p.reshape(-1, *p.shape[2:]) for p in leaves]
        first = g is None or g.rank == 0

        def stage_fn(params, h, cos_, sin_):
            return self._run_layers(params, h, cos_, sin_, plain)
        out = pl._schedule(
            stage_fn, leaves, x if first else None, group=g, V=V,
            num_microbatches=c.pp_num_microbatches,
            shape=tuple(x.shape) if first else tuple(shape),
            dtype=leaves[0].dtype, device=leaves[0].device,
            extras=(cos, sin),
            finish=(lambda: pl.sync_shared_gradients(self.pp_shared))
            if self.pp_shared else None)
        if g is None or g.rank == S - 1:
            return pl.merge_microbatches(out)
        return out

    def _layer_fwd(self, x, cos, sin, plain, *layer):
        with plain_as(plain):
            return functional_call(self._proto,
                                   dict(zip(self._pnames, layer)),
                                   (x, cos, sin))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, **kw)
        if config.pipeline_parallel or config.scan_layers:
            self.layers = LlamaDecoderStack(config, **kw)
        else:
            self.layers = nn.ModuleList(
                [LlamaDecoderLayer(config, **kw)
                 for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.mp_group = None        # the table's vocabulary split (training)

    def forward(self, input_ids, cos, sin, cache=None, pos=None,
                block_table=None, fused_decode=None, pad=None):
        if cache is not None:
            return tp_hooks.run_local(self._phases(
                input_ids, cos, sin, cache, pos, block_table, fused_decode,
                pad))
        stack = self.layers if isinstance(self.layers,
                                          LlamaDecoderStack) else None
        if stack is not None and stack.pp_active():
            # the embedding on the first stage, the norm on the last
            g = stack.pp_group
            x = self._embed(input_ids) if g.rank == 0 else None
            y = stack(x, cos, sin, shape=(*input_ids.shape,
                                          stack.config.hidden_size))
            return self.norm(y) if g.rank == g.nranks - 1 else y
        x = self._embed(input_ids)
        if stack is not None:
            return self.norm(stack(x, cos, sin))
        for layer in self.layers:
            x = layer(x, cos, sin)
        return self.norm(x)

    def _embed(self, input_ids):
        if self.mp_group is not None:
            from ..distributed.fleet.mp_ops import vocab_parallel_embedding
            return vocab_parallel_embedding(
                input_ids, self.embed_tokens.weight, self.mp_group)
        return self.embed_tokens(input_ids)

    def _phases(self, input_ids, cos, sin, cache, pos, block_table,
                fused_decode=None, pad=None):
        """The cache path as a generator over the layers' hook sites
        (:meth:`LlamaDecoderLayer._phases`)."""
        if isinstance(self.layers, LlamaDecoderStack):
            raise ValueError(
                "KV-cache decode is not supported with the stacked "
                "pipeline/scan trunk; build the model with "
                "pipeline_parallel=False, scan_layers=False for "
                "generation")
        x = self.embed_tokens(input_ids)
        for layer, c in zip(self.layers, cache):
            x = yield from layer._phases(x, cos, sin, c, pos, block_table,
                                         pad, fused_decode)
        return self.norm(x)


class LlamaForCausalLM(nn.Module, GenerationMixin):
    """Causal LM: the cache path (serving and ``generate()``) and the
    no-cache path (training). Built directly on ``device``
    (default the GPU; ``device="cpu"`` must be asked for) with weights
    drawn from a ``torch.Generator`` seeded with ``seed`` on that
    device: linear and embedding weights N(0, 0.02), norm weights 1 —
    replace them with ``load_state_dict(convert.params_from_jax(...))``
    to run the JAX model's weights."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        dt = dtype or getattr(torch, config.dtype)
        self.config = config
        # build on the meta device, then allocate once on the target:
        # a 7B model is never materialized on the host
        self.llama = LlamaModel(config, device="meta", dtype=dt)
        self.lm_head = None if config.tie_word_embeddings else nn.Linear(
            config.hidden_size, config.vocab_size, bias=False,
            device="meta", dtype=dt)
        self.to_empty(device=dev)
        self.init_weights(seed)
        # the mp process group once fleet.distributed_model split the
        # model for training: the head's vocabulary split; the sep group
        # whose ranks each hold a piece of every sequence
        self.mp_group = None
        self.sep_group = None
        cos, sin = _rope_cache(config, dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def head_weight(self) -> torch.Tensor:
        """The (vocab, hidden) output projection: ``lm_head.weight``, or
        the embedding when the head is tied to it."""
        if self.lm_head is None:
            return self.llama.embed_tokens.weight
        return self.lm_head.weight

    @torch.no_grad()
    def init_weights(self, seed: int):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith(("layernorm.weight", "layernorm__weight")) \
                    or name == "llama.norm.weight":
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=gen)

    def init_kv_cache(self, batch: int, max_len: int, dtype=None
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per layer a zeroed (batch, max_len, kv_heads, head_dim) (k, v)
        pair on the model's device, in ``dtype`` (default the model's):
        the dense cache of ``generate()`` and of the dense engine's slot
        pool."""
        c = self.config
        shape = (batch, max_len, c.num_key_value_heads, c.head_dim)
        dt = dtype or self.llama.embed_tokens.weight.dtype
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(c.num_hidden_layers)]

    def init_paged_kv_cache(self, num_blocks: int, block_size: int,
                            kv_int8: bool = False, dtype=None
                            ) -> List[Tuple[torch.Tensor, ...]]:
        """Per layer a shared (num_blocks, block_size, kv_heads,
        head_dim) (k, v) arena pair on the model's device, fp32 or bf16;
        block 0 is the trash block. With ``kv_int8`` each layer is a
        4-tuple: int8 k and v codes of that shape plus fp32 k and v
        absmax scales (num_blocks, block_size, kv_heads)."""
        c = self.config
        shape = (num_blocks, block_size, c.num_key_value_heads, c.head_dim)
        if kv_int8:
            def z(shp, dt):
                return torch.zeros(shp, dtype=dt, device=self.device)
            return [(z(shape, torch.int8), z(shape, torch.int8),
                     z(shape[:-1], torch.float32),
                     z(shape[:-1], torch.float32))
                    for _ in range(c.num_hidden_layers)]
        dt = dtype or self.llama.embed_tokens.weight.dtype
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f"paged arenas are float32 or bfloat16, "
                            f"got {dt}")
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device))
                for _ in range(c.num_hidden_layers)]

    def forward(self, input_ids, labels=None, cache=None, pos=None,
                block_table=None, fused_decode=None, pad=None):
        """With ``cache``: (b, s) token ids at ``pos`` through the cache
        (written in place; see ``generation.cached_attention``: a dense
        cache from :meth:`init_kv_cache` or, with ``block_table``, the
        paged arena; ``pad`` (b,) left-pad counts) -> (b, s, vocab)
        logits. Without: the training forward over positions 0..s-1
        (under a sep group: this rank's piece, positions r s..r s + s-1,
        and the whole sequence's loss); with ``labels`` it returns
        ``(loss, None)`` through the fused head + CE (``fused_head_ce``,
        the default) or ``(loss, logits)`` with the plain head and
        ``nn.functional.cross_entropy``
        (the xent kernels on the card; on the CPU their plain version
        under ``PT_FUSION_PASSES=1``, as the JAX head),
        and without labels the logits. ``fused_decode``
        (``ops.decode_layer.FusedDecode``) routes each decode layer of an
        s = 1 cache step through the fused decode-layer call."""
        if cache is not None:
            return tp_hooks.run_local(self._phases(
                input_ids, cache, pos, block_table, fused_decode, pad))
        cos, sin = self._rope_rows(input_ids.shape[1])
        h = self.llama(input_ids, cos, sin)
        g = self._pp_group()
        if g is not None:
            return self._pp_outputs(h, labels, g)
        return self._outputs(h, labels)

    def _sep(self):
        """The sep group when it has more than one rank."""
        g = self.sep_group
        return g if g is not None and g.nranks > 1 else None

    def _rope_rows(self, s: int):
        """The RoPE tables from this rank's first position: row 0, or
        ``r s`` for sep rank r of a group whose ranks each pass ``s``
        positions; a global length past the tables raises."""
        g = self._sep()
        if g is None:
            return self.rope_cos, self.rope_sin
        n = self.config.max_position_embeddings
        if s * g.nranks > n:
            raise ValueError(
                f"a sequence of {s} tokens a rank over sep degree "
                f"{g.nranks} is {s * g.nranks} positions, past "
                f"max_position_embeddings={n}")
        off = g.rank * s
        return self.rope_cos[off:off + s], self.rope_sin[off:off + s]

    def _pp_group(self):
        """The pp group once the trunk is split by stage (degree > 1)."""
        stack = self.llama.layers
        if isinstance(stack, LlamaDecoderStack) and stack.pp_active():
            return stack.pp_group
        return None

    def _pp_outputs(self, h, labels, g):
        """The head on the last stage; every output is the last stage's,
        broadcast over the pp group (JAX's are replicated). The other
        stages pass their trunk anchor, which runs their backward."""
        from ..distributed.pipeline import broadcast_from_last
        if g.rank == g.nranks - 1:
            out = self._outputs(h, labels)
        elif labels is None:
            out = h
        else:
            out = (h, None if self.config.fused_head_ce else h)
        if not isinstance(out, tuple):
            return broadcast_from_last(out, g)
        return tuple(None if t is None else broadcast_from_last(t, g)
                     for t in out)

    def _outputs(self, h, labels):
        """The head (fused with the loss, or the logits and the loss) on
        the final hidden states ``h``."""
        c = self.config
        mp, sep = self.mp_group, self._sep()
        if labels is not None and c.fused_head_ce:
            if mp is not None:
                loss = parallel_fused_linear_cross_entropy(
                    h, self.head_weight, labels, mp,
                    num_chunks=c.fused_head_ce_chunks, sep_group=sep)
            else:
                loss = fused_linear_cross_entropy(
                    h, self.head_weight, labels,
                    num_chunks=c.fused_head_ce_chunks, sep_group=sep)
            return loss, None
        if mp is not None:
            return self._mp_head(h, labels, mp, sep)
        logits = self._head(h)
        if labels is None:
            return logits
        if sep is not None:
            tok = PF.cross_entropy(logits, labels, reduction="none")
            return _sep_mean(tok, labels, sep), logits
        return PF.cross_entropy(logits, labels), logits

    def _mp_head(self, h, labels, mp, sep=None):
        """The unfused head of an mp split: this rank's vocabulary
        columns of the logits behind ``c_identity``, the vocab-parallel
        cross-entropy's mean over the valid labels (in the logits'
        dtype, as ``cross_entropy``; over the sep group's labels under
        one), and the whole logits gathered (what JAX's head
        returns)."""
        from ..distributed.fleet import mp_ops
        local = self._head(mp_ops.c_identity(h, mp))
        logits = mp_ops.gather(local, mp, -1)
        if labels is None:
            return logits
        tok = mp_ops.parallel_cross_entropy(local, labels, mp).to(
            local.dtype)
        if sep is not None:
            return _sep_mean(tok, labels, sep), logits
        valid = (labels.long() != -100).to(tok.dtype).sum()
        return tok.sum() / torch.clamp(valid, min=1.0), logits

    def _head(self, h):
        return h @ self.head_weight.t() if self.lm_head is None \
            else self.lm_head(h)

    def _phases(self, input_ids, cache, pos=None, block_table=None,
                fused_decode=None, pad=None):
        """The cache-path forward as a generator over its hook sites
        (``utils.tp_hooks``): the layers' four a layer, then the logits
        gather of a vocab-sharded head (JAX ``llama.py:713``). A mesh
        runs one per shard in lockstep (``serving.tp``). A model split
        for mp training holds only its slices and refuses the path."""
        if self.mp_group is not None:
            raise ValueError(
                "this model is split over an mp process group for training "
                "(fleet.distributed_model); serve a whole model, sharded "
                "with tp= (serving.tp)")
        h = yield from self.llama._phases(
            input_ids, self.rope_cos, self.rope_sin, cache, pos,
            block_table, fused_decode, pad)
        logits = yield (tp_hooks.maybe_gather_logits, self._head(h),
                        self.config.vocab_size)
        return logits

    def partition_specs(self) -> dict:
        """The split of every parameter over the mp and pp axes, the
        port's copy of the ``_sharding_spec`` the JAX layers attach
        (empty with neither ``tensor_parallel`` nor
        ``pipeline_parallel``): ``{name: spec}``, spec a tuple naming
        "mp" and "pp" at the split dims of the port's layout and None
        elsewhere, or None for a whole parameter. Under
        ``tensor_parallel``: JAX's linear weights are (in, out) and
        ``nn.Linear``'s (out, in), so JAX's ``P(None, "mp")`` (column:
        q/k/v, gate/up, lm_head) is dim 0 here and its ``P("mp", None)``
        (row: o/down) dim 1; the embedding table is (vocab, hidden) in
        both, ``("mp", None)``; norms replicate. A stacked trunk's ``(L,
        out, in)`` weight (``self_attn__q_proj__weight``) leads with its
        layer dim: ``"pp"`` under ``pipeline_parallel`` (JAX's ``P("pp",
        ...)``), and at ``virtual_pp > 1`` its ``(V, L/V, ...)`` storage
        leads with ``(None, "pp")`` (JAX's ``P(None, "pp", ...)``)."""
        c = self.config
        if not (c.tensor_parallel or c.pipeline_parallel):
            return {}
        pp = "pp" if c.pipeline_parallel else None
        column, row = ("mp", None), (None, "mp")
        if not c.tensor_parallel:
            column = row = (None, None)
        out = {}
        for name, _ in self.named_parameters():
            if "__" in name:              # a stacked (L, ...) parameter
                leaf = name.rsplit(".", 1)[-1].split("__")[-2]
                lead = (None, pp) if c.virtual_pp > 1 else (pp,)
            else:
                leaf = name.rsplit(".", 2)[-2] if "." in name else name
                lead = ()
            if leaf in ("q_proj", "k_proj", "v_proj", "gate_proj",
                        "up_proj", "lm_head"):
                spec = lead + column
            elif leaf in ("o_proj", "down_proj"):
                spec = lead + row
            elif leaf == "embed_tokens" and c.tensor_parallel:
                spec = ("mp", None)
            else:
                spec = lead + (None,) if lead else None
            out[name] = spec if spec and any(spec) else None
        return out

    def pipeline_stage_modules(self) -> dict:
        """The modules outside the trunk by the stage that runs them:
        the embedding on the first, the final norm and the head on the
        last (the embedding on both when the head is tied to it)."""
        last = ["llama.norm", "llama.embed_tokens"
                if self.config.tie_word_embeddings else "lm_head"]
        return {"first": ["llama.embed_tokens"], "last": last}

    def check_sep_degree(self, degree: int, mp_degree: int = 1):
        """Raise unless the model can run over a sep group of ``degree``
        (each mp rank's heads over its own): ``sequence_parallel``, a
        head count Ulysses can split, no sliding window (the config
        refuses one under ring and Ulysses, as JAX's; under megatron it
        is not ported: ROADMAP.md A.6 (e5))."""
        c = self.config
        if not c.sequence_parallel:
            raise ValueError(
                f"sep_degree={degree}: the model is not sequence-parallel "
                "(LlamaConfig(sequence_parallel=True)); its ranks would "
                "attend within their own pieces of the sequence")
        heads = c.num_attention_heads // max(mp_degree, 1)
        if c.sequence_parallel_mode == "ulysses" and heads % degree:
            raise ValueError(
                f"num_heads={heads} (a rank's, over mp {mp_degree}) not "
                f"divisible by sep degree {degree} (required for Ulysses)")
        if c.sliding_window is not None:
            raise NotImplementedError(
                f"sliding_window={c.sliding_window} under "
                f"sequence_parallel_mode={c.sequence_parallel_mode!r} at "
                f"sep_degree={degree}: windowed attention across the sep "
                "group's pieces of the sequence is not ported yet "
                "(ROADMAP.md A.6 (e5))")

    def check_mp_degree(self, degree: int):
        """Raise unless an mp split of ``degree`` gives every rank whole
        heads and equal slices of the MLP and the vocabulary."""
        c = self.config
        for what, total in (("num_attention_heads", c.num_attention_heads),
                            ("num_key_value_heads", c.num_key_value_heads),
                            ("intermediate_size", c.intermediate_size),
                            ("vocab_size", c.vocab_size)):
            if total % degree:
                raise ValueError(
                    f"{what}={total} is not divisible by the mp degree "
                    f"{degree}: each rank must hold an equal slice (whole "
                    "heads; MLP columns; vocabulary rows)")

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> int:
        """~6N + attention FLOPs per token (for MFU accounting), as the
        JAX model counts them."""
        c = self.config
        return 6 * self.num_params() \
            + 12 * c.num_hidden_layers * c.hidden_size * seq_len

