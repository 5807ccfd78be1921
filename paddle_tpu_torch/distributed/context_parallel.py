"""Context and sequence parallelism for long sequences.

Counterpart of ``paddle_tpu/distributed/context_parallel.py``, with its
names: ring attention (K/V blocks travel around the sep group and the
(o, lse) of each block merge online), Ulysses (all-to-alls swap the
sequence split for a head split around one attention) and ``RingAttention``.
Where JAX takes ``mesh=`` and global arrays sharded over the ``"sep"``
axis, the port takes ``group=`` (fleet's sep process group,
``fleet.init(sep_degree=S)``) and this rank's piece: q ``(b, s/S, h,
d)``, k/v ``(b, s/S, hk, d)``, the contiguous rows ``[r s/S, (r+1)
s/S)`` of sep rank r, bshd as in JAX. The exchanges are
``distributed.sep_ops``' autograd functions, so the backward is the
reverse ring (each block's backward through autograd of
``ops.flash_attention.flash_block``, whose lse cotangent the merge makes
nonzero; the hop's backward is the reverse hop), as JAX's is the
transpose of its scan of ``ppermute``s.

:func:`megatron_attention` has no JAX counterpart: under
``sequence_parallel_mode="megatron"`` JAX only constrains the layers'
activations over ``"sep"`` and GSPMD gathers what attention needs. The
port gathers K and V along the sequence (the gather's backward sums
every rank's dK/dV for each piece) and this rank's queries attend to
their diagonal block (causal) and the prefix before it (not causal).

Every block runs ``flash_block`` (the CUDA kernels on the card, their
plain versions on CPU tensors). ``_xla_block`` is JAX's plain block,
kept for the CPU tests that hold the blocks against it.

Deliberate difference: ``RingAttention`` with no sep group runs the
port's ``sdpa`` (the flash kernels on the card), where JAX's runs the
plain ``_xla_sdpa``; a plain version never serves a card path here."""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.flash_attention import flash_block, sdpa
from . import sep_ops
from .sep_ops import sep_degree

__all__ = ["ring_attention_spmd", "ulysses_attention_spmd",
           "megatron_attention", "RingAttention", "sep_degree",
           "sep_attention"]


def _repeat_kv(q, k, v):
    """K/V with their heads repeated to q's (JAX's ``_repeat_kv``)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _xla_block(q, k, v, causal, scale):
    """(o, lse) of one attention block without the kernels: JAX's
    grouped-GQA einsum block, fp32. o (b, sq, h, d), lse (b, h, sq)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones(sq, sk, dtype=torch.bool,
                                     device=q.device), diagonal=sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    neg = m == float("-inf")
    p = torch.where(neg[..., None], torch.zeros((), device=q.device),
                    torch.exp(s - m[..., None]))
    l = p.sum(dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o / torch.movedim(torch.clamp(l, min=1e-30), 3, 1)[..., None]
    lse = torch.where(neg, torch.full((), float("-inf"), device=q.device),
                      m + torch.log(torch.clamp(l, min=1e-30)))
    return o.reshape(b, sq, h, d), lse.reshape(b, hk * g, sq)


def _merge_blocks(o, lse, ob, lseb):
    """Online merge of two block-normalized attention results (JAX's):
    o (b, sq, h, d) fp32, lse (b, h, sq)."""
    lse_new = torch.logaddexp(lse, lseb)
    dead = torch.isneginf(lse_new)
    zero = torch.zeros((), dtype=lse.dtype, device=lse.device)
    wa = torch.where(dead, zero, torch.exp(lse - lse_new))
    wb = torch.where(dead, zero, torch.exp(lseb - lse_new))
    # weights are (b, h, sq) -> broadcast over (b, sq, h, d)
    wa4 = wa.transpose(1, 2)[..., None]
    wb4 = wb.transpose(1, 2)[..., None]
    return o * wa4 + ob.to(o.dtype) * wb4, lse_new


def _scale(q, scale):
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


def ring_attention_spmd(q, k, v, *, group=None, causal: bool = True,
                        scale: Optional[float] = None):
    """Ring attention over the sep ``group`` (module docstring): S steps;
    at step t this rank holds the K/V piece of rank (r - t) mod S. The
    diagonal block is causal, a past block not, a future block is skipped
    (it contributes (0, -inf)); the blocks merge in fp32 in step order.
    K/V (stacked, one tensor) pass around the ring in one autograd node
    (``sep_ops.ring_pass``): S - 1 hops, JAX's last rotation carrying
    nothing used. K/V are
    repeated only when h is not a multiple of hk (the kernels read GQA
    as it is). Returns q's dtype."""
    S = sep_degree(group)
    scale_ = _scale(q, scale)
    if S == 1:
        return sdpa(q, k, v, None, is_causal=causal, scale=scale_)
    if q.shape[2] % k.shape[2] != 0:
        k, v = _repeat_kv(q, k, v)
    idx = group.rank
    o = lse = None
    for step, kv in enumerate(sep_ops.ring_pass(torch.stack([k, v]),
                                                group)):
        j = (idx - step) % S
        if causal and j > idx:
            continue
        ob, lseb = flash_block(q, kv[0], kv[1], causal and j == idx,
                               scale_)
        if o is None:
            o, lse = ob.float(), lseb
        else:
            o, lse = _merge_blocks(o, lse, ob, lseb)
    return o.to(q.dtype)


def ulysses_attention_spmd(q, k, v, *, group=None, causal: bool = True,
                           scale: Optional[float] = None):
    """DeepSpeed-Ulysses: one all-to-all swaps the sequence split of q
    and one of the stacked K/V for a head split, ``(b, s/S, h, d) -> (b,
    s, h/S, d)``; the port's ``sdpa`` (the flash kernels) runs over the
    whole sequence on h/S heads; one all-to-all swaps back. h must be a
    multiple of S (JAX's ValueError); K/V are repeated to h heads when hk
    is not."""
    S = sep_degree(group)
    scale_ = _scale(q, scale)
    if S == 1:
        return sdpa(q, k, v, None, is_causal=causal, scale=scale_)
    if q.shape[2] % S != 0:
        raise ValueError(f"num_heads={q.shape[2]} not divisible by "
                         f"sep degree {S} (required for Ulysses)")
    if k.shape[2] % S != 0:
        k, v = _repeat_kv(q, k, v)
    qh = sep_ops.all_to_all(q, group, split_axis=2, concat_axis=1)
    kvh = sep_ops.all_to_all(torch.stack([k, v]), group, split_axis=3,
                             concat_axis=2)
    out = sdpa(qh, kvh[0], kvh[1], None, is_causal=causal, scale=scale_)
    return sep_ops.all_to_all(out, group, split_axis=1, concat_axis=2)


def megatron_attention(q, k, v, *, group=None, causal: bool = True,
                       scale: Optional[float] = None):
    """Attention of this rank's queries over the whole sequence's K/V,
    gathered along the sequence over the sep ``group`` (one gather of the
    stacked K/V; its backward a reduce-scatter): causal, the diagonal
    block (causal) merged in fp32 with the prefix ``[0, r s/S)`` (not
    causal, sq != sk); not causal, one block over every key."""
    S = sep_degree(group)
    scale_ = _scale(q, scale)
    if S == 1:
        return sdpa(q, k, v, None, is_causal=causal, scale=scale_)
    kv = sep_ops.seq_all_gather(torch.stack([k, v]), group, axis=2)
    if not causal:
        return flash_block(q, kv[0], kv[1], False, scale_)[0]
    r, sl = group.rank, q.shape[1]
    diag = kv[:, :, r * sl:(r + 1) * sl].contiguous()
    o, lse = flash_block(q, diag[0], diag[1], True, scale_)
    if r == 0:
        return o
    prefix = kv[:, :, :r * sl].contiguous()
    op, lsep = flash_block(q, prefix[0], prefix[1], False, scale_)
    return _merge_blocks(o.float(), lse, op, lsep)[0].to(q.dtype)


_MODES = {"ring": ring_attention_spmd, "ulysses": ulysses_attention_spmd,
          "megatron": megatron_attention}


def sep_attention(mode: str, q, k, v, group, causal: bool = True,
                  scale: Optional[float] = None):
    """The attention of ``LlamaConfig.sequence_parallel_mode`` ``mode``
    over the sep ``group``."""
    return _MODES[mode](q, k, v, group=group, causal=causal, scale=scale)


class RingAttention:
    """PaddleNLP's RingFlashAttention façade: callable on q/k/v pieces;
    takes fleet's process group along ``axis`` (``mode`` "ring", else
    Ulysses, as JAX's). With no such group, or one of one rank, the
    port's ``sdpa`` (module docstring)."""

    def __init__(self, axis: str = "sep", mode: str = "ring"):
        self.axis = axis
        self.mode = mode

    def __call__(self, q, k, v, causal=True):
        from .mesh import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        group = getattr(hcg, "_groups", {}).get(self.axis) \
            if hcg is not None else None
        if sep_degree(group) == 1:
            return sdpa(q, k, v, None, is_causal=causal)
        fn = ring_attention_spmd if self.mode == "ring" \
            else ulysses_attention_spmd
        return fn(q, k, v, group=group, causal=causal)
