"""Fused LM-head linear + softmax cross-entropy, chunked over the vocab.

Counterpart of ``paddle_tpu/incubate/nn/fused_ce.py``
``fused_linear_cross_entropy`` and its wrapper in
``incubate/nn/functional.py``: the (tokens, vocab) logits never exist
whole. The forward runs an online logsumexp over vocab chunks and picks
each label's logit; the backward recomputes each chunk's probabilities
from the saved logsumexp. The JAX package has no Pallas kernel here (a
``lax.scan`` of XLA products), so the chunk products are
``torch.matmul``.

Dtypes, as in the JAX package: the chunk logits are fp32 products of
the (bf16 under O2) inputs with fp32 accumulation. Where torch takes
``torch.mm(..., out_dtype=torch.float32)`` for bf16 CUDA inputs it
computes them in one call; elsewhere the inputs are upcast first, which
gives the same products. The backward's two products run in fp32, as
the JAX ``_fused_bwd`` does (``dlogits`` is fp32 and ``w``/``h`` are
cast to it). The vocab is split into ``num_chunks`` chunks of
``ceil(V / num_chunks)`` columns; the JAX padding columns (logit -inf)
change nothing, so the last chunk is simply shorter here.

``parallel_fused_linear_cross_entropy`` is the vocabulary-parallel
variant (JAX ``fused_ce.py:125-221``) over an mp process group, ``w``
this rank's ``(V/n, D)`` slice: each rank scans its own slice in chunks
(the local ``(N, V/n)`` logits never exist either), the slices' log-sum-
exps merge with one max and one sum all-reduce, the label's logit is
all-reduced from the rank that holds it, and the backward recomputes
the local chunks against the global log-sum-exp and all-reduces ``dh``
(in ``h``'s dtype, as JAX's ``shard_map`` sums the cotangent of its
replicated input)."""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy",
           "parallel_fused_linear_cross_entropy"]

_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


def _chunk_logits(h, w_c):
    """(n, V_c) fp32 logits of one vocab chunk."""
    if h.dtype == torch.float32 and w_c.dtype == torch.float32:
        return h @ w_c.t()
    if h.is_cuda and _MM_OUT_DTYPE:
        return torch.mm(h, w_c.t(), out_dtype=torch.float32)
    return h.float() @ w_c.float().t()


def _chunks(v_total, num_chunks):
    chunk = -(-v_total // num_chunks)
    for c0 in range(0, v_total, chunk):
        yield c0, min(c0 + chunk, v_total), chunk


def _label_slot(safe, c0, c1, chunk):
    in_chunk = (safe >= c0) & (safe < c0 + chunk)
    idx = (safe - c0).clamp(0, c1 - c0 - 1)
    return in_chunk, idx


def _scan(h, w, safe, num_chunks):
    """The online log-sum-exp over ``w``'s vocab chunks and the logit of
    each (clipped) label ``safe``: ((n,) lse, (n,) label logit), fp32."""
    n = h.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=h.device)
    s = torch.zeros(n, dtype=torch.float32, device=h.device)
    tgt = torch.zeros(n, dtype=torch.float32, device=h.device)
    for c0, c1, chunk in _chunks(w.shape[0], num_chunks):
        lc = _chunk_logits(h, w[c0:c1])
        m_new = torch.maximum(m, lc.amax(dim=-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(lc - m_new[:, None]).sum(dim=-1)
        in_chunk, idx = _label_slot(safe, c0, c1, chunk)
        lt = lc.gather(1, idx[:, None])[:, 0]
        tgt = torch.where(in_chunk, lt, tgt)
        m = m_new
    return m + torch.log(s), tgt


def _grads(h, w, safe, hit, lse, wvalid, num_chunks):
    """(fp32 dh, dw in w's dtype) of the chunked softmax against the
    global ``lse``, the one-hot of ``safe`` where ``hit``, each token
    weighted by ``wvalid``."""
    hf = h.float()
    gh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    gw = torch.empty_like(w)
    for c0, c1, chunk in _chunks(w.shape[0], num_chunks):
        w_c = w[c0:c1]
        p = torch.exp(_chunk_logits(h, w_c) - lse[:, None])
        in_chunk, idx = _label_slot(safe, c0, c1, chunk)
        # p - onehot: subtract 1 at each label inside this chunk
        p.scatter_add_(1, idx[:, None], -(in_chunk & hit).float()[:, None])
        p.mul_(wvalid[:, None])
        gh += p @ w_c.float()
        gw[c0:c1] = (p.t() @ hf).to(w.dtype)
    return gh, gw


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, num_chunks, ignore_index):
        v_total = w.shape[0]
        labels = labels.long()
        safe = labels.clamp(0, v_total - 1)
        lse, tgt = _scan(h, w, safe, num_chunks)
        valid = labels != ignore_index
        denom = valid.sum().clamp(min=1)
        loss = torch.where(valid, lse - tgt, 0.0).sum() / denom
        ctx.save_for_backward(h, w, safe, lse, valid, denom)
        ctx.num_chunks = num_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, safe, lse, valid, denom = ctx.saved_tensors
        wvalid = valid.float() * (g.float() / denom)   # per-token weight
        gh, gw = _grads(h, w, safe, torch.ones_like(valid), lse, wvalid,
                        ctx.num_chunks)
        return gh.to(h.dtype), gw, None, None, None


def fused_linear_cross_entropy(h, w, labels, num_chunks=16,
                               ignore_index=-100):
    """Mean cross-entropy of ``softmax(h @ w.T)`` against ``labels``
    without building the full logits. h (..., D); w (V, D), the
    lm_head/embedding layout; labels (...,) int. Tokens whose label is
    ``ignore_index`` count for nothing; the mean is over the rest (at
    least one). Returns an fp32 scalar, differentiable in h and w."""
    h2 = h.reshape(-1, h.shape[-1])
    return _FusedLinearCE.apply(h2, w, labels.reshape(-1), int(num_chunks),
                                int(ignore_index))


class _ParallelFusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, group, num_chunks, ignore_index):
        from ...distributed import communication as C
        v_loc = w.shape[0]
        labels = labels.long()
        local = labels - group.rank * v_loc
        hit = (local >= 0) & (local < v_loc)
        safe = local.clamp(0, v_loc - 1)
        lse_loc, tgt_loc = _scan(h, w, safe, num_chunks)
        # the slices' log-sum-exp merge, then the label's logit
        m = _reduce(lse_loc.clone(), group, C.ReduceOp.MAX)
        srun = _reduce(torch.exp(lse_loc - torch.where(
            torch.isneginf(m), torch.zeros_like(m), m)), group)
        lse = m + torch.log(torch.clamp(srun, min=1e-30))
        tgt = _reduce(torch.where(hit, tgt_loc, torch.zeros_like(tgt_loc)),
                      group)
        valid = labels != ignore_index
        denom = valid.sum().clamp(min=1)
        loss = torch.where(valid, lse - tgt, 0.0).sum() / denom
        ctx.save_for_backward(h, w, safe, hit, lse, valid, denom)
        ctx.num_chunks, ctx.group = num_chunks, group
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, safe, hit, lse, valid, denom = ctx.saved_tensors
        wvalid = valid.float() * (g.float() / denom)
        gh, gw = _grads(h, w, safe, hit, lse, wvalid, ctx.num_chunks)
        return (_reduce(gh.to(h.dtype), ctx.group), gw, None, None, None,
                None)


def _reduce(t, group, op=None):
    """``t`` all-reduced over the mp ``group``, counted with the mp
    collectives (``mp_ops.mp_stats``)."""
    from ...distributed import communication as C
    from ...distributed.fleet.mp_ops import _all_reduce
    return _all_reduce(t.contiguous(), group, op or C.ReduceOp.SUM)


def parallel_fused_linear_cross_entropy(h, w, labels, group, num_chunks=8,
                                        ignore_index=-100):
    """Mean cross-entropy of ``softmax(h @ W.T)`` for a ``W`` split by
    vocabulary row over the mp process group ``group``: ``w`` is this
    rank's ``(V/n, D)`` slice (rank r holds rows ``[r V/n, (r+1)
    V/n)``), ``h`` (..., D) and ``labels`` (...,) are the same on every
    rank, and so is the returned fp32 scalar (module docstring). With no
    group, or one of one member, it is :func:`fused_linear_cross_entropy`
    (JAX's falls back to it without an mp mesh axis)."""
    if group is None or group.nranks == 1:
        return fused_linear_cross_entropy(h, w, labels, num_chunks,
                                          ignore_index)
    h2 = h.reshape(-1, h.shape[-1])
    return _ParallelFusedLinearCE.apply(h2, w, labels.reshape(-1), group,
                                        int(num_chunks), int(ignore_index))
