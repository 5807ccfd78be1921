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
change nothing, so the last chunk is simply shorter here."""
from __future__ import annotations

import torch

__all__ = ["fused_linear_cross_entropy"]

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


class _FusedLinearCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, num_chunks, ignore_index):
        n, v_total = h.shape[0], w.shape[0]
        labels = labels.long()
        safe = labels.clamp(0, v_total - 1)
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=h.device)
        s = torch.zeros(n, dtype=torch.float32, device=h.device)
        tgt = torch.zeros(n, dtype=torch.float32, device=h.device)
        for c0, c1, chunk in _chunks(v_total, num_chunks):
            lc = _chunk_logits(h, w[c0:c1])
            m_new = torch.maximum(m, lc.amax(dim=-1))
            s = s * torch.exp(m - m_new) \
                + torch.exp(lc - m_new[:, None]).sum(dim=-1)
            in_chunk, idx = _label_slot(safe, c0, c1, chunk)
            lt = lc.gather(1, idx[:, None])[:, 0]
            tgt = torch.where(in_chunk, lt, tgt)
            m = m_new
        lse = m + torch.log(s)
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
        hf = h.float()
        gh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        gw = torch.empty_like(w)
        for c0, c1, chunk in _chunks(w.shape[0], ctx.num_chunks):
            w_c = w[c0:c1]
            p = torch.exp(_chunk_logits(h, w_c) - lse[:, None])
            in_chunk, idx = _label_slot(safe, c0, c1, chunk)
            # p - onehot: subtract 1 at each label inside this chunk
            p.scatter_add_(1, idx[:, None], -in_chunk.float()[:, None])
            p.mul_(wvalid[:, None])
            gh += p @ w_c.float()
            gw[c0:c1] = (p.t() @ hf).to(w.dtype)
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
