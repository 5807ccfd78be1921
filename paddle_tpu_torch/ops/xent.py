"""Fused softmax cross-entropy over rows: the hand-written CUDA kernels
``csrc/xent.cu`` (forward and backward) and their plain PyTorch
versions.

Counterpart of ``paddle_tpu/ops/pallas/xent.py``: ``softmax_xent_rows``
(the ``custom_vjp`` at ``:202-239``), whose TPU kernels are
``_xent_fwd_kernel`` (per-row logsumexp and label logit -> ``(nll,
lse)``) and ``_xent_bwd_kernel`` (``dx = softmax·ga − onehot·gb``). The
plain versions follow the JAX fallback, ``_rows_scan_fwd`` and
``_rows_scan_bwd``: the vocab in chunks of ``_best_chunk(V)`` columns
(the whole row when no divisor of V lies in [128, 4096]).

The JAX route launches its kernels only where ``_pallas_viable`` holds
(``V % 128 == 0`` and a row block within VMEM): a TPU lane and memory
artifact. On a CUDA tensor the port launches its kernels for every V;
ERNIE's V = 30522, which the JAX route computes through the scan (the
same function, one whole row at a time)."""
from __future__ import annotations

import ctypes

import torch

from . import plain_active
from .fused import _DTYPE_CODE, _check_cuda, _kernel, _stream

__all__ = ["softmax_xent_rows", "softmax_xent_rows_reference",
           "xent_fwd", "xent_bwd", "xent_fwd_reference",
           "xent_bwd_reference"]

# finite stand-in for -inf, as the JAX kernels' _NEG
_NEG = -1e30


def _best_chunk(v: int, cap: int = 4096) -> int:
    """Largest divisor of ``v`` in [128, cap], else ``v`` (the JAX
    ``_best_chunk`` with its documented cap; the TPU autotune table has
    no entry for the port)."""
    for c in range(min(v, cap), 127, -1):
        if v % c == 0:
            return c
    return v


def xent_fwd_reference(x: torch.Tensor, labels: torch.Tensor):
    """``_rows_scan_fwd``: (N, V) logits, (N,) in-range labels ->
    ``(nll, lse)`` fp32, an online logsumexp over vocab chunks."""
    n, v = x.shape
    labels = labels.long()
    c = _best_chunk(v)
    if c == v:
        xf = x.float()
        m = xf.amax(dim=-1)
        lse = m + torch.log(torch.exp(xf - m[:, None]).sum(dim=-1))
        tgt = xf.gather(1, labels[:, None])[:, 0]
        return lse - tgt, lse
    m = torch.full((n,), _NEG, dtype=torch.float32, device=x.device)
    s = torch.zeros(n, dtype=torch.float32, device=x.device)
    tgt = torch.zeros(n, dtype=torch.float32, device=x.device)
    for i in range(v // c):
        xc = x[:, i * c:(i + 1) * c].float()
        m_new = torch.maximum(m, xc.amax(dim=-1))
        s = s * torch.exp(m - m_new) \
            + torch.exp(xc - m_new[:, None]).sum(dim=-1)
        in_chunk = (labels >= i * c) & (labels < (i + 1) * c)
        idx = (labels - i * c).clamp(0, c - 1)
        tgt = torch.where(in_chunk, xc.gather(1, idx[:, None])[:, 0], tgt)
        m = m_new
    lse = m + torch.log(s)
    return lse - tgt, lse


def xent_bwd_reference(x, labels, lse, ga, gb):
    """``_rows_scan_bwd``: ``dx = exp(x − lse)·ga − onehot·gb`` chunk by
    chunk, in fp32, stored in x's dtype."""
    n, v = x.shape
    labels = labels.long()
    c = _best_chunk(v)
    dx = torch.empty_like(x)
    cols = torch.arange(c, device=x.device)
    for i in range(v // c):
        xc = x[:, i * c:(i + 1) * c].float()
        p = torch.exp(xc - lse[:, None])
        idx = (labels - i * c).clamp(0, c - 1)
        in_chunk = (labels >= i * c) & (labels < (i + 1) * c)
        onehot = (cols[None, :] == idx[:, None]) & in_chunk[:, None]
        dx[:, i * c:(i + 1) * c] = p * ga[:, None] \
            - onehot.float() * gb[:, None]
    return dx


def _check_rows(name, x, *rows):
    _check_cuda(name, x)
    if x.dim() != 2:
        raise ValueError(f"{name}: logits must be (N, V), got "
                         f"{tuple(x.shape)}")
    n = x.shape[0]
    for r in rows:
        if r.device != x.device or tuple(r.shape) != (n,) \
                or not r.is_contiguous():
            raise ValueError(f"{name}: per-row tensors must be contiguous "
                             f"({n},) on {x.device}")


def xent_fwd(x: torch.Tensor, labels: torch.Tensor):
    """Per-row ``(nll, lse)`` fp32 of (N, V) fp32/bf16 logits and (N,)
    int32 labels in [0, V) (callers clip). A CPU tensor takes the plain
    version; a CUDA tensor launches ``xent_fwd_kernel`` or raises."""
    if x.device.type == "cpu" or plain_active():
        return xent_fwd_reference(x, labels)
    _check_rows("xent_fwd", x, labels)
    if labels.dtype != torch.int32:
        raise TypeError(f"xent_fwd: labels must be int32, got "
                        f"{labels.dtype}")
    n, v = x.shape
    nll = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    if n == 0:
        return nll, lse
    fn = _kernel("xent", "pt_xent_fwd",
                 [ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), labels.data_ptr(),
            nll.data_ptr(), lse.data_ptr(), n, v, _stream(x))
    if rc != 0:
        raise RuntimeError(f"xent_fwd kernel launch failed: CUDA error {rc}")
    xent_fwd.launches += 1
    return nll, lse


def xent_bwd(x, labels, lse, ga, gb):
    """``dx = exp(x − lse)·ga − onehot(labels)·gb`` in x's dtype, with
    (N,) fp32 ``lse``, ``ga`` and ``gb``. A CPU tensor takes the plain
    version; a CUDA tensor launches ``xent_bwd_kernel`` or raises."""
    if x.device.type == "cpu" or plain_active():
        return xent_bwd_reference(x, labels, lse, ga, gb)
    _check_rows("xent_bwd", x, labels, lse, ga, gb)
    if labels.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (lse, ga, gb)):
        raise TypeError("xent_bwd: labels int32, lse/ga/gb float32")
    n, v = x.shape
    dx = torch.empty_like(x)
    if n == 0:
        return dx
    fn = _kernel("xent", "pt_xent_bwd",
                 [ctypes.c_int] + [ctypes.c_void_p] * 6
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), ga.data_ptr(), gb.data_ptr(), dx.data_ptr(), n,
            v, _stream(x))
    if rc != 0:
        raise RuntimeError(f"xent_bwd kernel launch failed: CUDA error {rc}")
    xent_bwd.launches += 1
    return dx


xent_fwd.launches = 0
xent_bwd.launches = 0


class _SoftmaxXentRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, labels):
        labels = labels.to(torch.int32).contiguous()
        nll, lse = xent_fwd(x, labels)
        ctx.save_for_backward(x, labels, lse)
        return nll, lse

    @staticmethod
    def backward(ctx, g_nll, g_lse):
        x, labels, lse = ctx.saved_tensors
        zeros = torch.zeros_like(lse)
        g_nll = zeros if g_nll is None else g_nll
        g_lse = zeros if g_lse is None else g_lse
        ga = (g_nll + g_lse).float().contiguous()   # softmax term scale
        gb = g_nll.float().contiguous()             # one-hot term scale
        return xent_bwd(x, labels, lse, ga, gb), None


def softmax_xent_rows(x: torch.Tensor, labels: torch.Tensor):
    """Per-row softmax cross-entropy core: x (N, V) logits (fp32 or
    bf16; accumulation is fp32), labels (N,) in [0, V) (callers clip;
    ``ignore_index`` masking composes outside). Returns ``(nll, lse)``,
    both (N,) fp32, differentiable in x through both outputs."""
    return _SoftmaxXentRows.apply(x.contiguous(), labels)


def softmax_xent_rows_reference(x: torch.Tensor, labels: torch.Tensor):
    """Unfused oracle (``xent.py:242-252``): a full fp32 log-softmax and
    the label's log-prob; materializes (N, V)."""
    xf = x.float()
    logp = torch.log_softmax(xf, dim=-1)
    tgt = logp.gather(1, labels.long()[:, None])[:, 0]
    m = xf.amax(dim=-1)
    lse = m + torch.log(torch.exp(xf - m[:, None]).sum(dim=-1))
    return -tgt, lse
