"""MoE token dispatch and combine as row gathers: the hand-written CUDA
kernel ``csrc/moe_gather.cu`` and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/moe_dispatch.py``. The router's
two index maps (``build_index_maps``)

    slot : (T*k,)   token-major -> flat expert-buffer slot (sentinel
                    E*cap for capacity-dropped tokens)
    inv  : (E*cap,) expert-major slot -> flat token*k+j (sentinel T*k
                    for unfilled slots)

make every data movement of the MoE layer a row gather with
out-of-range rows zeroed: ``moe_dispatch`` and ``moe_combine`` and both
their backwards call :func:`gather_rows`, exactly as the JAX custom
VJPs do. The sum over the k choices and the gate products stay torch
ops, as they stay jnp.

:func:`gather_rows` has one route per device. A CUDA tensor launches the
kernel (fp32 and bf16 rows of any width; any other dtype raises): the
JAX package's ``PT_MOE_GATHER`` switch (its TPU default ``jnp``, the
Pallas kernels on request) is not carried over, so the port's CUDA
default is the kernel on purpose. A CPU tensor, or any tensor inside
``ops.plain_versions()``, takes the plain version, the JAX ``jnp`` route
(clamp, take, mask). The kernel runs a fixed eight rows per CTA: one
row per CTA and eight took the same time on the H100 (PERF.md), so the
JAX ``pallas``/``pallas_mr`` split and ``PT_MOE_GATHER_ROWS`` have no
counterpart."""
from __future__ import annotations

import ctypes

import torch

from . import plain_active
from .fused import _kernel, _stream

__all__ = ["build_index_maps", "gather_rows", "gather_rows_reference",
           "moe_gather", "moe_dispatch", "moe_combine"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def build_index_maps(topi: torch.Tensor, num_expert: int, capacity: int):
    """The dual token<->slot maps from (T, k) top-k expert choices:
    ``(slot, inv, keep)`` as documented in the module docstring, slot and
    inv int32, keep bool (T*k,). Integer-equal to the JAX function: a
    stable argsort of the flat choices, left-side searchsorted starts,
    positions within each expert in token order."""
    t, k = topi.shape
    e, cap = num_expert, capacity
    n = t * k
    dev = topi.device
    flat_e = topi.reshape(-1).long()
    sidx = torch.argsort(flat_e, stable=True)
    se = flat_e[sidx]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.empty_like(flat_e)
    pos[sidx] = torch.arange(n, device=dev) - starts[se]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(flat_e, e * cap))
    slots = torch.arange(e * cap, device=dev)
    ee, c = slots // cap, slots % cap
    src = starts[ee] + c
    ends = torch.cat([starts[1:], torch.tensor([n], device=dev)])
    inv = torch.where(src < ends[ee], sidx[src.clamp(0, n - 1)],
                      torch.full_like(src, n))
    return slot.to(torch.int32), inv.to(torch.int32), keep


def gather_rows_reference(x: torch.Tensor, idx: torch.Tensor):
    """``_gather_rows_jnp``: take on clamped indices, then zero the rows
    whose index lies outside [0, T)."""
    t = x.shape[0]
    idx = idx.long()
    out = x.index_select(0, idx.clamp(0, t - 1))
    valid = ((idx >= 0) & (idx < t))[:, None]
    return torch.where(valid, out, torch.zeros((), dtype=x.dtype,
                                               device=x.device))


def moe_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(m, d) rows ``x[idx]`` of a (T, d) fp32/bf16 ``x`` for int32 (m,)
    ``idx``, zero where the index is out of range. A CPU tensor (or any
    inside ``ops.plain_versions()``) takes the plain version; a CUDA
    tensor launches ``csrc/moe_gather.cu``, or raises."""
    if x.device.type == "cpu" or plain_active():
        return gather_rows_reference(x, idx)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"moe_gather kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"moe_gather: x (T, d) and idx (m,), got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32 or idx.device != x.device:
        raise TypeError(f"moe_gather: idx must be int32 on {x.device}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("moe_gather kernel needs contiguous tensors")
    t, d = x.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    if m == 0 or d == 0:
        return out
    fn = _kernel("moe_gather", "pt_moe_gather",
                 [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(x.element_size(), x.data_ptr(), idx.data_ptr(), out.data_ptr(),
            t, m, d, _stream(x))
    if rc != 0:
        raise RuntimeError(f"moe_gather kernel launch failed: CUDA error "
                           f"{rc}")
    moe_gather.launches += 1
    return out


moe_gather.launches = 0


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = x[idx[i]] for in-range idx, else zeros: the kernel on a
    CUDA tensor, the plain version on a CPU one (see the module
    docstring)."""
    return moe_gather(x.contiguous(), idx.to(torch.int32).contiguous())


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inv, slot):
        t = x.shape[0]
        k = slot.shape[0] // t
        ctx.t, ctx.k = t, k
        ctx.save_for_backward(slot)
        return gather_rows(x, torch.div(inv, k, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, dbuf):
        (slot,) = ctx.saved_tensors
        # dx[t] = sum_j dbuf[slot[t, j]]; a dropped token's E*cap
        # sentinel gathers zeros
        dx = gather_rows(dbuf.contiguous(), slot).reshape(ctx.t, ctx.k, -1) \
            .sum(dim=1)
        return dx, None, None


def moe_dispatch(x: torch.Tensor, inv: torch.Tensor,
                 slot: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens -> (E*cap, d) expert-major buffer: slot m holds
    token ``inv[m] // k`` (the sentinel T*k divides to T, a zero row)."""
    return _Dispatch.apply(x, inv, slot)


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, gates, inv, slot):
        t, k = gates.shape
        ctx.save_for_backward(flat, gates, inv, slot)
        rows = gather_rows(flat, slot).reshape(t, k, -1)
        return (rows * gates[..., None].to(flat.dtype)).sum(dim=1)

    @staticmethod
    def backward(ctx, dout):
        flat, gates, inv, slot = ctx.saved_tensors
        t, k = gates.shape
        n = t * k
        dout = dout.contiguous()
        # d flat[m] = gates[inv[m]] * dout[token(m)]: an expert-major gather
        gates_flat = gates.reshape(n)
        invl = inv.long()
        gval = torch.where(invl < n, gates_flat[invl.clamp(0, n - 1)],
                           torch.zeros((), dtype=gates.dtype,
                                       device=gates.device))
        dflat = (gval[:, None].to(dout.dtype)
                 * gather_rows(dout, torch.div(inv, k,
                                               rounding_mode="floor"))
                 ).to(flat.dtype)
        # d gates[t, j] = <dout[t], flat[slot[t, j]]>: the rows gathered
        # again rather than saved (as the JAX VJP)
        rows = gather_rows(flat, slot).reshape(t, k, -1)
        dgates = (rows.to(dout.dtype) * dout[:, None, :]).sum(dim=-1)
        return dflat, dgates.to(gates.dtype), None, None


def moe_combine(flat: torch.Tensor, gates: torch.Tensor, inv: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """(E*cap, d) expert outputs and (T, k) gate weights -> (T, d): each
    token's k rows gathered through ``slot``, weighted and summed."""
    return _Combine.apply(flat, gates, inv, slot)
