"""EQuARX-style int8 quantized all-reduce (arXiv:2506.17615).

Counterpart of ``paddle_tpu/distributed/collectives/quantized.py``. The
fp32 payload splits into fixed-size buckets; each bucket ships as int8
codes plus one fp32 scale, the bucket's raw absmax. Accumulation is
always fp32: every receiver dequantizes each contribution and sums them
in rank order, never adding in int8.

Error contract (JAX's, computable at runtime):

    per-bucket quantization step   s = absmax / 127
    per-element contribution error <= s/2            (round-to-nearest)
    n-way reduce, phase 1          <= n * s_in/2
    re-quantized result, phase 2   <= s_out/2

so |quantized - fp32| <= n * max_bucket_scale_in / 2 + bucket_scale_out
/ 2 elementwise (:func:`int8_error_bound`). A bucket whose elements are
all equal is exact: its absmax is code +-127, which dequantizes as
sign * absmax with no arithmetic, in both phases.

The in-program :func:`quantized_all_reduce` takes the per-shard tensors
as a list (:mod:`.hierarchical`); hierarchical plans quantize the inner
phases (reduce-scatter and all-gather, the full-payload traffic) and
keep the outer all-reduce fp32, as in JAX."""
from __future__ import annotations

from typing import List, Optional

import torch

from .hierarchical import HierarchyPlan, _check, _groups, pad_to_multiple

_QMAX = 127.0


def _quantize(flat: torch.Tensor, bucket_size: int):
    """(padded_len,) fp32 -> ((nb, bucket) int8 codes, (nb,) fp32
    per-bucket absmax scales). Padding to a bucket multiple is the
    caller's job. The scale is the RAW absmax: the extreme codes +-127
    then reproduce +-absmax exactly (:func:`_dequantize`)."""
    b = flat.reshape(-1, bucket_size)
    scale = b.abs().amax(dim=1)
    denom = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(b / denom[:, None] * _QMAX), -_QMAX, _QMAX)
    return q.to(torch.int8), scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The codes in fp32: +-127 dequantize as sign * absmax with no
    arithmetic on the 1/127 step, interior codes as q * (s / 127)."""
    qf = q.to(torch.float32)
    s = scale[..., None]
    return torch.where(qf.abs() == _QMAX, torch.sign(qf) * s,
                       qf * (s / _QMAX))


def int8_error_bound(x_absmax, nranks: int, bucket_absmax_out=None):
    """Worst-case |quantized - fp32| for an n-way int8 all-reduce:
    ``x_absmax`` the max |input| over the bucket across contributors,
    ``bucket_absmax_out`` the max |reduced value| (default the loose
    ``n * x_absmax``). Both phases quantized."""
    x_absmax = torch.as_tensor(x_absmax, dtype=torch.float32)
    out_mx = torch.as_tensor(bucket_absmax_out, dtype=torch.float32) \
        if bucket_absmax_out is not None else nranks * x_absmax
    return nranks * (x_absmax / _QMAX) / 2 + (out_mx.to(x_absmax.device)
                                               / _QMAX) / 2


def _gather_dequant_sum(codes, device):
    """Every contribution's (codes, scales), dequantized on ``device``
    and summed in rank order: the receiver's fp32 accumulation. Returns
    (flat sum, per-bucket max input scale across contributors)."""
    acc, s_max = None, None
    for q, s in codes:
        q, s = q.to(device), s.to(device)
        d = _dequantize(q, s)
        acc = d if acc is None else acc + d
        s_max = s if s_max is None else torch.maximum(s_max, s)
    return acc.reshape(-1), s_max


def quantized_all_reduce(xs: List[torch.Tensor], plan: HierarchyPlan,
                         bucket_size: Optional[int] = None,
                         return_error_bound: bool = False):
    """All-reduce (sum) of the per-shard tensors over the int8 wire
    format; fp32/bf16 in, the same dtype out, fp32 accumulation. Returns
    the list every shard holds and, with ``return_error_bound``, the
    runtime worst-case elementwise error (a 0-dim fp32 tensor on the
    first shard's device) from the actual bucket scales."""
    from . import collective_config
    _check(xs, plan)
    if bucket_size is None:
        bucket_size = collective_config().quant_bucket_size
    shape, dtype = xs[0].shape, xs[0].dtype
    size = xs[0].numel()
    dev0 = xs[0].device
    if plan.flat:
        codes = [_quantize(pad_to_multiple(x.reshape(-1).float(),
                                           bucket_size)[0], bucket_size)
                 for x in xs]
        memo = {}
        for x in xs:
            if x.device in memo:
                continue
            red, s_in = _gather_dequant_sum(codes, x.device)
            # phase 2: the flat path gathers nothing (every device
            # reduced the full payload); the re-quantization keeps the
            # two-phase contract the hierarchical path quotes
            q2, s_out = _quantize(red, bucket_size)
            memo[x.device] = (_dequantize(q2, s_out).reshape(-1), s_in,
                              s_out)
        out = [memo[x.device][0] for x in xs]
        _, s_in_max, s_out = memo[dev0]
    else:
        n_in = plan.inner_size
        flats = [pad_to_multiple(x.reshape(-1).float(),
                                 bucket_size * n_in)[0] for x in xs]
        chunk = flats[0].numel() // n_in
        codes = [_quantize(f, bucket_size) for f in flats]
        groups = _groups(list(range(len(xs))), plan)
        # phase 1: quantized reduce-scatter within each inner group:
        # rank (g, i) accumulates its group's codes, keeps chunk i
        own, s_in_max = {}, None
        for g, members in enumerate(groups):
            for i, r in enumerate(members):
                red, s_in = _gather_dequant_sum([codes[m] for m in members],
                                                xs[r].device)
                own[g, i] = red[i * chunk:(i + 1) * chunk]
                s_in = s_in.to(dev0)
                s_in_max = s_in if s_in_max is None \
                    else torch.maximum(s_in_max, s_in)
        # fp32 all-reduce of chunk i across the groups, on rank (0, i)
        tot = []
        for i in range(n_in):
            dev = xs[groups[0][i]].device
            acc = own[0, i].to(dev)
            for g in range(1, len(groups)):
                acc = acc + own[g, i].to(dev)
            tot.append(acc)
        # phase 2: quantized all-gather within the inner level
        codes2 = [_quantize(t, bucket_size) for t in tot]
        s_out = torch.cat([s.to(dev0) for _, s in codes2])
        memo = {}
        for x in xs:
            if x.device not in memo:
                memo[x.device] = torch.cat(
                    [_dequantize(q.to(x.device), s.to(x.device))
                     .reshape(-1) for q, s in codes2])
        out = [memo[x.device] for x in xs]
    out = [o[:size].reshape(shape).to(dtype) for o in out]
    if not return_error_bound:
        return out
    bound = int8_error_bound(s_in_max.max(), plan.total_size,
                             bucket_absmax_out=s_out.max())
    return out, bound
