"""The arithmetic of the redesigned decode kernels, emulated on the CPU.

The CUDA kernels run only on a GPU (test_torch_port_gpu.py), so what
their design changes in the numbers is checked here in torch:

- the decode-layer megakernel's products: TF32 rounded to nearest on
  the bits, the 3xTF32 split, fp32 accumulation per K-slice of the host
  plan and the reduction of the slices in the kernel's fixed order, at
  Llama-2-7B widths, against an fp64 reference and the unchanged
  tolerance rule of the megakernel's tests;
- the split table walk of the paged-decode kernels: the host's chunk
  plan covers every table entry once, and the chunked (m, l, acc) merge
  equals the gathered-dense references of the port and of the JAX
  package on the same numpy inputs (fp32 and int8 arenas)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa

from paddle_tpu_torch.ops.decode_layer import (BAND_ROWS, WALK_UNITS_PER_CTA,
                                               layer_plan,
                                               product_plan)
from paddle_tpu_torch.ops.paged_attention import (
    KV_WARPS, NEG, dequantize_kv, paged_attention_int8_reference,
    paged_attention_reference, quantize_kv, split_plan, walk_plan)


def _megakernel_tol(d, ff):
    """The tolerance rule of the megakernel's GPU tests and of
    chip_smoke.py, unchanged: 5 * 8 u sqrt(K), u = 2^-24."""
    return 5 * 8 * 2.0 ** -24 * math.sqrt(max(d, ff))


# -- the megakernel's products -----------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 rounded to nearest, ties away from zero (the
    kernel's ``tf32``, ``cvt.rna.tf32.f32``): on the bits, add 0x1000 and
    clear the 13 low bits; a NaN stays a NaN."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def _emulated_product(x, w, kslice, terms=3):
    """x (S, K) times w (N, K)^T as the kernel computes it: per K-slice
    an fp32 accumulator, one m16n8k8 step (8 columns) at a time, each
    step's 8 products summed exactly and added with one fp32 rounding,
    the 3xTF32 terms in the kernel's order (lo*hi, hi*lo, hi*hi; with
    ``terms=1`` hi*hi alone); then the slices summed in slice order in
    fp32."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    pairs = [(wl, xh), (wh, xl), (wh, xh)] if terms == 3 else [(wh, xh)]
    K = x.shape[1]
    total = torch.zeros(w.shape[0], x.shape[0], dtype=torch.float32)
    for k0 in range(0, K, kslice):
        k1 = min(k0 + kslice, K)
        steps = -(-(k1 - k0) // 8)
        pad = steps * 8 - (k1 - k0)
        # (steps, N, S) exact sums of each step's 8 products, per term
        sums = [torch.einsum(
            "nqk,sqk->qns",
            torch.nn.functional.pad(a[:, k0:k1].double(), (0, pad))
            .view(-1, steps, 8),
            torch.nn.functional.pad(b[:, k0:k1].double(), (0, pad))
            .view(-1, steps, 8)) for a, b in pairs]
        acc = torch.zeros_like(total)
        for q in range(steps):
            for s in sums:
                acc = (acc.double() + s[q]).float()
        total = total + acc
    return total.t()


@pytest.mark.parametrize("name,k,n_out", [("q", 4096, 4096),
                                          ("gate", 4096, 11008),
                                          ("down", 11008, 4096)])
def test_3xtf32_products_fit_the_megakernel_tolerance(name, k, n_out):
    """Llama-2-7B widths at 32 slots: unit-scale inputs, weights scaled
    by 1/sqrt(fan-in) (the megakernel tests' inputs), 256 of the output
    rows; the K-slices of the host plan for a 396-CTA grid (three CTAs on
    each of 132 SMs). 3xTF32 stays within half the tolerance of an fp64
    reference; 1xTF32 does not meet the tolerance at all."""
    d, ff, S = 4096, 11008, 32
    _, ks, kslice = product_plan(n_out, k, 396, pair=name == "gate")
    assert ks > 1
    rs = np.random.RandomState(k + n_out)
    x = torch.from_numpy(rs.randn(S, k).astype(np.float32))
    w = torch.from_numpy((rs.randn(256, k) / math.sqrt(k))
                         .astype(np.float32))
    ref = x.double() @ w.double().t()
    tol = _megakernel_tol(d, ff)
    err3 = float((_emulated_product(x, w, kslice) - ref).abs().max())
    err1 = float((_emulated_product(x, w, kslice, terms=1) - ref)
                 .abs().max())
    assert err3 <= tol / 2, (err3, tol)
    assert err1 > tol, (err1, tol)


@pytest.mark.parametrize("grid", [132, 264, 396, 528])
@pytest.mark.parametrize("S", [1, 8, 32])
def test_layer_plan_covers_every_product(S, grid):
    """Every K column of every product lies in exactly one slice, slices
    are whole 32-column blocks, the bands cover the output rows, and at
    7B width the items fill the grid."""
    d, h, dh, ff, mb = 4096, 32, 128, 11008, 128
    plan = layer_plan(S, d, h, dh, ff, mb, grid)
    prods = [(h * dh, d, False), (d, h * dh, False), (ff, d, True),
             (d, ff, False)]
    for i, (n_out, k, pair) in enumerate(prods):
        bands, ks, kslice = plan[3 * i:3 * i + 3]
        assert kslice % 32 == 0
        covered = np.zeros(k, int)
        for j in range(ks):
            covered[j * kslice:min((j + 1) * kslice, k)] += 1
        assert (covered == 1).all()
        assert bands * (BAND_ROWS // 2 if pair else BAND_ROWS) >= n_out
        assert bands * ks >= grid or ks * 32 >= k
    ce, nc = plan[12:]
    assert (ce, nc) == split_plan(S * h, mb, WALK_UNITS_PER_CTA * grid)


# -- the split table walk ----------------------------------------------------

@pytest.mark.parametrize("items,mb,target", [
    (256, 64, 528),      # the fp32 phase-2 shape: 64 entries in 3 chunks
    (256, 67, 528),      # a table width that is no multiple of the chunk
    (256, 3, 528),       # a table narrower than one chunk of KV_WARPS
    (1024, 128, 528),    # enough items: one chunk (the int8 main shape)
    (8, 1000, 10 ** 6),  # many chunks, capped at one per KV_WARPS entries
    (1, 1, 4)])
def test_split_plan_covers_every_entry_once(items, mb, target):
    ce, nc = split_plan(items, mb, target)
    covered = np.zeros(mb, int)
    for c in range(nc):
        covered[c * ce:min((c + 1) * ce, mb)] += 1
    assert (covered == 1).all()
    assert (nc - 1) * ce < mb <= nc * ce
    assert nc == 1 or ce >= KV_WARPS or mb < KV_WARPS * nc
    if items >= target:
        assert nc == 1


@pytest.mark.parametrize("items,slots,split", [
    (256, 792, True),    # 8 slots x 32 heads on a card holding 792 CTAs
    (256, 264, False),   # the same items fill half the resident CTAs
    (1024, 528, False),  # 32 slots: one chunk
    (64, 528, True)])    # GQA: 8 slots x 8 kv heads
def test_walk_plan_splits_only_a_card_left_half_empty(items, slots, split):
    """The standalone kernel's plan: one chunk covering the whole table
    when the items fill at least half of the card's resident CTAs, else
    the split plan up to the resident CTAs."""
    mb = 64
    ce, nc = walk_plan(items, mb, slots)
    assert (nc > 1) == split
    assert (ce, nc) == (split_plan(items, mb, slots) if split else (mb, 1))
    assert (nc - 1) * ce < mb <= nc * ce


def _split_walk(q, k, v, table, lengths, scale, ce, nc):
    """The kernel's split walk in torch: chunk c of a row covers table
    entries [c ce, (c + 1) ce) up to ceil(length / bs) (a chunk past it
    takes no part; chunk 0 always does), leaves (m, l, acc) over its
    rows, and the chunks merge in order, each rescaled by exp(m_c - M).
    q (b, h, d); k, v the dequantized (nb, bs, kvh, d) arenas."""
    b, h, d = q.shape
    _, bs, kvh, _ = k.shape
    mb = table.shape[1]
    g = h // kvh
    out = torch.empty(b, h, d)
    for r in range(b):
        L = int(lengths[r])
        nblk = min(-(-L // bs), mb)
        for head in range(h):
            kh = head // g
            parts = []
            for c in range(nc):
                jb, je = c * ce, min((c + 1) * ce, nblk)
                if c > 0 and jb >= nblk:
                    continue
                m = torch.tensor(NEG)
                l_, acc = torch.tensor(0.0), torch.zeros(d)
                if je > jb:
                    blks = table[r, jb:je].long()
                    kr = k[blks, :, kh].reshape(-1, d)
                    vr = v[blks, :, kh].reshape(-1, d)
                    pos = jb * bs + torch.arange(kr.shape[0])
                    s = (kr @ q[r, head]) * scale
                    s = torch.where(pos < L, s, torch.tensor(NEG))
                    m = torch.maximum(m, s.max())
                    p = torch.where(pos < L, torch.exp(s - m), 0.0)
                    l_, acc = p.sum(), p @ vr
                parts.append((m, l_, acc))
            M = max(p_[0] for p_ in parts)
            f = [torch.exp(m - M) for m, _, _ in parts]
            out[r, head] = sum(fi * a for fi, (_, _, a) in zip(f, parts)) \
                / sum(fi * l_ for fi, (_, l_, _) in zip(f, parts))
    return out


@pytest.mark.parametrize("arena", ["fp32", "int8"])
@pytest.mark.parametrize("ce", [5, 16, 40])
def test_split_walk_merge_matches_the_references(arena, ce):
    """Chunks of 5, 16 and 40 entries over a 37-entry table (16 and 40
    leave a short or a single chunk), GQA 2 of 4 heads, lengths 1, on a
    chunk boundary, one past it, the whole table and past the table:
    the merge equals the port's and the JAX package's gathered-dense
    references within 1e-6."""
    b, h, kvh, d, bs, mb = 5, 4, 2, 32, 4, 37
    nc = -(-mb // ce)
    rs = np.random.RandomState(ce)
    nb = 1 + b * mb
    q = rs.randn(b, h, d).astype(np.float32)
    ka = rs.randn(nb, bs, kvh, d).astype(np.float32)
    va = rs.randn(nb, bs, kvh, d).astype(np.float32)
    lengths = np.array([1, ce * bs, ce * bs + 1, mb * bs, mb * bs + 9],
                       np.int32)
    table = np.zeros((b, mb), np.int32)
    perm = list(rs.permutation(np.arange(1, nb)))
    for r in range(b):
        n = min(-(-int(lengths[r]) // bs), mb)
        table[r, :n] = perm[:n]
        perm = perm[n:]
    scale = 1 / math.sqrt(d)
    tq, tt, tl = (torch.from_numpy(a) for a in (q, table, lengths))
    if arena == "int8":
        kc, ks = quantize_kv(torch.from_numpy(ka))
        vc, vs = quantize_kv(torch.from_numpy(va))
        k, v = dequantize_kv(kc, ks), dequantize_kv(vc, vs)
        want = paged_attention_int8_reference(tq[:, None], kc, vc, ks, vs,
                                              tt, tl, scale=scale)[:, 0]
        jax_want = jpa.paged_attention_int8_reference(
            jnp.asarray(q[:, None]), jnp.asarray(kc.numpy()),
            jnp.asarray(vc.numpy()), jnp.asarray(ks.numpy()),
            jnp.asarray(vs.numpy()), jnp.asarray(table),
            jnp.asarray(lengths), scale=scale)[:, 0]
    else:
        k, v = torch.from_numpy(ka), torch.from_numpy(va)
        want = paged_attention_reference(tq[:, None], k, v, tt, tl,
                                         scale=scale)[:, 0]
        jax_want = jpa.paged_attention_reference(
            jnp.asarray(q[:, None]), jnp.asarray(ka), jnp.asarray(va),
            jnp.asarray(table), jnp.asarray(lengths), scale=scale)[:, 0]
    got = _split_walk(tq, k, v, tt, tl, scale, ce, nc)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got - torch.from_numpy(np.array(jax_want)))
                 .abs().max()) <= 1e-6
