"""Port training-step kernels against the JAX package, on the CPU.

The plain versions of the flash attention (forward, dq, dkv), RoPE and
AdamW kernels, the RMSNorm gradient and the fused head + cross-entropy
are held against the JAX package's Pallas kernels in interpret mode (or
its jnp code where it has no kernel), on the same numpy inputs. The CUDA
kernels themselves run only on a GPU (test_torch_port_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.nn import fused_ce as jce
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused as jfused

from paddle_tpu_torch.incubate.nn import fused_linear_cross_entropy
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.fused import (fused_adamw, fused_rope, rms_norm,
                                        rope_reference)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(jfused, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


class TestRMSNormGrad:
    @pytest.mark.parametrize("shape", [(2, 8, 64), (5, 128)])
    def test_grad_matches_jax(self, interpret, shape):
        """x.grad and weight.grad through the port's autograd Function
        against jax.grad of the Pallas ``fused_rms_norm`` (its backward
        is the jnp VJP of ``_rms_ref``)."""
        rs = np.random.RandomState(0)
        x = rs.randn(*shape).astype(np.float32)
        w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
        ct = rs.randn(*shape).astype(np.float32)

        def jloss(xv, wv):
            return jnp.sum(jfused.fused_rms_norm(xv, wv, 1e-5) * ct)

        jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                   jnp.asarray(w))
        xt, wt = _t(x, True), _t(w, True)
        (rms_norm(xt, wt, 1e-5) * _t(ct)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jgw),
                                   atol=1e-5, rtol=1e-5)


FLASH_CASES = {
    "causal": dict(b=2, s=128, h=4, hk=4, d=64, causal=True, window=None),
    "gqa": dict(b=2, s=64, h=4, hk=2, d=32, causal=True, window=None),
    "window16": dict(b=2, s=128, h=4, hk=4, d=32, causal=True, window=16),
    "noncausal": dict(b=2, s=64, h=4, hk=4, d=64, causal=False,
                      window=None),
}


def _flash_inputs(c, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(c["b"], c["s"], c["h"], c["d"]).astype(np.float32)
    k = rs.randn(c["b"], c["s"], c["hk"], c["d"]).astype(np.float32)
    v = rs.randn(c["b"], c["s"], c["hk"], c["d"]).astype(np.float32)
    wo = rs.randn(c["b"], c["s"], c["h"], c["d"]).astype(np.float32)
    wl = rs.randn(c["b"], c["h"], c["s"]).astype(np.float32)
    return q, k, v, wo, wl


def _masked_scores(q, k, v, is_causal, scale, window):
    kr, vr = tfa._repeat_kv(q, k, v)
    s = tfa._scores(q, kr) * scale
    band = tfa._band(q.shape[1], k.shape[1], is_causal or window is not None,
                     window, q.device)
    if band is not None:
        s = s.masked_fill(~band, float("-inf"))
    return s, kr, vr


def _kernel_order_fwd(q, k, v, *, is_causal, scale, window, tile=64,
                      skip_tile=None):
    """o as a bf16 forward kernel with ``tile``-key tiles rounds it: per
    tile, p = exp(s - running max) in fp32, rounded to bf16 for the PV
    product, the row sum kept in fp32; o divided by it and rounded once.
    (The PR 2 kernels ran 64-key tiles, the wgmma kernels run 128.)"""
    s, _, vr = _masked_scores(q, k, v, is_causal, scale, window)
    b, h, sq, sk = s.shape
    m = torch.full((b, h, sq), float("-inf"))
    row_sum = torch.zeros(b, h, sq)
    acc = torch.zeros(b, h, sq, q.shape[3])
    for t in range(0, sk, tile):
        if t // tile == skip_tile:
            continue
        st = s[..., t:t + tile]
        m_new = torch.maximum(m, st.amax(-1))
        neg = m_new == float("-inf")
        p = torch.where(neg[..., None], 0.0, torch.exp(st - m_new[..., None]))
        alpha = torch.where(neg, 1.0, torch.exp(m - m_new))
        pv = torch.einsum("bhqk,bkhd->bhqd", p.bfloat16().float(),
                          vr[:, t:t + tile].float())
        acc = acc * alpha[..., None] + pv
        row_sum = row_sum * alpha + p.sum(-1)
        m = m_new
    o = acc / row_sum.clamp_min(1e-30)[..., None]
    return o.transpose(1, 2).to(q.dtype)


def _kernel_order_bwd(q, k, v, do, lse, delta, *, is_causal, scale, window,
                      tile=64):
    """dq, dk, dv as the bf16 backward kernels round them: p and ds in
    fp32, rounded to bf16 for the products; dq summed in fp32 over
    ``tile``-key tiles and dk, dv over ``tile``-row q tiles (both kernel
    designs stream 64-wide tiles), rounded once."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    s, kr, vr = _masked_scores(q, k, v, is_causal, scale, window)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    ds = (p * (dp - delta[..., None]) * scale).bfloat16().float()
    p = p.bfloat16().float()
    dq = sum(torch.einsum("bhqk,bkhd->bqhd", ds[..., t:t + tile],
                          kr[:, t:t + tile].float())
             for t in range(0, sk, tile))
    dk = sum(torch.einsum("bhqk,bqhd->bkhd", ds[:, :, t:t + tile],
                          q[:, t:t + tile].float())
             for t in range(0, sq, tile))
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", p[:, :, t:t + tile],
                          do[:, t:t + tile].float())
             for t in range(0, sq, tile))
    dk = dk.reshape(b, sk, hk, h // hk, d).sum(3)
    dv = dv.reshape(b, sk, hk, h // hk, d).sum(3)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


class TestFlashAttention:
    @pytest.mark.parametrize("name", list(FLASH_CASES))
    def test_forward_and_grads_match_jax_kernels(self, interpret, name):
        """o and lse (1e-5), and dq/dk/dv with a nonzero lse cotangent
        (1e-4: the backward passes sum in another order), of the
        reference under torch's autograd and of the port's
        ``flash_block`` (its plain forward/dq/dkv pieces) against the
        JAX ``flash_block`` running its three Pallas kernels."""
        c = FLASH_CASES[name]
        q, k, v, wo, wl = _flash_inputs(c, seed=len(name))
        scale = 1.0 / np.sqrt(c["d"])
        kw = dict(is_causal=c["causal"], scale=scale, window=c["window"])

        def jloss(qv, kv, vv):
            o, lse = jfa.flash_block(qv, kv, vv, **kw)
            return jnp.sum(o * wo) + jnp.sum(lse * wl), (o, lse)

        (_, (jo, jlse)), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for fn in (tfa.flash_attention_reference, tfa.flash_block):
            qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
            o, lse = fn(qt, kt, vt, **kw)
            ((o * _t(wo)).sum() + (lse * _t(wl)).sum()).backward()
            np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                                       atol=1e-5)
            np.testing.assert_allclose(lse.detach().numpy(),
                                       np.asarray(jlse), atol=1e-5)
            for got, want in zip((qt.grad, kt.grad, vt.grad), jgrads):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           atol=1e-4)

    @pytest.mark.parametrize("name,tile", [
        pytest.param(n, t, id=n if t == 64 else f"{n}-tile{t}")
        for t in (64, 128) for n in ("causal", "gqa", "window16")])
    def test_bf16_tolerance_covers_the_kernels_rounding(self, name, tile):
        """The per-element bf16 tolerance that holds the CUDA kernels
        against their plain versions on the card: the kernels' rounding
        sites, emulated here in torch (``tile``-key tiles with a running
        max: 64 for the PR 2 kernels, 128 for the wgmma forward; the
        unnormalised probabilities rounded to bf16 before the PV
        product, ds and p rounded before the backward's products, fp32
        sums over 64-wide tiles), stay within it of the plain versions;
        the same emulation with one kv tile left out of the forward does
        not. At tile 128 the sequence is 300, so the running max spans
        three tiles and a ragged end."""
        c = FLASH_CASES[name]
        if tile == 128:
            c = dict(c, s=300)
        q, k, v, do, _ = (_t(a).to(torch.bfloat16)
                          for a in _flash_inputs(c, seed=7))
        kw = dict(is_causal=c["causal"], scale=1.0 / np.sqrt(c["d"]),
                  window=c["window"])
        po, lse = tfa.flash_attention_reference(q, k, v, **kw)
        o = _kernel_order_fwd(q, k, v, tile=tile, **kw)
        delta = ((do * o).float().sum(-1).transpose(1, 2)
                 - 0.1).contiguous()
        plain = (po,) + tfa.flash_attention_bwd_reference(
            q, k, v, do, lse, delta, **kw)
        got = (o,) + _kernel_order_bwd(q, k, v, do, lse, delta, **kw)
        spread = tfa.bf16_rounding_spread(q, k, v, do, lse, delta, **kw)
        for i, (g, w, sp) in enumerate(zip(got, plain, spread)):
            tol = tfa.bf16_tolerance(g, w, sp, 2 if i == 0 else 1)
            diff = (g.float() - w.float()).abs()
            assert bool((diff <= tol).all()), (i, float((diff / tol).max()))
        if c["s"] > tile:
            short = _kernel_order_fwd(q, k, v, tile=tile, skip_tile=1, **kw)
            tol = tfa.bf16_tolerance(short, po, spread[0], 2)
            assert not bool(((short.float() - po.float()).abs()
                             <= tol).all())

    def test_sdpa_routes(self):
        """No mask and no dropout: the flash route, equal to the
        reference; a bool mask: the plain ``_xla_sdpa`` sequence, equal
        to the JAX one."""
        c = FLASH_CASES["gqa"]
        q, k, v, _, _ = _flash_inputs(c, seed=3)
        got = tfa.sdpa(_t(q), _t(k), _t(v), is_causal=True)
        want = np.asarray(jfa._xla_sdpa(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), is_causal=True))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        mask = np.random.RandomState(4).rand(c["s"], c["s"]) > 0.3
        np.fill_diagonal(mask, True)
        got = tfa.sdpa(_t(q), _t(k), _t(v), mask=_t(mask))
        want = np.asarray(jfa._xla_sdpa(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v),
                                        mask=jnp.asarray(mask)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    def test_causal_needs_equal_lengths(self):
        q = torch.randn(1, 8, 2, 16)
        k = torch.randn(1, 16, 2, 16)
        with pytest.raises(ValueError, match="sq == sk"):
            tfa.flash_block(q, k, k, is_causal=True)
        o, lse = tfa.flash_block(q, k, k)          # non-causal is fine
        assert o.shape == q.shape and lse.shape == (1, 2, 8)


def _rope_case(shape_q, shape_k, seed):
    rs = np.random.RandomState(seed)
    s, d = shape_q[1], shape_q[3]
    q = rs.randn(*shape_q).astype(np.float32)
    k = rs.randn(*shape_k).astype(np.float32)
    # random tables: the kernel must not assume equal halves
    cos = rs.randn(s, d).astype(np.float32)
    sin = rs.randn(s, d).astype(np.float32)
    return q, k, cos, sin


class TestRope:
    @pytest.mark.parametrize("hk", [4, 2], ids=["equal", "gqa"])
    def test_forward_and_grad_match_jax_kernel(self, interpret, hk):
        q, k, cos, sin = _rope_case((2, 16, 4, 32), (2, 16, hk, 32), hk)
        rs = np.random.RandomState(9)
        wq, wk = rs.randn(*q.shape), rs.randn(*k.shape)

        def jloss(qv, kv):
            oq, ok = jfused.fused_rope(qv, kv, jnp.asarray(cos),
                                       jnp.asarray(sin))
            return jnp.sum(oq * wq) + jnp.sum(ok * wk), (oq, ok)

        (_, (jq, jk)), (gq, gk) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(q),
                                                 jnp.asarray(k))
        qt, kt = _t(q, True), _t(k, True)
        oq, ok = fused_rope(qt, kt, _t(cos), _t(sin))
        ((oq * _t(wq).float()).sum() + (ok * _t(wk).float()).sum()
         ).backward()
        np.testing.assert_allclose(oq.detach().numpy(), np.asarray(jq),
                                   atol=1e-6)
        np.testing.assert_allclose(ok.detach().numpy(), np.asarray(jk),
                                   atol=1e-6)
        np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq),
                                   atol=1e-5)
        np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk),
                                   atol=1e-5)

    def test_bf16_plain_matches_jax_reference(self):
        """In bf16 the plain version rounds each product as the JAX
        ``_rope_ref`` does: equal to it within one bf16 ulp."""
        q, k, cos, sin = _rope_case((1, 8, 2, 32), (1, 8, 2, 32), 5)
        bf = jnp.bfloat16
        jq, jk = jfused._rope_ref(jnp.asarray(q, bf), jnp.asarray(k, bf),
                                  jnp.asarray(cos, bf), jnp.asarray(sin, bf))
        tq, tk = rope_reference(*(_t(a).to(torch.bfloat16)
                                  for a in (q, k, cos, sin)))
        for got, want in ((tq, jq), (tk, jk)):
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                rtol=2.0 ** -7, atol=1e-6)


class TestAdamW:
    @pytest.mark.parametrize("step", [1, 10])
    @pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
    def test_matches_jax_kernel(self, interpret, pdtype, step):
        """At 1536 elements (JAX takes its jnp path below 1024): p, m and
        v after one update equal the JAX Pallas kernel's to 1e-6
        relative, bf16 p within one bf16 ulp."""
        rs = np.random.RandomState(step)
        n = 1536
        p = (0.02 * rs.randn(n)).astype(np.float32)
        g = rs.randn(n).astype(np.float32)
        m = (0.1 * rs.randn(n)).astype(np.float32)
        v = (0.01 * rs.rand(n)).astype(np.float32)
        jdt = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
        hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01, step=step)
        # the step as the JAX optimizer passes it: an int32 array, so the
        # bias corrections are fp32
        jp, jm, jv = jfused.fused_adamw(
            jnp.asarray(p, jdt), jnp.asarray(g), jnp.asarray(m),
            jnp.asarray(v), **dict(hp, step=jnp.asarray(step, jnp.int32)))
        tp = torch.from_numpy(p).to(getattr(torch, pdtype))
        tm, tv = torch.from_numpy(m.copy()), torch.from_numpy(v.copy())
        out = fused_adamw(tp, torch.from_numpy(g), tm, tv, **hp)
        assert out[0] is tp and out[1] is tm        # updated in place
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                                   atol=1e-8)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-10)
        if pdtype == "float32":
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                       rtol=1e-6, atol=1e-9)
        else:
            np.testing.assert_allclose(
                tp.float().numpy(), np.asarray(jp.astype(jnp.float32)),
                rtol=2.0 ** -8, atol=0)


class TestFusedHeadCE:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, dtype):
        """Vocab 500 in 16 chunks (the last one short), some tokens
        ignored: the loss and dh/dw against the JAX custom VJP. fp32 to
        1e-5; bf16 inputs (fp32 logits and backward products on both
        sides) to 1e-5 on the loss and one bf16 ulp on the grads."""
        rs = np.random.RandomState(0)
        n, d, v = 24, 32, 500
        h = rs.randn(n, d).astype(np.float32)
        w = (0.1 * rs.randn(v, d)).astype(np.float32)
        labels = rs.randint(0, v, (n,)).astype(np.int32)
        labels[[3, 7, 20]] = -100
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
        hj, wj = jnp.asarray(h, jdt), jnp.asarray(w, jdt)
        jl, (gh, gw) = jax.value_and_grad(
            lambda a, b: jce.fused_linear_cross_entropy(
                a, b, jnp.asarray(labels), 16, -100),
            argnums=(0, 1))(hj, wj)
        tdt = getattr(torch, dtype)
        ht = torch.from_numpy(h).to(tdt).requires_grad_()
        wt = torch.from_numpy(w).to(tdt).requires_grad_()
        loss = fused_linear_cross_entropy(ht, wt, torch.from_numpy(labels),
                                          num_chunks=16)
        loss.backward()
        assert loss.dtype == torch.float32
        np.testing.assert_allclose(float(loss.detach()), float(jl),
                                   rtol=1e-5)
        tol = dict(atol=1e-5) if dtype == "float32" \
            else dict(atol=1e-6, rtol=2.0 ** -7)
        for got, want in ((ht.grad, gh), (wt.grad, gw)):
            assert got.dtype == tdt
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want.astype(jnp.float32)),
                                       **tol)
