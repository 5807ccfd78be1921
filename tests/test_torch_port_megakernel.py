"""Port decode-layer megakernel route and residual RMSNorm against the
JAX package.

The port's plain version of the megakernel (``decode_layer_reference``)
is held against the JAX ``decode_layer_reference`` and the JAX Pallas
``decode_layer_paged_kernel`` in interpret mode on the shapes of
``tests/test_megakernel.py`` ``TestMegaKernelInterpret._args``, for the
fp32 and int8 arenas, and against the port's own unfused
``LlamaDecoderLayer`` cache path, so the oracle cannot drift. Greedy
streams of ``PagedEngine(megakernel=True)`` must be token-identical to
the JAX paged engine with the megakernel off (its fused engine is the
unfused math by construction, ``decode_layer.py:38-43``), and the
routing and the card kernel's gate are pinned. ``fused_rms_norm`` with
a residual matches JAX's in values and in both gradients.

The CUDA megakernel itself runs only on a GPU: its tests are in
``test_torch_port_gpu.py``. One JAX paged engine per arena type serves
the whole file; the persistent compile cache is off while they exist
(two paged backends in one process, ``tests/test_resilience.py``
``_no_compile_cache``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.ops.pallas import decode_layer as jdl
from paddle_tpu.ops.pallas import fused as jfused
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer
from test_torch_port_kernels import interpret  # noqa: F401  (fixture)

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.ops import decode_layer as tdl
from paddle_tpu_torch.ops.fused import (fused_rms_norm, rms_norm_residual,
                                        rms_norm_residual_reference)
from paddle_tpu_torch.ops.paged_attention import quantize_kv
from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server

ENGINE_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                 prefill_chunk=8)
LIN = (1, 2, 3, 4, 6, 7, 8)     # the linear weights in WEIGHT_NAMES order


def _args(mode, seed=0):
    """``TestMegaKernelInterpret._args`` of tests/test_megakernel.py as
    numpy: S = 3, d = 128, h = 4, kvh = 2, dh = 32, ff = 384, 12 blocks
    of 8, 4 table entries, 64 RoPE positions; weights (in, out)."""
    rs = np.random.RandomState(seed)
    S, d, h, kvh, dh, ff = 3, 128, 4, 2, 32, 384
    NB, BS, MB, P = 12, 8, 4, 64

    def f32(*shape, s=1.0):
        return (s * rs.randn(*shape)).astype(np.float32)

    def w(*shape):
        return f32(*shape, s=1.0 / np.sqrt(shape[0]))

    x = f32(S, 1, d)
    pos = np.asarray([5, 13, 26], np.int32)
    tbl = rs.randint(1, NB, (S, MB)).astype(np.int32)
    wts = (f32(d), w(d, h * dh), w(d, kvh * dh), w(d, kvh * dh),
           w(h * dh, d), f32(d), w(d, ff), w(d, ff), w(ff, d))
    if mode == "paged_int8":
        kc, ks = jpa.quantize_kv(jnp.asarray(f32(NB, BS, kvh, dh, s=3)))
        vc, vs = jpa.quantize_kv(jnp.asarray(f32(NB, BS, kvh, dh)))
        cache = tuple(np.asarray(a) for a in (kc, vc, ks, vs))
    else:
        cache = (f32(NB, BS, kvh, dh), f32(NB, BS, kvh, dh))
    return (x, f32(P, dh), f32(P, dh), 1e-5, 1e-5, pos, tbl) + cache + wts


def _port_reference(mode, args):
    """The port's plain version on torch copies of ``args`` (its arena
    is updated in place): returns (out, arena tensors)."""
    targs = [torch.from_numpy(a.copy()) if isinstance(a, np.ndarray) else a
             for a in args]
    got = tdl.decode_layer_reference(mode, *targs)
    assert all(g is t for g, t in zip(got[1:], tdl.split_args(
        mode, targs)[1]))                      # the arena, in place
    return got


def _assert_outputs(mode, want, got):
    """Outputs within 1e-5. Arenas: the k and v written are products
    r1 @ wk that XLA and torch sum in another order, so fp32 arenas
    agree to a few ulp (1e-5 here) and int8 scales (the raw absmax of
    each row) to 1e-6 relative; the int8 codes are bit-equal."""
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5, rtol=1e-5)
    for i, (a, b) in enumerate(zip(want[1:], got[1:])):
        if mode == "paged_int8" and i < 2:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        elif mode == "paged_int8":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=0,
                                       rtol=1e-6)
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                       rtol=1e-5)


class TestPlainVersion:
    @pytest.mark.parametrize("mode", ["paged", "paged_int8"])
    def test_matches_jax_reference(self, mode):
        args = _args(mode)
        want = jdl.decode_layer_reference(
            mode, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args])
        _assert_outputs(mode, want, _port_reference(mode, args))

    @pytest.mark.parametrize("mode", ["paged", "paged_int8"])
    def test_matches_jax_kernel_in_interpret_mode(self, interpret, mode):
        args = _args(mode)
        want = jdl.decode_layer_paged_kernel(
            mode, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args])
        _assert_outputs(mode, want, _port_reference(mode, args))

    @pytest.mark.parametrize("mode", ["paged", "paged_int8"])
    def test_wrapper_takes_out_in_weights_on_cpu(self, mode):
        """The wrapper takes nn.Linear's (out, in) weights and, on a CPU
        tensor, runs the plain version (on transposed views, whose
        products sum in another order): the same function, no launch."""
        args = _args(mode)
        fixed, cache, wts = tdl.split_args(mode, args)
        t_wts = [torch.from_numpy(np.ascontiguousarray(w.T) if i in LIN
                                  else w) for i, w in enumerate(wts)]
        t_fixed = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in fixed]
        t_cache = [torch.from_numpy(c.copy()) for c in cache]
        ops.reset_launch_counts()
        got = tdl.decode_layer(mode, *t_fixed, *t_cache, *t_wts)
        assert ops.launch_counts()["decode_layer"] == 0
        assert ops.launch_counts()["decode_layer_int8"] == 0
        want = _port_reference(mode, args)
        _assert_outputs(mode, [t.numpy() for t in want], got)

    @pytest.mark.parametrize("mode", ["paged", "paged_int8"])
    def test_matches_the_models_unfused_layer(self, mode):
        """The oracle cannot drift: on llama_tiny weights the plain
        version reproduces the port's own unfused decode layer (the cache
        path through ``cached_attention``), output and arena, with one
        slot's position past the table routed to the trash block."""
        model = LlamaForCausalLM(llama_tiny_config(), device="cpu", seed=4)
        layer = model.llama.layers[1]
        cfg = model.config
        rs = np.random.RandomState(7)
        S, d, kvh, dh = 3, cfg.hidden_size, cfg.num_key_value_heads, \
            cfg.head_dim
        NB, BS, MB = 10, 8, 4
        x = torch.from_numpy(rs.randn(S, 1, d).astype(np.float32))
        tbl = torch.from_numpy(rs.randint(1, NB, (S, MB)).astype(np.int32))
        pos = torch.tensor([3, 11, MB * BS + 2], dtype=torch.int32)
        if mode == "paged_int8":
            kc, ks = quantize_kv(torch.randn(NB, BS, kvh, dh))
            vc, vs = quantize_kv(torch.randn(NB, BS, kvh, dh))
            cache = (kc, vc, ks, vs)
        else:
            cache = (torch.randn(NB, BS, kvh, dh),
                     torch.randn(NB, BS, kvh, dh))
        c_model = tuple(c.clone() for c in cache)
        c_ref = tuple(c.clone() for c in cache)
        wts = layer._decode_layer_weights()
        with torch.no_grad():
            want = layer(x, model.rope_cos, model.rope_sin, c_model, pos,
                         tbl)
            got = tdl.decode_layer_reference(
                mode, x, model.rope_cos, model.rope_sin,
                layer.input_layernorm.eps,
                layer.post_attention_layernorm.eps, pos, tbl, *c_ref,
                *[w.t() if i in LIN else w for i, w in enumerate(wts)])
        np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
        for a, b in zip(c_model, c_ref):
            np.testing.assert_array_equal(b[1:].numpy(), a[1:].numpy())


class TestGate:
    def _call(self, mode="paged", S=3, dtype=torch.float32, dh=32,
              ff=384):
        """x, cache and (out, in) weights of a tiny layer."""
        d, h, kvh = 128, 4, 2
        x = torch.zeros(S, 1, d, dtype=dtype)
        shape = (6, 8, kvh, dh)
        if mode == "paged_int8":
            cache = (torch.zeros(shape, dtype=torch.int8),) * 2 \
                + (torch.zeros(shape[:-1]),) * 2
        else:
            cache = (torch.zeros(shape),) * 2
        wts = (torch.ones(d, dtype=dtype),
               torch.zeros(h * dh, d, dtype=dtype),
               torch.zeros(kvh * dh, d, dtype=dtype),
               torch.zeros(kvh * dh, d, dtype=dtype),
               torch.zeros(d, h * dh, dtype=dtype),
               torch.ones(d, dtype=dtype), torch.zeros(ff, d, dtype=dtype),
               torch.zeros(ff, d, dtype=dtype),
               torch.zeros(d, ff, dtype=dtype))
        return x, cache, wts

    @pytest.mark.parametrize("mode", ["paged", "paged_int8"])
    def test_takes_the_paged_fp32_layer(self, mode):
        assert tdl.kernel_viable(mode, *self._call(mode))
        assert tdl.kernel_viable(mode, *self._call(mode, S=32))

    @pytest.mark.parametrize("case", ["bf16", "window", "odd_dh", "dense",
                                      "too_many_slots", "ff_not_mult_4"])
    def test_refusals(self, case):
        mode, kw, window = "paged", {}, None
        if case == "bf16":
            kw = dict(dtype=torch.bfloat16)
        elif case == "window":
            window = 16
        elif case == "odd_dh":
            kw = dict(dh=31)
        elif case == "dense":
            mode = "dense"
        elif case == "too_many_slots":
            kw = dict(S=33)
        else:
            kw = dict(ff=386)
        x, cache, wts = self._call(**kw)
        assert not tdl.kernel_viable(mode, x, cache, wts, window=window)

    def test_dense_mode_is_not_ported(self):
        x, cache, wts = self._call()
        with pytest.raises(NotImplementedError, match="paged"):
            tdl.decode_layer_reference(
                "dense", x, torch.zeros(64, 32), torch.zeros(64, 32), 1e-5,
                1e-5, torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32), *cache, *wts)


@pytest.fixture(scope="module")
def engines():
    """llama_tiny with the JAX weights in both packages, and one JAX
    paged engine per arena type with the megakernel off."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    jes = {kv8: JaxEngine(jm, paged=True, kv_int8=kv8, megakernel=False,
                          **ENGINE_KW) for kv8 in (False, True)}
    yield jes, tm
    jax.config.update("jax_enable_compilation_cache", True)


def _serve(server_cls, sched_cls, engine, reqs, budget=8):
    engine.reset()
    srv = server_cls(engine, sched_cls(prefill_token_budget=budget))
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    res = srv.run_until_idle()
    engine.manager.assert_consistent()
    assert not engine.manager._ref
    return [res[r] for r in rids]


def _reqs(seed, lens=(5, 9, 12, 5, 9), news=(6, 4, 7, 5, 6)):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 512, (L,)).astype(np.int32), n)
            for L, n in zip(lens, news)]


class TestMegakernelEngine:
    @pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
    def test_streams_match_jax_unfused_engine(self, engines, kv_int8):
        jes, tm = engines
        reqs = _reqs(3)
        want = _serve(JaxServer, JaxScheduler, jes[kv_int8], reqs)
        te = PagedEngine(tm, device="cpu", kv_int8=kv_int8, megakernel=True,
                         **ENGINE_KW)
        assert te.megakernel() and te.megakernel_rewrites() == 0
        ops.reset_launch_counts()
        got = _serve(Server, Scheduler, te, reqs)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        L = tm.config.num_hidden_layers
        assert te.megakernel_rewrites() == L
        assert te.megakernel_kernel_calls() == 0       # the CPU
        assert ops.launch_counts()["decode_layer"] == 0
        assert ops.launch_counts()["decode_layer_int8"] == 0

    def test_env_routes_the_engine(self, engines, monkeypatch):
        _, tm = engines
        monkeypatch.setenv("PT_SERVING_MEGAKERNEL", "1")
        on = PagedEngine(tm, device="cpu", **ENGINE_KW)
        off = PagedEngine(tm, device="cpu", megakernel=False, **ENGINE_KW)
        monkeypatch.setenv("PT_SERVING_MEGAKERNEL", "0")
        env_off = PagedEngine(tm, device="cpu", **ENGINE_KW)
        assert on.megakernel() and not off.megakernel() \
            and not env_off.megakernel()
        reqs = _reqs(5, (7, 11), (5, 6))
        a = _serve(Server, Scheduler, on, reqs)
        b = _serve(Server, Scheduler, off, reqs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert on.megakernel_rewrites() == tm.config.num_hidden_layers
        assert off.megakernel_rewrites() == 0 \
            and off.megakernel_kernel_calls() == 0

    def test_prefill_chunks_stay_unfused(self, engines):
        """Only s = 1 decode steps go through the fused call: a prefill
        chunk through the same request object routes no layer."""
        _, tm = engines
        fused = tdl.FusedDecode()
        cache = tm.init_paged_kv_cache(8, 8)
        from paddle_tpu_torch.models import decode_step_logprobs
        decode_step_logprobs(tm, torch.arange(1, 9)[None], cache,
                             torch.tensor([0], dtype=torch.int32),
                             torch.tensor([[3, 0, 0, 0]], dtype=torch.int32),
                             last_index=7, fused_decode=fused)
        assert fused.rewrites == 0
        decode_step_logprobs(tm, torch.tensor([[9]]), cache,
                             torch.tensor([8], dtype=torch.int32),
                             torch.tensor([[3, 5, 0, 0]], dtype=torch.int32),
                             fused_decode=fused)
        assert fused.rewrites == tm.config.num_hidden_layers
        assert fused.kernel_calls == 0

    def test_a_model_that_routes_no_layer_fails_loudly(self, engines,
                                                       monkeypatch):
        _, tm = engines
        from paddle_tpu_torch.models.llama import LlamaDecoderLayer
        monkeypatch.setattr(LlamaDecoderLayer, "_fusable",
                            lambda self, *a: False)
        te = PagedEngine(tm, device="cpu", megakernel=True, **ENGINE_KW)
        with pytest.raises(RuntimeError, match="no decode layer"):
            _serve(Server, Scheduler, te, _reqs(6, (5,), (4,)))


def _rms_res_case(shape, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    w = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    ct = (rs.randn(*shape).astype(np.float32),
          rs.randn(*shape).astype(np.float32))
    return x, r, w, ct


def _jax_rms_res(x, r, w, ct):
    """JAX values and (dx, dr, dw) of sum(out * ct0 + s * ct1)."""
    def f(a, b, c):
        out, s = jfused.fused_rms_norm(a, c, 1e-5, residual=b)
        return jnp.sum(out * ct[0]) + jnp.sum(s * ct[1])

    out, s = jfused.fused_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                   residual=jnp.asarray(r))
    grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(r),
                                           jnp.asarray(w))
    return [np.asarray(a) for a in (out, s) + tuple(grads)]


def _port_rms_res(x, r, w, ct):
    xt, rt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, r, w))
    out, s = fused_rms_norm(xt, wt, 1e-5, residual=rt)
    loss = (out * torch.from_numpy(ct[0])).sum() \
        + (s * torch.from_numpy(ct[1])).sum()
    loss.backward()
    return [t.detach().numpy() for t in (out, s, xt.grad, rt.grad,
                                         wt.grad)]


class TestRMSNormResidual:
    @pytest.mark.parametrize("shape", [(4, 16, 64), (3, 128), (8, 512)])
    def test_values_and_grads_match_jax_reference_route(self, shape):
        case = _rms_res_case(shape, seed=len(shape) + shape[-1])
        want = _jax_rms_res(*case)
        got = _port_rms_res(*case)
        np.testing.assert_array_equal(got[1], want[1])      # the sum
        for a, b in zip(want[:1] + want[2:], got[:1] + got[2:]):
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("shape", [(3, 128), (16, 256)])
    def test_values_and_grads_match_jax_pallas_interpret(self, interpret,
                                                         shape):
        """JAX's residual route under ``_pallas_ok()``: the
        ``_rms_res_kernel`` forward in interpret mode, the ``_rms_ref``
        VJP backward."""
        case = _rms_res_case(shape, seed=shape[0])
        want = _jax_rms_res(*case)
        got = _port_rms_res(*case)
        np.testing.assert_array_equal(got[1], want[1])
        for a, b in zip(want[:1] + want[2:], got[:1] + got[2:]):
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)

    def test_bf16_sum_in_the_inputs_dtype(self):
        """The sum is formed in x's dtype before the fp32 statistics
        (JAX's order): bit-equal to JAX's bf16 sum, the normed output
        within one bf16 ulp."""
        x, r, w, _ = _rms_res_case((6, 256), seed=2)
        jx, jr, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, r, w))
        jout, js = jfused._rms_ref(jx, jw, 1e-5, jr)
        tx, tr, tw = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (x, r, w))
        out, s = rms_norm_residual(tx, tr, tw, 1e-5)
        assert out.dtype == s.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            s.float().numpy(), np.asarray(js.astype(jnp.float32)))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(jout.astype(jnp.float32)),
                                   rtol=2.0 ** -7, atol=1e-6)

    def test_cpu_runs_plain_and_no_residual_is_rms_norm(self):
        x, r, w, _ = _rms_res_case((5, 64), seed=1)
        tx, tr, tw = (torch.from_numpy(a) for a in (x, r, w))
        ops.reset_launch_counts()
        out, s = fused_rms_norm(tx, tw, 1e-5, residual=tr)
        want = rms_norm_residual_reference(tx, tr, tw, 1e-5)
        torch.testing.assert_close(out, want[0], rtol=0, atol=0)
        torch.testing.assert_close(s, want[1], rtol=0, atol=0)
        np.testing.assert_allclose(
            fused_rms_norm(tx, tw, 1e-5).numpy(),
            np.asarray(jfused.fused_rms_norm(jnp.asarray(x), jnp.asarray(w),
                                             1e-5)), atol=1e-5, rtol=1e-5)
        assert ops.launch_counts()["rms_norm_residual"] == 0
        assert ops.launch_counts()["rms_norm"] == 0
