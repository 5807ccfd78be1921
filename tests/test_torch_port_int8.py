"""Port int8 KV arena (``kv_int8``) against the JAX package.

The wire format (codes, scales, dequantized values) is held bit for bit
against the JAX functions as XLA compiles them; the plain int8 decode
against the JAX per-block fallback, the Pallas int8 kernel in interpret
mode and the dequant-then-dense oracle at 1e-5; the arena written by one
prefill chunk and one decode step bit for bit against the JAX
``cached_attention``; and greedy ``Server`` streams over
``PagedEngine(kv_int8=True)`` token for token against the JAX ``Server``
with ``kv_int8=True``. One JAX int8 paged engine serves the whole file.

XLA compiles ``_dequantize``'s ``s / 127`` as ``s * fl(1/127)`` (its
algebraic simplifier rewrites a division by a constant); called op by op
(eagerly) JAX divides instead, which moves a few percent of the
interior values by one or two ulps (two roundings against one). The
port follows the compiled form, which is what the JAX engine runs."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.generation import cached_attention as jax_cached
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer
from test_torch_port_kernels import interpret  # noqa: F401  (fixture)

from paddle_tpu_torch import ops
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.models.generation import cached_attention
from paddle_tpu_torch.models.llama import _rope_cache
from paddle_tpu_torch.ops import paged_attention as tpa
from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server

ENGINE_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                 prefill_chunk=8)


def _wire_case(name):
    """(rows, d) fp32 vectors: random, zero, constant, +-absmax and
    exact .5 ties of x / absmax * 127."""
    rs = np.random.RandomState(0)
    if name == "random":
        return (rs.randn(512, 128) * rs.rand(512, 1) * 5).astype(np.float32)
    x = np.zeros((4, 128), np.float32)
    if name == "zero":
        return x
    if name == "constant":
        x[0], x[1], x[2] = 3.0, -2.5, 1e-20
        x[3, :64], x[3, 64:] = 1.0, -1.0
        return x
    if name == "absmax":
        x[:] = rs.randn(4, 128)
        x[:, 7] = 8.0
        x[:, 9] = -8.0
        return x
    # ties: absmax 127 -> x * 1 lands on k + 0.5 (both signs)
    x[:, 0] = 127.0
    x[0, 1:21] = np.arange(20) + 0.5
    x[1, 1:21] = -(np.arange(20) + 0.5)
    x[2, 0], x[2, 1:11] = 254.0, 2 * np.arange(10) + 1
    x[3, 0], x[3, 1:11] = -63.5, np.arange(10) * 0.5 - 2.25
    return x


class TestWireFormat:
    @pytest.mark.parametrize("name", ["random", "zero", "constant",
                                      "absmax", "ties"])
    def test_codes_scales_values_bit_identical(self, name):
        x = _wire_case(name)
        jc, js = jax.jit(jpa.quantize_kv)(jnp.asarray(x))
        jd = np.asarray(jax.jit(jpa.dequantize_kv)(jc, js))
        tc, ts = tpa.quantize_kv(torch.from_numpy(x))
        td = tpa.dequantize_kv(tc, ts).numpy()
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td, jd)
        # +-127 codes give +-absmax exactly; the error bound holds
        ext = np.abs(tc.numpy()) == 127
        np.testing.assert_array_equal(np.abs(td)[ext],
                                      np.broadcast_to(ts.numpy()[:, None],
                                                      td.shape)[ext])
        bound = tpa.kv_int8_error_bound(ts).numpy()[:, None]
        assert (np.abs(td - x) <= bound * (1 + 1e-6)).all()

    def test_ties_round_half_to_even(self):
        tc, _ = tpa.quantize_kv(torch.from_numpy(_wire_case("ties")))
        np.testing.assert_array_equal(tc[0, 1:9].numpy(),
                                      [0, 2, 2, 4, 4, 6, 6, 8])
        np.testing.assert_array_equal(tc[1, 1:5].numpy(), [0, -2, -2, -4])

    def test_eager_jax_divides(self):
        """The documented exception: JAX's op-by-op dequantize divides by
        127, the compiled one (and the port) multiplies by fl(1/127)."""
        x = _wire_case("random")
        tc, ts = tpa.quantize_kv(torch.from_numpy(x))
        eager = np.asarray(jpa.dequantize_kv(jnp.asarray(tc.numpy()),
                                             jnp.asarray(ts.numpy())))
        td = tpa.dequantize_kv(tc, ts).numpy()
        differ = eager != td
        assert 0 < differ.mean() < 0.1
        ulp = np.abs(eager.view(np.int32).astype(np.int64)
                     - td.view(np.int32).astype(np.int64))
        assert ulp.max() <= 2

    @pytest.mark.parametrize("absmax", [0.0, 1.0, 3.75, 127.0, 1e-30,
                                        12345.678])
    def test_error_bound_matches_jax(self, absmax):
        want = np.asarray(jpa.kv_int8_error_bound(jnp.float32(absmax)))
        got = tpa.kv_int8_error_bound(absmax).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _int8_case(b, h, kvh, d, bs, mb, seed):
    """Quantized arenas, a shuffled table, ragged lengths (1, a partial
    last block, a full table) and a dead last row whose table is all
    trash block 0."""
    rs = np.random.RandomState(seed)
    nb = 1 + b * mb
    q = rs.randn(b, h, d).astype(np.float32)
    kc, ks = tpa.quantize_kv(torch.from_numpy(
        rs.randn(nb, bs, kvh, d).astype(np.float32)))
    vc, vs = tpa.quantize_kv(torch.from_numpy(
        rs.randn(nb, bs, kvh, d).astype(np.float32)))
    lengths = np.array([1, bs + 3, mb * bs, 5, 2 * bs][:b], np.int32)
    table = np.zeros((b, mb), np.int32)
    perm = list(rs.permutation(np.arange(1, nb)))
    for r in range(b - 1):
        n = -(-int(lengths[r]) // bs)
        table[r, :n] = perm[:n]
        perm = perm[n:]
    return (q, kc.numpy(), vc.numpy(), ks.numpy(), vs.numpy(), table,
            lengths)


class TestInt8Decode:
    @pytest.mark.parametrize("h,kvh,b", [(4, 4, 4), (8, 2, 5), (4, 1, 2)],
                             ids=["mha", "gqa", "mqa_short"])
    def test_plain_matches_jax_kernel_fallback_and_oracle(self, interpret,
                                                          h, kvh, b):
        case = _int8_case(b, h, kvh, 32, 8, 4, seed=h + kvh)
        scale = 1.0 / np.sqrt(32)
        jargs = [jnp.asarray(a) for a in case]
        targs = [torch.from_numpy(a) for a in case]
        j_kernel = np.asarray(jpa.paged_attention_decode_int8(
            *jargs, scale=scale))
        j_fallback = np.asarray(jpa._int8_decode_fallback(*jargs,
                                                          scale=scale))
        j_oracle = np.asarray(jpa.paged_attention_int8_reference(
            jargs[0][:, None], *jargs[1:], scale=scale))[:, 0]
        before = tpa.paged_attention_decode_int8.launches
        got = tpa.paged_attention_decode_int8(*targs, scale=scale).numpy()
        oracle = tpa.paged_attention_int8_reference(
            targs[0][:, None], *targs[1:], scale=scale)[:, 0].numpy()
        assert tpa.paged_attention_decode_int8.launches == before
        for want in (j_kernel, j_fallback, j_oracle, oracle):
            np.testing.assert_allclose(got, want, atol=1e-5)

    def test_bf16_q_keeps_dtype(self):
        case = _int8_case(4, 8, 2, 32, 8, 4, seed=9)
        targs = [torch.from_numpy(a) for a in case]
        q16 = targs[0].to(torch.bfloat16)
        got = tpa.paged_attention_decode_int8(q16, *targs[1:], scale=0.2)
        want = tpa.paged_attention_decode_int8(q16.float(), *targs[1:],
                                               scale=0.2)
        assert got.dtype == torch.bfloat16
        # fp32 inside, one rounding of the output
        torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8,
                                   atol=1e-6)


class TestArenaWrite:
    def test_chunk_then_decode_arena_bit_identical(self):
        """One (1, 8) prefill chunk then one batched decode step (a dead
        row on the trash block) through both ``cached_attention``s on
        the same q/k/v: codes and scales identical outside the trash
        block, outputs within 1e-5. (Under XLA's default CPU
        optimization LLVM contracts RoPE's x*cos + rot*sin into an FMA,
        which moves some k by an ulp; the suite runs XLA at
        optimization level 0, as tests/conftest.py sets.)"""
        cos, sin = _rope_cache(llama_tiny_config(), "cpu")
        jfn = jax.jit(functools.partial(
            jax_cached, scale=0.17, cos=jnp.asarray(cos.numpy()),
            sin=jnp.asarray(sin.numpy())))
        rs = np.random.RandomState(11)
        nb, bs, kvh, h, d = 12, 8, 2, 4, 32
        arenas = [np.zeros((nb, bs, kvh, d), np.int8)] * 2 \
            + [np.zeros((nb, bs, kvh), np.float32)] * 2
        steps = [(8, np.array([0], np.int32), [[3, 5, 0, 0]]),
                 (1, np.array([8, 2, 30], np.int32),
                  [[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]])]
        for s, pos, table in steps:
            table = np.asarray(table, np.int32)
            q = rs.randn(len(pos), s, h, d).astype(np.float32)
            k = rs.randn(len(pos), s, kvh, d).astype(np.float32)
            v = rs.randn(len(pos), s, kvh, d).astype(np.float32)
            jo, *jar = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(arenas[0]), jnp.asarray(arenas[1]),
                           jnp.asarray(pos), block_table=jnp.asarray(table),
                           kv_scales=(jnp.asarray(arenas[2]),
                                      jnp.asarray(arenas[3])))
            tar = [torch.from_numpy(a.copy()) for a in arenas]
            to = cached_attention(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                tar[0], tar[1], torch.from_numpy(pos), scale=0.17, cos=cos,
                sin=sin, block_table=torch.from_numpy(table),
                kv_scales=(tar[2], tar[3]))
            for ja, ta in zip(jar, tar):
                np.testing.assert_array_equal(ta.numpy()[1:],
                                              np.asarray(ja)[1:])
            np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                       atol=1e-5)
            arenas = [np.asarray(a) for a in jar]
        assert np.abs(arenas[0][[3, 5, 7]]).max() > 0


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    je = JaxEngine(jm, paged=True, kv_int8=True, **ENGINE_KW)
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    te = PagedEngine(tm, device="cpu", kv_int8=True, **ENGINE_KW)
    return je, te, tm


def _serve(server_cls, sched_cls, engine, reqs, budget=8):
    engine.reset()
    srv = server_cls(engine, sched_cls(prefill_token_budget=budget))
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    engine.manager.assert_consistent()
    assert not engine.manager._ref
    return [res[r] for r in rids], srv


def _ragged(seed, lens, news):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 512, (L,)).astype(np.int32),
             dict(max_new_tokens=n)) for L, n in zip(lens, news)]


def _shared_prefix_reqs():
    rs = np.random.RandomState(2)
    prefix = rs.randint(0, 512, (17,)).astype(np.int32)
    p1 = np.concatenate([prefix, rs.randint(0, 512, (3,))])
    p2 = np.concatenate([prefix, rs.randint(0, 512, (6,))])
    return [(p1.astype(np.int32), dict(max_new_tokens=5)),
            (p2.astype(np.int32), dict(max_new_tokens=6, arrival_step=3))]


class TestInt8Server:
    @pytest.mark.parametrize("case", ["ragged", "long", "prefix"])
    def test_greedy_streams_token_identical(self, pair, case):
        je, te, _ = pair
        reqs, budget = {
            "ragged": (_ragged(0, (5, 9, 12, 5, 9), (6, 4, 7, 5, 6)), 8),
            "long": (_ragged(1, (21, 40, 3), (9, 24, 30)), None),
            "prefix": (_shared_prefix_reqs(), 8)}[case]
        a, jsrv = _serve(JaxServer, JaxScheduler, je, reqs, budget)
        b, tsrv = _serve(Server, Scheduler, te, reqs, budget)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
        st = tsrv.stats()
        assert st["kv_bytes_per_slot"] == \
            jsrv.stats()["kv_bytes_per_slot"]
        if case == "prefix":
            assert je.manager.hit_blocks == te.manager.hit_blocks == 2
        assert te.kv_error_bound() == pytest.approx(je.kv_error_bound(),
                                                    rel=1e-6)
        assert te.kv_error_bound() > 0

    def test_env_flag_routes_to_int8(self, pair, monkeypatch):
        """``PT_SERVING_KV_INT8=1`` builds the int8 arena (and the block
        size and chunk knobs resolve from the env) with the same greedy
        streams as the JAX int8 Server."""
        je, _, tm = pair
        monkeypatch.setenv("PT_SERVING_KV_INT8", "1")
        monkeypatch.setenv("PT_SERVING_BLOCK_SIZE", "8")
        monkeypatch.setenv("PT_SERVING_PREFILL_CHUNK", "8")
        te = PagedEngine(tm, num_slots=2, max_len=64, decode_block=4,
                         device="cpu")
        assert te.kv_int8 and te.kv_block_size == 8 \
            and te.prefill_chunk_len == 8
        layer = te.backend.cache[0]
        assert [t.dtype for t in layer] == [torch.int8, torch.int8,
                                           torch.float32, torch.float32]
        reqs = _ragged(4, (7, 11, 6), (10, 8, 5))
        a, _ = _serve(JaxServer, JaxScheduler, je, reqs)
        ops.reset_launch_counts()
        b, _ = _serve(Server, Scheduler, te, reqs)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
        # CPU tensors run the plain versions: no kernel launch counted
        assert ops.launch_counts()["paged_attention_decode_int8"] == 0

    def test_fp32_engine_has_no_bound_and_4x_bytes(self, pair):
        _, te, tm = pair
        fp = PagedEngine(tm, device="cpu", kv_int8=False, **ENGINE_KW)
        assert fp.kv_error_bound() == 0.0
        d = tm.config.head_dim
        ratio = fp.backend.kv_bytes_per_slot() / te.backend.kv_bytes_per_slot()
        assert ratio == pytest.approx(4 * d / (d + 4))

    def test_int8_engine_needs_gpu_by_default(self, pair, monkeypatch):
        _, _, tm = pair
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            PagedEngine(tm, kv_int8=True, **ENGINE_KW)
