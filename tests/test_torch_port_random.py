"""Port threefry sampling (``paddle_tpu_torch.random``) against
``jax.random``, and seeded sampled ``Server`` streams against the JAX
``Server``.

Keys, splits, raw bits, uniforms and categorical draws match JAX 0.9's
partitionable threefry bit for bit (seeds 0, 7, 2**31 - 1 and one above
2**32, which wraps to 32 bits as ``PRNGKey`` does with 64-bit types
off). Gumbel noise is ``-log(-log(u))`` and the two frameworks' ``log``
may differ by an ulp: each log is held within 2 ulp, the noise within 2
ulp of itself plus 2 ulp of the inner log carried through the outer one.
Sampled streams (top-k, top-p, both, beside greedy rows) over the fp32
and the int8 arena are token-identical to the JAX ``Server``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer

from paddle_tpu_torch import random as prng
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server
from paddle_tpu_torch.serving.engine import slot_sample_logits

SEEDS = [0, 7, 2 ** 31 - 1, 2 ** 32 + 5]
ENGINE_KW = dict(num_slots=3, max_len=64, decode_block=4, block_size=8,
                 prefill_chunk=8)


def _i64(a):
    return np.asarray(a).astype(np.int64)


def _ulps(a, b):
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32)
                  .astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
class TestThreefry:
    def test_key_and_split(self, seed):
        jk = jax.random.PRNGKey(seed)
        tk = prng.prng_key(seed)
        np.testing.assert_array_equal(tk.numpy(), _i64(jk))
        np.testing.assert_array_equal(prng.split(tk).numpy(),
                                      _i64(jax.random.split(jk)))
        np.testing.assert_array_equal(prng.split(tk, 5).numpy(),
                                      _i64(jax.random.split(jk, 5)))
        # vectorised over (S, 2) keys, as jax.vmap(split)
        ks = jax.random.split(jk, 6)
        np.testing.assert_array_equal(
            prng.split(torch.from_numpy(_i64(ks))).numpy(),
            _i64(jax.vmap(jax.random.split)(ks)))

    def test_bits_and_uniform(self, seed):
        jk = jax.random.PRNGKey(seed)
        tk = prng.prng_key(seed)
        np.testing.assert_array_equal(
            prng.random_bits(tk, (3, 1001)).numpy(),
            _i64(jax.random.bits(jk, (3, 1001))))
        tiny = float(np.finfo(np.float32).tiny)
        for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-1.0, 1.0)):
            np.testing.assert_array_equal(
                prng.uniform(tk, 4096, lo, hi).numpy(),
                np.asarray(jax.random.uniform(jk, (4096,), minval=lo,
                                              maxval=hi)))

    def test_gumbel_within_two_ulp_of_each_log(self, seed):
        jk = jax.random.PRNGKey(seed)
        tk = prng.prng_key(seed)
        tiny = float(np.finfo(np.float32).tiny)
        u = prng.uniform(tk, 8192, tiny, 1.0)
        inner_t = -torch.log(u).numpy()
        inner_j = np.asarray(jax.jit(lambda x: -jnp.log(x))(u.numpy()))
        assert _ulps(inner_t, inner_j).max() <= 2
        g_t = prng.gumbel(tk, 8192).numpy()
        g_j = np.asarray(jax.random.gumbel(jk, (8192,)))
        ulp_g = np.spacing(np.abs(g_j).astype(np.float32))
        tol = 2 * ulp_g + 2 * 2.0 ** -23
        assert (np.abs(g_t - g_j) <= tol).all()

    def test_categorical(self, seed):
        jk = jax.random.PRNGKey(seed)
        keys = jax.random.split(jk, 16)
        rs = np.random.RandomState(seed % 1000)
        logits = (3 * rs.randn(16, 500)).astype(np.float32)
        logits[:, ::7] = -np.inf                     # filtered entries
        want = np.asarray(jax.vmap(jax.random.categorical)(
            keys, jnp.asarray(logits)))
        got = prng.categorical(torch.from_numpy(_i64(keys)),
                               torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)


def test_slot_sample_logits_matches_jax():
    """The per-slot filter + draw over mixed rows (greedy, top-k, top-p,
    both) against the JAX ``slot_sample_logits`` with the same keys."""
    from paddle_tpu.serving.engine import slot_sample_logits as jax_sample
    rs = np.random.RandomState(3)
    S, V = 6, 400
    logits = (2 * rs.randn(S, V)).astype(np.float32)
    temp = np.array([0.0, 0.8, 1.0, 0.7, 0.0, 1.3], np.float32)
    topk = np.array([0, 20, 0, 50, 5, 0], np.int32)
    topp = np.array([1.0, 1.0, 0.9, 0.95, 0.5, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(42), S)
    want = np.asarray(jax_sample(jnp.asarray(logits), keys,
                                 jnp.asarray(temp), jnp.asarray(topk),
                                 jnp.asarray(topp)))
    args = [torch.from_numpy(a) for a in (logits, temp, topk, topp)]
    tkeys = torch.from_numpy(_i64(keys))
    np.testing.assert_array_equal(
        slot_sample_logits(*args, tkeys).numpy(), want)
    # every row draws, and the greedy rows keep their argmax whatever
    # their keys; no keys: all greedy
    other = torch.from_numpy(_i64(jax.random.split(jax.random.PRNGKey(5),
                                                   S)))
    greedy = temp <= 0
    np.testing.assert_array_equal(
        slot_sample_logits(*args, other).numpy()[greedy], want[greedy])
    np.testing.assert_array_equal(slot_sample_logits(*args).numpy(),
                                  logits.argmax(-1))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    return jm, tm, {}


def _engines(models, kv_int8):
    """One JAX and one port paged engine per arena kind, built once."""
    jm, tm, built = models
    if kv_int8 not in built:
        built[kv_int8] = (
            JaxEngine(jm, paged=True, kv_int8=kv_int8, **ENGINE_KW),
            PagedEngine(tm, device="cpu", kv_int8=kv_int8, **ENGINE_KW))
    return built[kv_int8]


def _serve(server_cls, sched_cls, engine, reqs):
    engine.reset()
    srv = server_cls(engine, sched_cls(prefill_token_budget=8))
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    engine.manager.assert_consistent()
    assert not engine.manager._ref
    return [res[r] for r in rids]


FILTERS = {"top_k": dict(top_k=20), "top_p": dict(top_p=0.9),
           "both": dict(top_k=50, top_p=0.95)}


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("filt", list(FILTERS))
def test_sampled_server_streams_token_identical(models, kv_int8, filt):
    """Two sampled requests (seeds 7 and 2**31 - 1) beside two greedy
    ones, through 3 slots: every stream equals the JAX Server's."""
    je, te = _engines(models, kv_int8)
    rs = np.random.RandomState(len(filt) + kv_int8)
    lens, news = (9, 14, 5, 20), (12, 10, 16, 8)
    reqs = []
    for i, (L, n) in enumerate(zip(lens, news)):
        kw = dict(max_new_tokens=n)
        if i in (1, 2):
            kw.update(temperature=0.8, seed=7 if i == 1 else 2 ** 31 - 1,
                      **FILTERS[filt])
        reqs.append((rs.randint(0, 512, (L,)).astype(np.int32), kw))
    want = _serve(JaxServer, JaxScheduler, je, reqs)
    got = _serve(Server, Scheduler, te, reqs)
    for x, y in zip(want, got):
        np.testing.assert_array_equal(y, x)
    # the sampled streams do depend on their seeds
    reqs[1][1]["seed"] = 8
    assert not np.array_equal(_serve(Server, Scheduler, te, reqs)[1],
                              got[1])
