"""The paged engine's two programs as the card captures them, run on
the CPU against the JAX paged engine.

On the card the port captures the decode block and the prefill chunk as
one CUDA graph each (``paddle_tpu_torch/serving/graphs.py``); on the CPU
the same Python functions run eagerly, so these tests run the code that
is captured. At ``llama_tiny`` size, on the JAX model's weights:

- greedy and seeded sampled streams over a ragged stream are
  token-identical to the JAX paged ``Server``'s, over the fp32 and the
  int8 arena, with the megakernel off and on (its plain version on the
  CPU; the JAX engines run with the megakernel off, as the fusion pass
  finds no marked region under jax 0.9);
- the slot keys equal the JAX engine's bit for bit after a greedy-only
  block and after a mixed one: every step splits every key;
- the state and the programs' static buffers keep their memory across
  blocks, arming, cancellation and ``reset()``;
- the chunk's candidate first token equals JAX ``chunk_fn``'s for a
  final chunk shorter than ``prefill_chunk``;
- both compile counts are 0 on the CPU (nothing is captured).

The JAX paged engines run with the persistent compile cache off: two
paged backends compiled in one process with it on are a jaxlib heap
hazard."""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server

ENGINE_KW = dict(num_slots=3, max_len=64, decode_block=4, block_size=8,
                 prefill_chunk=8)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)


@pytest.fixture(scope="module")
def models():
    """llama_tiny with the JAX weights in both packages; JAX paged
    engines (megakernel off) built on first use, one per arena."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    yield jm, tm, {}
    jax.config.update("jax_enable_compilation_cache", True)


def _jax_engine(models, kv_int8):
    jm, _, built = models
    if kv_int8 not in built:
        built[kv_int8] = JaxEngine(jm, paged=True, kv_int8=kv_int8,
                                   megakernel=False, **ENGINE_KW)
    return built[kv_int8]


def _port_engine(models, kv_int8=False, megakernel=False):
    return PagedEngine(models[1], device="cpu", kv_int8=kv_int8,
                       megakernel=megakernel, **ENGINE_KW)


def _ragged(seed):
    """6 requests of 3-21 prompt tokens (some end in a short chunk);
    two sample with their own seeds, one arrives late."""
    rs = np.random.RandomState(seed)
    lens, news = (5, 13, 21, 3, 9, 16), (9, 6, 7, 11, 5, 8)
    out = []
    for i, (L, n) in enumerate(zip(lens, news)):
        kw = dict(max_new_tokens=n)
        if i in (1, 4):
            kw.update(SAMPLED, seed=7 * i + 1)
        if i == 5:
            kw["arrival_step"] = 3
        out.append((rs.randint(0, 512, (L,)).astype(np.int32), kw))
    return out


def _server(server_cls, sched_cls, engine, reqs):
    engine.reset()
    srv = server_cls(engine, sched_cls(prefill_token_budget=8))
    return srv, [srv.submit(p, **kw) for p, kw in reqs]


def _serve(server_cls, sched_cls, engine, reqs):
    srv, rids = _server(server_cls, sched_cls, engine, reqs)
    res = srv.run_until_idle()
    engine.manager.assert_consistent()
    assert not engine.manager._ref
    return [res[r] for r in rids]


@pytest.mark.parametrize("megakernel", [False, True], ids=["unfused", "mega"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_streams_match_jax_server(models, kv_int8, megakernel):
    """Greedy and seeded sampled streams through the programs the card
    captures equal the JAX paged Server's; nothing is captured on the
    CPU."""
    reqs = _ragged(11 + kv_int8)
    want = _serve(JaxServer, JaxScheduler, _jax_engine(models, kv_int8),
                  reqs)
    te = _port_engine(models, kv_int8, megakernel)
    got = _serve(Server, Scheduler, te, reqs)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    assert te.megakernel() == megakernel
    assert te.decode_compile_count() == te.prefill_compile_count() == 0


def test_slot_keys_match_jax_after_every_block(models):
    """Every step splits every slot's key, live or not, as the JAX block
    does: after greedy-only blocks and after mixed ones the (S, 2) keys
    are bit-equal to the JAX engine's."""
    je, te = _jax_engine(models, False), _port_engine(models)
    rs = np.random.RandomState(3)
    greedy = [(rs.randint(0, 512, (L,)).astype(np.int32),
               dict(max_new_tokens=20)) for L in (6, 10)]
    sampled = (rs.randint(0, 512, (9,)).astype(np.int32),
               dict(max_new_tokens=12, arrival_step=3, seed=5, **SAMPLED))
    reqs = greedy + [sampled]
    jsrv, _ = _server(JaxServer, JaxScheduler, je, reqs)
    tsrv, _ = _server(Server, Scheduler, te, reqs)
    phases = []
    for tick in range(6):
        jsrv.run_until_idle(max_ticks=1)
        tsrv.run_until_idle(max_ticks=1)
        np.testing.assert_array_equal(
            te._state["key"].numpy(),
            np.asarray(je._state["key"]).astype(np.int64))
        phases.append(any(r.request.temperature > 0
                          for _, r in te.live_runs()))
    # the comparison covered greedy-only blocks, then mixed ones
    assert te.steps >= 8 and not phases[1] and phases[-1]
    jsrv.run_until_idle()
    tsrv.run_until_idle()
    for rid in jsrv.results:
        np.testing.assert_array_equal(tsrv.results[rid], jsrv.results[rid])


def test_state_and_static_buffers_keep_their_memory(models):
    """The captured programs read and write fixed memory: every state
    tensor and every static buffer of the block and the chunk keeps its
    data_ptr across blocks, arming, cancellation and reset()."""
    te = _port_engine(models, kv_int8=True)
    b = te.backend

    def ptrs():
        out = {f"state.{k}": v.data_ptr() for k, v in te._state.items()}
        out.update(block_out=b._block_out.data_ptr(),
                   chunk_args=b._chunk_args.data_ptr(),
                   chunk_key=b._chunk_key.data_ptr(),
                   chunk_tok=b._chunk_tok.data_ptr())
        out.update({f"cache.{i}.{j}": t.data_ptr()
                    for i, layer in enumerate(b.cache)
                    for j, t in enumerate(layer)})
        return out

    before = ptrs()
    assert te._state is b.state and "table" in te._state
    srv, _ = _server(Server, Scheduler, te, _ragged(4))
    srv.run_until_idle(max_ticks=3)                 # chunks, arms, blocks
    assert te.steps > 0 and ptrs() == before
    (slot, _), *_ = te.live_runs()
    assert te.cancel_slot(slot, "timeout")
    srv.run_until_idle()
    assert ptrs() == before
    te.reset()
    assert ptrs() == before and te._state is b.state
    assert not te._state["live"].any() and not te._state["table"].any()
    assert (te._state["eos"] == -1).all() and (te._state["topp"] == 1).all()


@pytest.mark.parametrize("kw", [dict(), SAMPLED, dict(temperature=1.1),
                                dict(temperature=0.7, top_p=0.5)],
                         ids=["greedy", "top_k_top_p", "plain", "top_p"])
def test_chunk_candidate_token_matches_jax_chunk_fn(models, kw):
    """max_new_tokens=1 retires a request at admission with the token
    the chunk program sampled from its last real column: prompts of 13
    (a final chunk of 5), 3 (one short chunk) and 16 (two full chunks)
    tokens, sampled with the request's seed, give JAX chunk_fn's
    token."""
    rs = np.random.RandomState(8)
    reqs = [(rs.randint(0, 512, (L,)).astype(np.int32),
             dict(max_new_tokens=1, seed=L, **kw)) for L in (13, 3, 16)]
    want = _serve(JaxServer, JaxScheduler, _jax_engine(models, False), reqs)
    te = _port_engine(models)
    got = _serve(Server, Scheduler, te, reqs)
    for (p, _), a, b in zip(reqs, want, got):
        assert len(b) == len(p) + 1
        np.testing.assert_array_equal(b, a)
    assert te.prefill_chunks == 2 + 1 + 2
    assert te.prefill_compile_count() == 0


def test_cpu_program_runs_its_function_every_call():
    """On the CPU capture() captures nothing and every call runs the
    function, counting no launch."""
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import CapturedProgram
    acc = torch.zeros(3)
    prog = CapturedProgram(lambda: acc.add_(1.0), "cpu")
    ops.reset_launch_counts()
    prog.capture()
    prog()
    prog()
    assert prog.captures == 0 and prog.graph is None
    assert acc.tolist() == [2.0, 2.0, 2.0]
    assert not any(ops.launch_counts().values())
