"""The port's dense serving engine against the JAX package's, and paged
against dense inside the port.

``ContinuousBatchingEngine(model, ...)`` without ``paged`` is the dense
engine: an (S, max_len) KV cache per layer, prompts left-padded to a
bucket and prefilled at batch 1 into a row that admission splices into
the slot, and the decode block passing per-slot pad counts. On the CPU
its programs run eagerly (the same functions the card captures), so:

- the 5 ragged greedy requests of ``tests/test_serving.py:36`` over 2
  slots, buckets (8, 16), stream token-identical to the JAX dense
  ``Server``'s and to the port's batch-1 ``generate()``; so does a
  mixed stream (greedy, seeded top-k / top-p sampling, eos, staggered
  arrivals, a request finished at admission), and a GQA (kv heads 2)
  tied-head model at engine level;
- bucket and capacity refusals are JAX's; ``paged=True`` and
  ``PT_SERVING_PAGED=1`` build the paged engine; ``spec`` and ``quant``
  route to the speculative and quantized engines, a malformed ``tp``
  is refused as in JAX; ``megakernel=True`` counts the
  rewrites and launches nothing in dense mode;
- paged == dense (the north-star invariant): one decode step's
  log-probs over the same K/V history are bitwise equal through the
  dense cache and through the paged arena, and the two engines' greedy
  streams are equal, for fp32 and for GQA with a tied head."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import (LlamaForCausalLM, decode_step_logprobs,
                                     llama_tiny_config)
from paddle_tpu_torch.ops.paged_attention import write_paged_kv
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      ModelStepBackend, PagedEngine,
                                      QuantConfig, Request, Scheduler,
                                      Server, SpecConfig, SpecEngine,
                                      SpecPagedEngine)

ENGINE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                 prompt_buckets=(8, 16))
CONFIGS = {"base": {},
           "gqa_tied": dict(num_key_value_heads=2, tie_word_embeddings=True)}


@pytest.fixture(scope="module")
def setups():
    """Per config: the JAX model and dense engine, the port model and
    its dense engine, built on first use."""
    built = {}

    def get(name):
        if name not in built:
            paddle.seed(0)
            kw = CONFIGS[name]
            jm = JaxLlama(jax_tiny_config(tensor_parallel=False, **kw))
            named = {n: np.asarray(p._value)
                     for n, p in jm.named_parameters()}
            tm = LlamaForCausalLM(llama_tiny_config(**kw), device="cpu")
            tm.load_state_dict(params_from_jax(named))
            je = JaxEngine(jm, **ENGINE_KW)
            te = ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
            built[name] = (jm, je, tm, te)
        return built[name]
    return get


def _serve(server_cls, sched_cls, engine, reqs):
    engine.reset()
    srv = server_cls(engine, sched_cls())
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    return [res[r] for r in rids], srv


def _ragged(vocab=512):
    """The 5 requests of ``tests/test_serving.py:36``."""
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, vocab, (L,)).astype(np.int32)
               for L in (5, 9, 12, 5, 9)]
    return [(p, dict(max_new_tokens=n))
            for p, n in zip(prompts, (6, 4, 7, 5, 6))]


def _mixed():
    """Greedy and seeded sampled requests (top-k, top-p, both), an eos
    retirement, arrivals spread over the block clock, one request that
    finishes at admission."""
    rs = np.random.RandomState(1)
    lens = (5, 13, 3, 16, 9, 11, 7)
    kws = [dict(max_new_tokens=9),
           dict(max_new_tokens=6, temperature=0.8, top_k=20, seed=3),
           dict(max_new_tokens=11, arrival_step=2),
           dict(max_new_tokens=5, temperature=1.1, top_p=0.9, seed=7,
                arrival_step=1),
           dict(max_new_tokens=8, temperature=0.7, top_k=30, top_p=0.8,
                seed=11, arrival_step=4),
           dict(max_new_tokens=1, arrival_step=3),
           dict(max_new_tokens=10, eos_token_id=None, arrival_step=5)]
    return [(rs.randint(0, 512, (L,)).astype(np.int32), kw)
            for L, kw in zip(lens, kws)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ragged_greedy_streams(setups, name):
    """Token-identical to the JAX dense Server and to the port's own
    batch-1 generate(); on the CPU nothing is captured."""
    jm, je, tm, te = setups(name)
    reqs = _ragged()
    want, _ = _serve(JaxServer, JaxScheduler, je, reqs)
    got, srv = _serve(Server, Scheduler, te, reqs)
    for w, g, (p, kw) in zip(want, got, reqs):
        np.testing.assert_array_equal(g, w)
        alone = tm.generate(p[None], max_new_tokens=kw["max_new_tokens"])
        np.testing.assert_array_equal(g, alone.numpy()[0])
    st = srv.stats()
    assert st["requests_completed"] == 5
    assert st["tokens_emitted"] == sum(kw["max_new_tokens"]
                                       for _, kw in reqs)
    assert 0.0 < st["slot_occupancy"] <= 1.0
    assert te.decode_compile_count() == te.prefill_compile_count() == 0
    assert te.prefills == 5


def test_mixed_sampling_stream(setups):
    jm, je, tm, te = setups("base")
    reqs = _mixed()
    plain, _ = _serve(Server, Scheduler, te, reqs)
    # request 6 retires at its 4th generated token
    eos = int(plain[6][7 + 3])
    reqs[6][1]["eos_token_id"] = eos
    want, _ = _serve(JaxServer, JaxScheduler, je, reqs)
    got, srv = _serve(Server, Scheduler, te, reqs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[6][7 + 3:] == eos).all()
    assert srv.stats()["requests_completed"] == len(reqs)
    # greedy rows equal generate(); sampled rows its seeded draw
    for i in (0, 2, 1, 3):
        p, kw = reqs[i]
        sample = {k: kw[k] for k in ("temperature", "top_k", "top_p",
                                     "seed") if k in kw}
        alone = tm.generate(p[None], max_new_tokens=kw["max_new_tokens"],
                            do_sample=bool(sample), **sample)
        np.testing.assert_array_equal(got[i], alone.numpy()[0])


def test_state_buffers_stay_put(setups):
    """The decode block reads the same memory on every call: admission,
    decode, retirement and reset update the state and the pool in
    place."""
    _, _, _, te = setups("base")
    b = te.backend
    ptrs = [t.data_ptr() for t in b.state.values()] \
        + [t.data_ptr() for layer in b.cache for t in layer]
    _serve(Server, Scheduler, te, _ragged())
    te.reset()
    assert ptrs == [t.data_ptr() for t in b.state.values()] \
        + [t.data_ptr() for layer in b.cache for t in layer]
    assert not any(t.abs().sum() for layer in b.cache for t in layer)
    assert isinstance(b, ModelStepBackend)


@pytest.mark.parametrize("L, new, err", [
    (17, 4, "exceeds the largest bucket"),
    (12, 50, "exceeds the slot capacity"),
    (0, 4, "empty prompt"),
    (5, 0, "must be >= 1"),
], ids=["bucket", "capacity", "empty", "no_tokens"])
def test_refusals_match_jax(setups, L, new, err):
    _, je, _, te = setups("base")
    p = np.arange(L, dtype=np.int32)
    for srv in (JaxServer(je), Server(te)):
        with pytest.raises(ValueError, match=err):
            srv.submit(p, max_new_tokens=new)
    assert te.bucket_len(5) == 8 and te.bucket_len(9) == 16


def test_no_buckets_prefills_at_the_prompt_length(setups):
    _, _, tm, _ = setups("base")
    te = ContinuousBatchingEngine(tm, num_slots=2, max_len=32,
                                  decode_block=4, device="cpu")
    assert te.bucket_len(13) == 13
    reqs = _ragged()[:3]
    got, _ = _serve(Server, Scheduler, te, reqs)
    for g, (p, kw) in zip(got, reqs):
        alone = tm.generate(p[None], max_new_tokens=kw["max_new_tokens"])
        np.testing.assert_array_equal(g, alone.numpy()[0])


def test_routing_and_unported_arguments(setups, monkeypatch):
    _, _, tm, _ = setups("base")
    kw = dict(num_slots=2, max_len=32, decode_block=4, device="cpu")
    paged = ContinuousBatchingEngine(tm, paged=True, block_size=8, **kw)
    assert isinstance(paged, PagedEngine)
    monkeypatch.setenv("PT_SERVING_PAGED", "1")
    assert isinstance(ContinuousBatchingEngine(tm, block_size=8, **kw),
                      PagedEngine)
    dense = ContinuousBatchingEngine(tm, paged=False, **kw)
    assert type(dense) is ContinuousBatchingEngine
    # an explicit dense backend is never rerouted by the env flag
    again = ContinuousBatchingEngine(backend=dense.backend)
    assert type(again) is ContinuousBatchingEngine
    monkeypatch.delenv("PT_SERVING_PAGED")
    with pytest.raises(ValueError, match="prompt_buckets"):
        ContinuousBatchingEngine(tm, paged=True, prompt_buckets=(8,), **kw)
    with pytest.raises(ValueError, match="megakernel"):
        ContinuousBatchingEngine(backend=dense.backend, megakernel=True)
    # the dense engine runs only its own backend; PagedEngine only pages
    with pytest.raises(ValueError, match="ModelStepBackend"):
        ContinuousBatchingEngine(backend=paged.backend)
    with pytest.raises(ValueError, match="paged=False"):
        PagedEngine(tm, paged=False, block_size=8, **kw)
    # spec= and quant= route to their engines (ROADMAP A.4), tp= to the
    # sharded backends (tests/test_torch_port_tp.py); a tp= that is no
    # TPConfig, True/False or None is refused, as JAX's
    # resolve_tp_config refuses it
    for paged_kw in ({}, dict(paged=True, block_size=8)):
        spec = ContinuousBatchingEngine(tm, spec=SpecConfig(k=4),
                                        **paged_kw, **kw)
        assert isinstance(spec, SpecPagedEngine if paged_kw else SpecEngine)
        assert spec.spec_k == 4 and spec.decode_block == 1
        quant = ContinuousBatchingEngine(tm, quant="int8", **paged_kw, **kw)
        assert quant.backend.quant_cfg == QuantConfig("int8")
        assert quant.weight_error_bound() > 0
        with pytest.raises(ValueError, match="pass a TPConfig"):
            ContinuousBatchingEngine(tm, tp=4, **paged_kw, **kw)
    with pytest.raises(ValueError, match="factory"):
        PagedEngine(tm, spec=SpecConfig(k=4), block_size=8, **kw)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ContinuousBatchingEngine(tm, num_slots=2, max_len=32)


def test_dense_megakernel_counts_rewrites_only(setups, monkeypatch):
    """megakernel=True marks every dense decode layer, and the kernel
    never takes the dense mode (JAX ``kernel_viable``): rewrites == L,
    kernel calls 0, the unfused layer's streams. The env knob routes
    the same way."""
    _, _, tm, te = setups("base")
    reqs = _ragged()
    want, _ = _serve(Server, Scheduler, te, reqs)
    monkeypatch.setenv("PT_SERVING_MEGAKERNEL", "1")
    mk = ContinuousBatchingEngine(tm, device="cpu", **ENGINE_KW)
    assert mk.megakernel()
    got, _ = _serve(Server, Scheduler, mk, reqs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    L = tm.config.num_hidden_layers
    assert mk.megakernel_rewrites() == L
    assert mk.megakernel_kernel_calls() == 0


# ---------------------------------------------------------------------------
# paged == dense inside the port
# ---------------------------------------------------------------------------

def _history(tm, lens, seed):
    """Per row a prompt prefilled alone into a dense row; returns the
    dense (S, T) cache, the arena with the same K/V, the tables, the
    next tokens and positions."""
    rs = np.random.RandomState(seed)
    S, T, bs = len(lens), 32, 8
    mb = T // bs
    dense = tm.init_kv_cache(S, T)
    arena = tm.init_paged_kv_cache(1 + S * mb, bs)
    table = (1 + torch.arange(S * mb, dtype=torch.int32)).view(S, mb)
    toks = []
    for r, L in enumerate(lens):
        row = tm.init_kv_cache(1, T)
        ids = torch.from_numpy(rs.randint(0, 512, (1, L)).astype(np.int32))
        lp = decode_step_logprobs(tm, ids, row, 0, pad=torch.zeros(
            1, dtype=torch.int32))
        toks.append(int(lp.argmax()))
        for (dk, dv), (rk, rv) in zip(dense, row):
            dk[r].copy_(rk[0])
            dv[r].copy_(rv[0])
    tpos = torch.arange(T, dtype=torch.int32).expand(S, T)
    for (ak, av), (dk, dv) in zip(arena, dense):
        write_paged_kv((ak, av), dk, dv, tpos, table)
    tok = torch.tensor(toks, dtype=torch.int32)[:, None]
    pos = torch.tensor(lens, dtype=torch.int32)
    return dense, arena, table, tok, pos


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_equals_dense_step_logprobs(setups, name):
    """Bitwise: the dense read and the paged gathered read are the same
    einsum/mask/softmax sequence over the same K/V (the CPU's paged
    decode is that sequence, ``paged_attention_reference``)."""
    _, _, tm, _ = setups(name)
    dense, arena, table, tok, pos = _history(tm, (5, 12, 1, 20), 3)
    for _ in range(3):
        d = decode_step_logprobs(tm, tok, dense, pos, None,
                                 pad=torch.zeros(4, dtype=torch.int32))
        p = decode_step_logprobs(tm, tok, arena, pos, table)
        assert torch.equal(d, p)
        tok = d.argmax(-1, keepdim=True).to(torch.int32)
        pos = pos + 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_equals_dense_streams(setups, name):
    """The same greedy streams from both engines (and from the JAX dense
    engine): ragged and mixed requests through 2 slots."""
    _, je, tm, te = setups(name)
    paged = PagedEngine(tm, num_slots=2, max_len=64, decode_block=4,
                        block_size=8, prefill_chunk=8, device="cpu")
    reqs = _ragged() + [(p, kw) for p, kw in _mixed()
                        if "temperature" not in kw]
    dense, _ = _serve(Server, Scheduler, te, reqs)
    pag, _ = _serve(Server, Scheduler, paged, reqs)
    want, _ = _serve(JaxServer, JaxScheduler, je, reqs)
    for d, p, w in zip(dense, pag, want):
        np.testing.assert_array_equal(p, d)
        np.testing.assert_array_equal(d, w)
    paged.manager.assert_consistent()


def test_admission_splices_only_its_slot(setups):
    """A prefilled row lands in its slot alone; the zeroed row leaves
    nothing of an earlier, longer prompt."""
    _, _, tm, te = setups("base")
    te.reset()
    b = te.backend
    rs = np.random.RandomState(9)
    te.admit(Request(0, rs.randint(0, 512, (15,)).astype(np.int32),
                     max_new_tokens=4))
    before = [t[0].clone() for layer in b.cache for t in layer]
    te.admit(Request(1, rs.randint(0, 512, (3,)).astype(np.int32),
                     max_new_tokens=4))
    after = [t[0] for layer in b.cache for t in layer]
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    for layer in b.cache:
        for t in layer:
            assert not t[1, 8:].abs().sum()        # bucket 8: rows 0..7
            assert t[1, :8].abs().sum() > 0
    assert te._state["pad"].tolist() == [1, 5]
    assert te._state["pos"].tolist() == [16, 8]
    te.reset()
