"""Speculative decoding in the port (``paddle_tpu_torch.serving.spec``)
against the JAX package.

- ``ngram_propose`` equals JAX's on the drafter cases of
  ``tests/test_serving_spec.py`` and on random histories;
- the dense and paged speculative engines (``ContinuousBatchingEngine(
  ..., spec=SpecConfig(k=4))``) stream token-identical to the port's
  plain engines and to JAX's ``SpecEngine`` / ``SpecPagedEngine`` on
  mixed greedy and seeded sampled traffic, with JAX's verify steps and
  draft counts; a repetitive prompt really speculates;
- an eos inside the accepted span, k = 0, a window hanging past
  ``max_len`` (the masked per-row write), spec under int8 weights, and
  preemption and resume of spec streams;
- chaos (the JAX spec test's fault schedule and seed) with the poison,
  kill and restore into a fresh engine, and a mismatched k refused; the
  routing contract (env knob, explicit backends, direct constructors,
  tp).

The JAX paged engine of this file runs with the persistent compile
cache off (see ``tests/test_torch_port_resilience.py``)."""
import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import RequestFailure as JaxFailure
from paddle_tpu.serving import ResilienceConfig as JaxResConfig
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving import SpecConfig as JaxSpecConfig
from paddle_tpu.serving import ngram_propose as jax_ngram
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch.distributed.mesh import build_device_mesh
from paddle_tpu_torch.serving.tp import TPConfig
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      FairScheduler, Frontend, PagedEngine,
                                      RequestFailure, ResilienceConfig,
                                      Scheduler, Server, SpecConfig,
                                      SpecEngine, SpecPagedEngine,
                                      ngram_propose)
from paddle_tpu_torch.utils import faults as tfaults

DENSE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                prompt_buckets=(8, 16, 32))
PAGED_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                prefill_chunk=8)


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages, and engines built on first use:
    port spec (k = 4) and plain engines, JAX spec engines."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}

    def port_model():
        m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        m.load_state_dict(params_from_jax(named))
        return m
    tm = port_model()
    built = {}

    def engine(side, kind, k=4, fresh=False, **kw):
        key = (side, kind, k, tuple(sorted(kw.items())))
        if fresh or key not in built:
            base = DENSE_KW if kind == "dense" else PAGED_KW
            spec = None if k is None else SpecConfig(k=k)
            if side == "jax":
                e = JaxEngine(jm, paged=kind == "paged",
                              spec=None if k is None else JaxSpecConfig(k=k),
                              **base, **kw)
            else:
                e = ContinuousBatchingEngine(
                    port_model() if fresh else tm, paged=kind == "paged",
                    spec=spec, device="cpu", **base, **kw)
            if fresh:
                return e
            built[key] = e
        return built[key]
    yield tm, engine
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _requests(seed=0, sampled=True, arrivals=True):
    rs = np.random.RandomState(seed)
    out = []
    for i, (n, mn) in enumerate(zip((5, 9, 12, 7, 15, 6), (9, 6, 11, 7,
                                                           12, 8))):
        kw = dict(max_new_tokens=mn)
        if arrivals:
            kw["arrival_step"] = i // 2
        if sampled and i == 3:
            kw.update(temperature=0.8, top_k=20, seed=5)
        out.append((rs.randint(0, 512, (n,)).astype(np.int32), kw))
    return out


def _repetitive():
    """Prompts whose greedy continuations repeat: the drafter's food."""
    return [(np.full((16,), 7, np.int32), dict(max_new_tokens=24)),
            (np.tile(np.arange(3, 8, dtype=np.int32), 3),
             dict(max_new_tokens=20))]


def _serve(engine, reqs, jax_side=False, **srv_kw):
    engine.reset()
    srv = (JaxServer if jax_side else Server)(
        engine, (JaxScheduler if jax_side else Scheduler)(), **srv_kw)
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    return [np.asarray(res[r]) for r in rids], srv


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _counters(e):
    return (e.verify_steps, e.draft_proposed, e.draft_accepted)


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

_DRAFTS = [([1, 2, 3, 9, 1, 2, 3, 5, 1, 2, 3], 1, 3, 1),
           ([4, 7, 4, 7, 4, 7], 6, 3, 1), ([1, 2, 3, 4, 5, 6], 4, 3, 1),
           ([1], 4, 3, 1), ([1, 2, 3, 4, 5, 6], 0, 3, 1),
           ([5, 5, 5, 5], 3, 2, 1), ([1, 2, 1, 3, 1, 2], 4, 3, 2)]


@pytest.mark.parametrize("case", range(len(_DRAFTS) + 4))
def test_ngram_propose_matches_jax(case):
    """The drafter cases of ``tests/test_serving_spec.py`` (longest
    match wins, a cycle self-extends, no match, a too-short history,
    k = 0) and random low-entropy histories."""
    if case < len(_DRAFTS):
        h, k, nmax, nmin = _DRAFTS[case]
        h = np.asarray(h, np.int32)
    else:
        rs = np.random.RandomState(case)
        h = rs.randint(0, 4, (int(rs.randint(2, 40)),)).astype(np.int32)
        k, nmax, nmin = int(rs.randint(1, 9)), 3, 1
    np.testing.assert_array_equal(ngram_propose(h, k, nmax, nmin),
                                  jax_ngram(h, k, nmax, nmin))


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_streams_match_plain_and_jax(setup, kind):
    """Mixed traffic (greedy, one seeded sampled stream, staggered
    arrivals): the spec engine equals the port's plain engine and JAX's
    spec engine, with JAX's verify steps and draft counts; one verify
    program a backend (0 captures on the CPU); decode block 1."""
    tm, engine = setup
    reqs = _requests()
    se = engine("port", kind)
    assert isinstance(se, SpecPagedEngine if kind == "paged" else SpecEngine)
    got, _ = _serve(se, reqs)
    _same(got, _serve(engine("port", kind, k=None), reqs)[0])
    je = engine("jax", kind)
    _same(got, _serve(je, reqs, jax_side=True)[0])
    assert _counters(se) == _counters(je)
    assert se.decode_block == 1 and se.decode_compile_count() == 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_repetitive_prompt_speculates(setup, kind):
    """The real drafter on repetitive continuations: drafts are proposed
    and accepted, fewer verify steps than tokens, the counters are
    JAX's, the streams the plain engine's."""
    tm, engine = setup
    reqs = _repetitive()
    se = engine("port", kind)
    got, _ = _serve(se, reqs)
    _same(got, _serve(engine("port", kind, k=None), reqs)[0])
    je = engine("jax", kind)
    _serve(je, reqs, jax_side=True)
    assert _counters(se) == _counters(je)
    assert se.draft_accepted > 0 and se.acceptance_rate() > 0
    assert se.verify_steps < sum(kw["max_new_tokens"] - 1 for _, kw in reqs)


def _oracle(engine, continuation_by_rid):
    """A perfect drafter: each slot's true greedy continuation."""
    def propose():
        S, k = engine.num_slots, engine.spec_k
        draft = np.zeros((S, k), np.int32)
        n = np.zeros((S,), np.int32)
        for slot, run in enumerate(engine._slots):
            if run is None or slot in engine._prefill_slots:
                continue
            gen = continuation_by_rid[run.request.request_id]
            done = len(run.tokens)
            cap = min(k, int(engine._remaining_host[slot]) - 1)
            nxt = gen[done:done + max(cap, 0)]
            draft[slot, :len(nxt)] = nxt
            n[slot] = len(nxt)
        return draft, n
    return propose


def test_oracle_window_and_eos_inside_span(setup, monkeypatch):
    """A perfect drafter fills every window (max_new 14 at k = 4: 3
    verify steps, 10 drafts accepted); an eos on the fourth generated
    token ends the stream inside the first span (one verify step), padded
    with eos as ``generate(eos_token_id=)`` pads it."""
    tm, engine = setup
    se = engine("port", "dense")
    p = np.random.RandomState(5).randint(0, 512, (6,)).astype(np.int32)
    ref = tm.generate(p[None], max_new_tokens=14).numpy()[0]
    cont = ref[len(p):].astype(np.int32)
    se.reset()
    srv = Server(se)
    rid = srv.submit(p, max_new_tokens=14)
    monkeypatch.setattr(se, "_propose", _oracle(se, {rid: cont}))
    np.testing.assert_array_equal(srv.run_until_idle()[rid], ref)
    assert se.acceptance_rate() == 1.0 and _counters(se) == (3, 10, 10)
    eos = int(cont[3])
    assert eos not in cont[:3]
    want = tm.generate(p[None], max_new_tokens=14,
                       eos_token_id=eos).numpy()[0]
    se.reset()
    srv = Server(se)
    rid = srv.submit(p, max_new_tokens=14, eos_token_id=eos)
    monkeypatch.setattr(se, "_propose", _oracle(se, {rid: cont}))
    got = srv.run_until_idle()[rid]
    np.testing.assert_array_equal(got, want)
    assert (got[len(p) + 4:] == eos).all() and se.verify_steps == 1


def test_k0_degenerates_to_plain_decode(setup):
    """k = 0: a one-column window, one token a step, no drafts, the
    plain stream."""
    tm, engine = setup
    reqs = _requests(3)
    se = engine("port", "dense", k=0)
    got, _ = _serve(se, reqs)
    _same(got, _serve(engine("port", "dense", k=None), reqs)[0])
    assert se.draft_proposed == se.draft_accepted == 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_window_past_max_len_writes_nothing_out_of_range(setup, kind,
                                                         monkeypatch):
    """Requests that fill their slot to ``max_len`` while a full window
    is verified (drafts that can never be accepted past the budget):
    every window near the end hangs past the cache; the columns past it
    are dropped (dense) or go to the trash block (paged), and the
    streams equal the plain engine's and JAX's."""
    tm, engine = setup
    rs = np.random.RandomState(4)
    reqs = [(rs.randint(0, 512, (16,)).astype(np.int32),
             dict(max_new_tokens=48)),
            (rs.randint(0, 512, (32,)).astype(np.int32),
             dict(max_new_tokens=32))]
    se = engine("port", kind)
    k = se.spec_k

    def junk():                  # k drafts every step: windows full
        return (np.full((se.num_slots, k), 3, np.int32),
                np.full((se.num_slots,), k, np.int32))
    monkeypatch.setattr(se, "_propose", junk)
    got, _ = _serve(se, reqs)
    _same(got, _serve(engine("port", kind, k=None), reqs)[0])
    if kind == "paged":
        se.manager.assert_consistent()


def test_spec_under_quant_equals_plain_quant(setup):
    """spec= with quant="int8": the verify step reads the same codes;
    streams equal the plain int8 engine's, dense and paged."""
    tm, engine = setup
    reqs = _requests(5, sampled=False)
    for kind, base in (("dense", DENSE_KW), ("paged", PAGED_KW)):
        sq = ContinuousBatchingEngine(tm, paged=kind == "paged",
                                      spec=SpecConfig(k=3), quant="int8",
                                      device="cpu", **base)
        pq = ContinuousBatchingEngine(tm, paged=kind == "paged",
                                      quant="int8", device="cpu", **base)
        _same(_serve(sq, reqs)[0], _serve(pq, reqs)[0])
        assert sq.weight_error_bound() == pq.weight_error_bound() > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_preempt_resume_equals_plain(setup, kind):
    """Greedy and seeded sampled low-priority streams evicted by a
    high-priority arrival resume and finish as the plain engine's
    uninterrupted streams (drafting is a pure function of history)."""
    tm, engine = setup
    rs = np.random.RandomState(30)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32) for n in (5, 9, 12)]
    lows = [dict(max_new_tokens=20, temperature=0.9, top_k=40, seed=11),
            dict(max_new_tokens=20)]
    se = engine("port", kind)
    se.reset()
    fe = Frontend(se, preemption=True)
    low = [fe.submit(p, priority=0, **kw) for p, kw in zip(prompts, lows)]
    for _ in range(3):
        fe.pump()
    hi = fe.submit(prompts[2], max_new_tokens=4, priority=5)
    res = fe.run_until_idle()
    st = fe.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    want, _ = _serve(engine("port", kind, k=None),
                     [(prompts[0], lows[0]), (prompts[1], lows[1]),
                      (prompts[2], dict(max_new_tokens=4))])
    _same([res[r] for r in low + [hi]], want)
    assert all(s is None for s in se._slots)


# ---------------------------------------------------------------------------
# resilience
# ---------------------------------------------------------------------------

CHAOS = ("serving.step_block:p=0.06;serving.harvest:p=0.05;"
         "serving.prefill_tick:p=0.08;serving.allocate:p=0.2;"
         "server.tick:p=0.05;serving.poison:at=4,times=1")


def _outcome(v):
    if isinstance(v, (RequestFailure, JaxFailure)):
        return ("fail", v.reason, v.tokens_emitted)
    return ("ok", np.asarray(v).tolist())


def _chaos(engine, reqs, side):
    engine.reset()
    jax_side = side == "jax"
    srv = (JaxServer if jax_side else Server)(
        engine, (JaxScheduler if jax_side else Scheduler)(
            prefill_token_budget=8),
        resilience=(JaxResConfig if jax_side else ResilienceConfig)(
            retry_attempts=3, retry_backoff_s=0.001, breaker_threshold=12,
            deadline_ticks=80, seed=5))
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    with (jfaults if jax_side else tfaults).injected(CHAOS, seed=5):
        res = srv.run_until_idle(max_ticks=400)
    return [_outcome(res[r]) for r in rids], srv


def test_chaos_and_poison_with_spec(setup):
    """The JAX spec test's chaos schedule (five transient sites and one
    poison, seed 5) over the paged spec engine: the poisoned request
    alone fails, every other stream equals the fault-free run (a step
    fault's retry drafts the same proposal, a harvest retry reads the
    parked output), no slot or block leaks. Not held against JAX's
    outcomes: JAX releases the poisoned run's blocks with the NaN in
    them and quarantines their next owner too; the port zeroes them
    (ROADMAP C)."""
    tm, engine = setup
    reqs = _requests(105, sampled=False)
    se = engine("port", "paged")
    clean, _ = _serve(se, reqs)
    got, tsrv = _chaos(se, reqs, "port")
    st = tsrv.stats()
    assert st["retries"] > 0 and st["step_failures"] > 0
    assert [o[1] for o in got if o[0] == "fail"] == ["poisoned"]
    for o, w in zip(got, clean):
        if o[0] == "ok":
            assert o[1] == w.tolist()
    assert not se.has_live() and not se.manager._ref
    se.manager.assert_consistent()


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_kill_restore_mid_stream(setup, kind, tmp_path):
    """Snapshot mid-stream, restore into a freshly built spec engine:
    every stream as the uninterrupted run, the spec counters carried;
    an engine of another k refuses the snapshot."""
    tm, engine = setup
    reqs = _requests(11)
    se = engine("port", kind)
    want, _ = _serve(se, reqs)
    se.reset()
    srv = Server(se, Scheduler())
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    srv.run_until_idle(max_ticks=4)
    assert se.has_live()
    at_kill = _counters(se)
    path = str(tmp_path / "spec.npz")
    srv.snapshot(path)
    fresh = engine("port", kind, fresh=True)
    srv2 = Server.restore(path, fresh, Scheduler())
    assert _counters(fresh) == at_kill
    res = srv2.run_until_idle()
    _same([res[r] for r in rids], want)
    other = engine("port", kind, k=2, fresh=True)
    with pytest.raises(ValueError, match="k=4"):
        other.restore(path)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_spec_routing(setup, monkeypatch):
    """``PT_SERVING_SPEC=<k>`` routes a model-built engine and sizes k;
    an explicit spec backend is the decision, a plain one is never
    rerouted by the knob; ``spec=`` on a plain engine's direct
    constructor and ``paged=`` on the wrong spec class are refused, as
    is ``tp=``."""
    tm, engine = setup
    monkeypatch.setenv("PT_SERVING_SPEC", "3")
    e = ContinuousBatchingEngine(tm, device="cpu", **DENSE_KW)
    assert isinstance(e, SpecEngine) and e.spec_k == 3
    plain = engine("port", "dense", k=None)
    assert type(ContinuousBatchingEngine(backend=plain.backend)) is \
        ContinuousBatchingEngine
    again = ContinuousBatchingEngine(backend=e.backend)
    assert isinstance(again, SpecEngine) and again.spec_k == 3
    monkeypatch.delenv("PT_SERVING_SPEC")
    with pytest.raises(ValueError, match="factory"):
        PagedEngine(tm, spec=SpecConfig(k=2), device="cpu", **PAGED_KW)
    with pytest.raises(ValueError, match="SpecPagedEngine"):
        SpecEngine(tm, paged=True, spec=SpecConfig(k=2), device="cpu",
                   **DENSE_KW)
    with pytest.raises(ValueError, match="SpecEngine"):
        SpecPagedEngine(tm, paged=False, spec=SpecConfig(k=2),
                        device="cpu", **PAGED_KW)
    # JAX's refusal of spec= beside tp=
    mesh = build_device_mesh({"mp": 2}, devices=["cpu"] * 2)
    for kw in (DENSE_KW, dict(PAGED_KW, paged=True)):
        with pytest.raises(NotImplementedError,
                           match="speculative decoding is not yet"):
            ContinuousBatchingEngine(tm, spec=SpecConfig(k=2),
                                     tp=TPConfig(mesh=mesh), device="cpu",
                                     **kw)
    with pytest.raises(ValueError, match="spec="):
        ContinuousBatchingEngine(tm, spec=4, device="cpu", **DENSE_KW)
    assert Server(e, FairScheduler(), preemption=True).preemption
