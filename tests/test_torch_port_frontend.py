"""The port's multi-tenant front door (``paddle_tpu_torch.serving.frontend``)
and priority preemption (``server.py``, ``engine.py``, ``paging.py``)
against the JAX package.

- ``FairScheduler``: the same submission / pop / requeue scripts give
  the same admissions and deficit ledgers as JAX's (weighted shares,
  priority tiers, FIFO within a tenant behind the batching gate, the
  requeue credit of a deferral and of a preemption, no credit banked
  while idle, pending counts, quota and weight validation); the server
  sheds at a tenant quota;
- ``TokenStream``: iterator and callback streams equal the served rows,
  a bounded queue drops the oldest and counts them, a shed stream ends
  at once;
- preemption: greedy and seeded sampled low-priority streams evicted by
  a high-priority arrival equal JAX's front door's and the port's
  unpreempted runs, on the dense and the paged engine, with JAX's
  preemption and resume counts; equal priority never preempts; one
  terminal a request in the trace (preempt and resume are events); the
  requeue restarts the queue-wait clock; a preempted request carried in
  the queue survives snapshot and restore; a stream re-attached after a
  kill sees only the tokens its consumer never took; chaos with
  preemption and weighted tenants keeps every invariant."""
import json

import numpy as np
import pytest

import jax
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import FairScheduler as JaxFair
from paddle_tpu.serving import Frontend as JaxFrontend
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ResumeState as JaxResume
from paddle_tpu.serving import TenantConfig as JaxTenant

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import ObservabilityConfig
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      FairScheduler, Frontend, Request,
                                      RequestFailure, ResilienceConfig,
                                      ResumeState, Scheduler, Server,
                                      TenantConfig)
from paddle_tpu_torch.utils import faults as tfaults

DENSE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                prompt_buckets=(8, 16, 32))
PAGED_KW = dict(num_slots=2, max_len=64, decode_block=4, paged=True,
                block_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages; the port's dense and paged
    engines and ``fresh(kind)`` (a restarted process); JAX's two engines
    built on first use."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}

    def fresh(kind):
        m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        m.load_state_dict(params_from_jax(named))
        return ContinuousBatchingEngine(
            m, device="cpu", **(DENSE_KW if kind == "dense" else PAGED_KW))
    port = {"dense": fresh("dense"), "paged": fresh("paged")}
    jengines = {}

    def jax_engine(kind):
        if kind not in jengines:
            jengines[kind] = JaxEngine(
                jm, **(DENSE_KW if kind == "dense" else PAGED_KW))
        return jengines[kind]
    yield port, jax_engine, fresh
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(autouse=True)
def _disarmed():
    tfaults.clear()
    yield
    tfaults.clear()


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, (L,)).astype(np.int32) for L in lens]


def _plain(engine, reqs):
    """Each request served alone-in-order without preemption (the
    reference a preempted stream must equal)."""
    engine.reset()
    srv = Server(engine, Scheduler())
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    return [res[r] for r in rids]


# ---------------------------------------------------------------------------
# FairScheduler against JAX's on the same scripts
# ---------------------------------------------------------------------------

def _script(name, sched_cls, req_cls, resume_cls, tenant_cls):
    """Run one scheduler script; returns what it observed (pop orders,
    ledgers, pending counts, quota answers) as plain data."""
    def req(rid, tenant, mn=8, arrival=0, priority=0):
        return req_cls(request_id=rid, prompt=np.ones((4,), np.int32),
                       max_new_tokens=mn, arrival_step=arrival,
                       tenant=tenant, priority=priority)
    seen = []
    if name == "shares":
        s = sched_cls(tenants={"a": tenant_cls(weight=1.0),
                               "b": tenant_cls(weight=2.0),
                               "c": tenant_cls(weight=3.0)})
        for i in range(120):
            s.submit(req(i, "abc"[i % 3]))
        for _ in range(60):
            seen.append(s.pop_ready(0, free_slots=1, engine_idle=True)[0]
                        .tenant)
    elif name == "tiers":
        s = sched_cls(tenants={"a": tenant_cls(weight=1.0),
                               "b": tenant_cls(weight=100.0)})
        for i in range(4):
            s.submit(req(i, "a"))
        for _ in range(2):
            s.pop_ready(0, 1, True)
        s.submit(req(10, "b"))
        s.submit(req(11, "a", priority=3))
        seen = [r.request_id for _ in range(4)
                for r in s.pop_ready(0, 1, True)]
    elif name == "fifo_gate":
        s = sched_cls(max_wait_steps=5, min_admit=3)
        s.submit(req(0, "a", arrival=0))
        s.submit(req(1, "a", arrival=1))
        seen.append([r.request_id for r in s.pop_ready(1, 4, False)])
        s.submit(req(2, "a", arrival=2))
        seen.append([r.request_id for r in s.pop_ready(3, 4, False)])
    elif name == "requeue_credit":
        s = sched_cls()
        for i, t in enumerate("aabb"):
            s.submit(req(i, t))
        (r,) = s.pop_ready(0, 1, True)
        s.requeue(r)
        seen.append(s.pop_ready(0, 1, True)[0].request_id)
        s2 = sched_cls()
        s2.submit(req(0, "a", mn=20))
        s2.pop_ready(0, 1, True)
        pre = req(0, "a", mn=20)
        pre.resume = resume_cls(tokens=list(range(12)),
                                key=np.zeros(2, np.uint32))
        seen.append(dict(s2._usage))
        s2.requeue(pre)
        seen.append(dict(s2._usage))
        s2.pop_ready(0, 1, True)
        seen.append(dict(s2._usage))
    elif name == "idle_no_credit":
        s = sched_cls()
        rid = iter(range(1000))
        for t, n in (("a", 4), ("b", 4)):
            for _ in range(n):
                s.submit(req(next(rid), t, mn=10))
        for _ in range(8):
            s.pop_ready(0, 1, True)
        for _ in range(20):
            s.submit(req(next(rid), "b", mn=10))
        for _ in range(10):
            s.pop_ready(0, 1, True)
        for _ in range(6):
            s.submit(req(next(rid), "a", mn=10))
        seen = [s.pop_ready(0, 1, True)[0].tenant for _ in range(6)]
        seen.append(dict(s._usage))
    elif name == "pending_quota":
        s = sched_cls(tenants={"a": tenant_cls(max_queued=2)})
        for i, t in enumerate("aab"):
            s.submit(req(i, t))
        seen.append((s.tenant_pending("a"), s.tenant_pending("b"),
                     s.quota_exceeded("a"), s.quota_exceeded("b")))
        (r,) = s.pop_ready(0, 1, True)
        seen.append((r.request_id, s.tenant_pending(r.tenant),
                     s.quota_exceeded("a")))
        s.requeue(r)
        s.drop_where(lambda q: q.tenant == "b")
        seen.append((s.tenant_pending("a"), s.tenant_pending("b"),
                     s.pending()))
        with pytest.raises(ValueError, match="must be > 0"):
            sched_cls(tenants={"x": tenant_cls(weight=0.0)})
        with pytest.raises(ValueError, match="must be > 0"):
            sched_cls(default_weight=0.0)
    return seen


@pytest.mark.parametrize("name", ["shares", "tiers", "fifo_gate",
                                  "requeue_credit", "idle_no_credit",
                                  "pending_quota"])
def test_fair_scheduler_matches_jax(name):
    got = _script(name, FairScheduler, Request, ResumeState, TenantConfig)
    want = _script(name, JaxFair, JaxRequest, JaxResume, JaxTenant)
    assert got == want
    if name == "shares":
        assert [got.count(t) for t in "abc"] == [10, 20, 30]
    if name == "idle_no_credit":
        assert got[:6] == ["b", "a", "b", "a", "b", "a"]


def test_server_sheds_at_tenant_quota(setup):
    port, _, _ = setup
    dense = port["dense"]
    dense.reset()
    fe = Frontend(dense, tenants={"a": TenantConfig(max_queued=1)})
    p = _prompts(0, (5,))[0]
    ok = fe.submit(p, tenant="a", max_new_tokens=3)
    shed = fe.submit(p, tenant="a", max_new_tokens=3)
    free = fe.submit(p, tenant="b", max_new_tokens=3)
    assert fe.results[shed].reason == "shed"
    res = fe.run_until_idle()
    assert not isinstance(res[ok], RequestFailure)
    assert not isinstance(res[free], RequestFailure)
    st = fe.stats()
    assert st["tenants"]["a"]["shed"] == 1 and st["tenants"]["b"]["shed"] == 0


# ---------------------------------------------------------------------------
# token streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_streams_deliver_the_served_rows(setup, kind):
    """Iterator streams (pumping the server) and a callback deliver the
    served rows' tokens exactly; a bounded queue that is never drained
    keeps the newest ``capacity`` tokens and counts the rest dropped; a
    shed stream ends at once."""
    port, _, _ = setup
    engine = port[kind]
    prompts = _prompts(1, (5, 9, 12))
    news = [6, 4, 7]
    want = _plain(engine, [(p, dict(max_new_tokens=n))
                           for p, n in zip(prompts, news)])
    engine.reset()
    fe = Frontend(engine)
    got_cb = []
    streams = [fe.submit(p, max_new_tokens=n, stream=True)
               for p, n in zip(prompts[:2], news[:2])]
    cb = fe.submit(prompts[2], max_new_tokens=news[2],
                   on_token=got_cb.append)
    for s, p, w in zip(streams, prompts, want):
        assert s.read_all() == [int(t) for t in w[len(p):]]
        assert s.done and s.failure is None and s.dropped == 0
    fe.run_until_idle()
    assert got_cb == [int(t) for t in want[2][len(prompts[2]):]]
    assert cb.tokens_seen == news[2]
    engine.reset()
    fe = Frontend(engine, stream_capacity=4,
                  resilience=ResilienceConfig(max_queue_depth=1))
    s = fe.submit(prompts[0], max_new_tokens=12, stream=True)
    shed = fe.submit(prompts[1], max_new_tokens=4, stream=True)
    assert shed.done and shed.failure == "shed" and shed.read_all() == []
    fe.run_until_idle()
    row = fe.results[s.request_id]
    assert s.tokens_seen == 12 and s.dropped == 8
    assert s.drain() == [int(t) for t in row[-4:]]


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

def _drive_preemption(fe, prompts, sampled):
    lows = [dict(max_new_tokens=20), dict(max_new_tokens=20)]
    if sampled:
        lows[0].update(temperature=0.9, top_k=40, seed=11)
    low = [fe.submit(p, priority=0, **kw) for p, kw in zip(prompts, lows)]
    for _ in range(3):
        fe.pump()
    hi = fe.submit(prompts[2], max_new_tokens=4, priority=5)
    res = fe.run_until_idle()
    reqs = [(prompts[0], lows[0]), (prompts[1], lows[1]),
            (prompts[2], dict(max_new_tokens=4))]
    return [res[r] for r in low + [hi]], reqs


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_preempt_resume_matches_jax_and_unpreempted(setup, kind, sampled):
    """A high-priority arrival on a full pool evicts a low-priority
    stream mid-decode; the victim resumes by re-prefilling its history
    with its carried key: every stream equals JAX's front door's and the
    port's unpreempted run, with JAX's preemption and resume counts;
    nothing leaks."""
    port, jax_engine, _ = setup
    engine = port[kind]
    prompts = _prompts(6 + sampled, (5, 9, 12))
    engine.reset()
    fe = Frontend(engine, preemption=True)
    got, reqs = _drive_preemption(fe, prompts, sampled)
    je = jax_engine(kind)
    je.reset()
    jfe = JaxFrontend(je, preemption=True)
    want, _ = _drive_preemption(jfe, prompts, sampled)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    st, jst = fe.stats(), jfe.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    assert (st["preemptions"], st["resumes"]) == (jst["preemptions"],
                                                 jst["resumes"])
    assert all(s is None for s in engine._slots)
    if kind == "paged":
        assert not engine.manager._ref
        engine.manager.assert_consistent()
        # the eviction kept the prompt's prefix-index entries: the
        # resume's re-prefill reused them
        assert engine.prefix_cache_hit_rate() > 0
    for g, w in zip(got, _plain(engine, reqs)):
        np.testing.assert_array_equal(g, w)


def test_equal_priority_never_preempts_and_one_terminal(setup):
    """Equal priorities never evict; with tracing armed a preempted
    victim's trace carries the preempt and resume events and exactly one
    terminal ("completed"), like every other request's; the victim's
    queue wait restarts at its requeue (``wait_from``)."""
    port, _, _ = setup
    paged = port["paged"]
    prompts = _prompts(8, (5, 9, 12))
    paged.reset()
    fe = Frontend(paged, preemption=True)
    for p in prompts[:2]:
        fe.submit(p, max_new_tokens=12, priority=3)
    fe.pump()
    fe.pump()
    fe.submit(prompts[2], max_new_tokens=4, priority=3)
    fe.run_until_idle()
    assert fe.stats()["preemptions"] == 0
    paged.reset()
    fe = Frontend(paged, preemption=True,
                  observability=ObservabilityConfig(trace_requests=True))
    low = [fe.submit(p, max_new_tokens=20, priority=0) for p in prompts[:2]]
    fe.pump()
    fe.pump()
    hi = fe.submit(prompts[2], max_new_tokens=4, priority=5)
    requeued = None
    for _ in range(10):
        fe.pump()
        queued = [r for r in fe.scheduler._queue if r.resume is not None]
        if queued:
            requeued = queued[0]
            break
    assert requeued is not None and requeued.wait_from is not None
    assert requeued.wait_from > requeued.arrival_step
    fe.run_until_idle()
    tracer = fe.server.tracer
    victims = [r for r in low
               if "preempt" in tracer.traces[r].span_names()]
    assert victims
    for r in victims:
        assert "resume" in tracer.traces[r].span_names()
    for r in low + [hi]:
        assert tracer.traces[r].terminals == ["completed"]


def test_preempted_request_survives_snapshot_restore(setup, tmp_path):
    """A queued request carrying resume state rides the snapshot and
    finishes, after a restore into a freshly built paged engine, as the
    uninterrupted run did; the preemption policy survives too."""
    port, _, fresh = setup
    paged = port["paged"]
    prompts = _prompts(10, (5, 9, 12))

    def drive(fe):
        low = [fe.submit(p, max_new_tokens=16, priority=0) for p in
               prompts[:2]]
        return low + [fe.submit(prompts[2], max_new_tokens=12, priority=5,
                                arrival_step=2)]
    paged.reset()
    fe_ref = Frontend(paged, preemption=True)
    rids = drive(fe_ref)
    ref = fe_ref.run_until_idle()
    paged.reset()
    fe = Frontend(paged, preemption=True)
    assert drive(fe) == rids
    for _ in range(40):
        fe.pump()
        if fe.stats()["preemptions"]:
            break
    assert any(r.resume is not None for r in fe.scheduler._queue)
    path = str(tmp_path / "frontdoor.npz")
    fe.server.snapshot(path)
    engine2 = fresh("paged")
    srv = Server.restore(path, engine2, FairScheduler())
    assert srv.preemption
    res = srv.run_until_idle()
    for rid in rids:
        np.testing.assert_array_equal(res[rid], ref[rid])
    engine2.manager.assert_consistent()


def test_reattach_after_kill_sees_only_unseen_tokens(setup, tmp_path):
    """Each stream's delivered offset rides the snapshot (buffered,
    unconsumed tokens subtracted): a consumer re-attached after a kill
    and restore reads exactly the tokens it never took; the snapshot's
    meta records that offset; a live re-attach hands the buffer over."""
    port, _, fresh = setup
    paged = port["paged"]
    p = _prompts(30, (6,))[0]
    tail = [int(t) for t in _plain(paged, [(p, dict(max_new_tokens=12))])[0]
            [6:]]
    paged.reset()
    fe = Frontend(paged)
    s = fe.submit(p, max_new_tokens=12, stream=True)
    consumed = [next(s) for _ in range(6)]
    assert len(s._buf) > 0
    path = str(tmp_path / "stream.npz")
    fe.server.snapshot(path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
    assert meta["server"]["extras"]["frontend"]["emitted"][
        str(s.request_id)] == 6
    fe2 = Frontend.restore(path, fresh("paged"))
    s2 = fe2.attach_stream(s.request_id)
    assert consumed + s2.read_all() == tail
    assert s2.done and s2.failure is None
    paged.reset()
    fe = Frontend(paged)
    s = fe.submit(p, max_new_tokens=12, stream=True)
    consumed = [next(s) for _ in range(2)]
    assert len(s._buf) > 0
    assert consumed + fe.attach_stream(s.request_id).read_all() == tail


def test_chaos_with_preemption_and_wfq(setup):
    """Seeded transient faults against the whole front door (three
    weighted tenants, mixed priorities, preemption, streams, tracing):
    every request ends in exactly one terminal, completed rows equal the
    fault-free unpreempted runs, no slot or block leaks."""
    port, _, _ = setup
    paged = port["paged"]
    rs = np.random.RandomState(123)
    prompts = [rs.randint(0, 512, (int(n),)).astype(np.int32)
               for n in rs.randint(4, 16, size=9)]
    news = [4 + (i % 3) * 4 for i in range(9)]
    want = _plain(paged, [(p, dict(max_new_tokens=n))
                          for p, n in zip(prompts, news)])
    paged.reset()
    tenants = {"a": TenantConfig(weight=1.0), "b": TenantConfig(weight=2.0),
               "c": TenantConfig(weight=3.0)}
    fe = Frontend(paged, tenants=tenants, preemption=True,
                  observability=ObservabilityConfig(trace_requests=True),
                  resilience=ResilienceConfig(
                      retry_attempts=3, retry_backoff_s=0.001,
                      breaker_threshold=12, deadline_ticks=80))
    rids = []
    for i, p in enumerate(prompts):
        r = fe.submit(p, max_new_tokens=news[i], tenant="abc"[i % 3],
                      priority=2 if i % 4 == 0 else 0, arrival_step=i,
                      stream=i % 2 == 0)
        rids.append(getattr(r, "request_id", r))
    spec = ("serving.step_block:p=0.01;serving.harvest:p=0.01;"
            "serving.allocate:p=0.05;serving.prefill_tick:p=0.02;"
            "server.tick:p=0.02")
    with tfaults.injected(spec, seed=5):
        res = fe.run_until_idle(max_ticks=400)
    assert fe.scheduler.pending() == 0 and not paged.has_live()
    for rid, w in zip(rids, want):
        v = res[rid]
        if isinstance(v, RequestFailure):
            assert v.reason in ("timeout", "circuit_open", "shed")
        else:
            np.testing.assert_array_equal(v, w)
        assert len(fe.server.tracer.traces[rid].terminals) == 1
    assert not paged._jobs and not paged.manager._ref
    paged.manager.assert_consistent()
