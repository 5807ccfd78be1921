"""Port serving resilience (``paddle_tpu_torch.serving.resilience``,
``utils.faults``, the engines' dispatch/harvest, quarantine and
snapshot mechanism) against the JAX package.

The same fault spec and seed fire on the same calls in both registries;
under one seeded chaos schedule over all five transient sites plus the
poison, the port's ``Server`` and the JAX ``Server`` give the same
results, failure reasons and counts, resilience counters and flight
event kinds, on the dense and the paged engine. Kill and restore, in a
freshly built engine, finishes every stream token-identical to the
uninterrupted runs of both packages. One JAX engine of each kind serves
the whole file (a second paged backend compiled in one process is a
known jaxlib heap hazard)."""
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.observability import ObservabilityConfig as JaxObsConfig
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import RequestFailure as JaxFailure
from paddle_tpu.serving import ResilienceConfig as JaxResConfig
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import ObservabilityConfig
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      FairScheduler, PagedEngine,
                                      RequestFailure, ResilienceConfig,
                                      Scheduler, Server)
from paddle_tpu_torch.serving.resilience import load_snapshot, save_snapshot
from paddle_tpu_torch.utils import faults as tfaults

DENSE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                prompt_buckets=(8, 16, 32))
PAGED_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                prefill_chunk=8)


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages (weights through numpy) and one
    dense and one paged engine of each; ``fresh(kind)`` builds another
    port engine on the same weights (a restarted process)."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))

    def fresh(kind):
        m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        m.load_state_dict(params_from_jax(named))
        if kind == "dense":
            return ContinuousBatchingEngine(m, device="cpu", **DENSE_KW)
        return PagedEngine(m, device="cpu", **PAGED_KW)

    engines = {"dense": (JaxEngine(jm, **DENSE_KW),
                         ContinuousBatchingEngine(tm, device="cpu",
                                                  **DENSE_KW)),
               "paged": (JaxEngine(jm, paged=True, **PAGED_KW),
                         PagedEngine(tm, device="cpu", **PAGED_KW))}
    return engines, fresh


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _requests(seed, n=6, arrivals=True):
    """Ragged greedy requests with one seeded sampled stream, staggered
    arrivals."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kw = dict(max_new_tokens=int(rs.randint(4, 10)))
        if i == 2:
            kw.update(temperature=0.8, top_k=20, seed=5)
        if arrivals:
            kw["arrival_step"] = i
        out.append((rs.randint(0, 512, (int(rs.randint(4, 20)),))
                    .astype(np.int32), kw))
    return out


def _side(which, engines, kind):
    je, te = engines[kind]
    if which == "jax":
        return (je, JaxServer, JaxScheduler, JaxResConfig, JaxObsConfig,
                jfaults)
    return te, Server, Scheduler, ResilienceConfig, ObservabilityConfig, \
        tfaults


def _run(which, engines, kind, reqs, spec=None, seed=0, res_kw=None,
         budget=8, max_ticks=400, dump_dir=None):
    eng, srv_cls, sched_cls, cfg_cls, obs_cls, fl = _side(which, engines,
                                                         kind)
    eng.reset()
    srv = srv_cls(eng, sched_cls(prefill_token_budget=budget),
                  resilience=cfg_cls(**(res_kw or {})),
                  observability=obs_cls(flight_dump_dir=dump_dir))
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    if spec:
        with fl.injected(spec, seed=seed):
            res = srv.run_until_idle(max_ticks=max_ticks)
    else:
        res = srv.run_until_idle(max_ticks=max_ticks)
    return srv, [res[r] for r in rids]


def _outcome(v):
    """A result as comparable data: the row, or (reason, tokens)."""
    if isinstance(v, (RequestFailure, JaxFailure)):
        return ("fail", v.reason, v.tokens_emitted)
    return ("ok", np.asarray(v).tolist())


def _assert_same(a, b):
    assert [_outcome(v) for v in a] == [_outcome(v) for v in b]


def _both(engines, kind, reqs, **kw):
    jsrv, a = _run("jax", engines, kind, reqs, **kw)
    tsrv, b = _run("port", engines, kind, reqs, **kw)
    _assert_same(b, a)
    return jsrv, tsrv, a, b


def _counters(srv):
    return srv._res.counters()


# ---------------------------------------------------------------------------
# the fault registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "a:at=3", "a:every=4", "a:p=0.3", "a:p=0.5,times=3",
    "a:every=2,times=2;b:p=0.2;c:at=1", "b:p=0.05;a:p=0.05,every=7"])
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_schedules_fire_on_the_same_calls(spec, seed):
    """Over every spec key, several sites interleaved, the same spec and
    seed fire on the same calls in both registries."""
    fires = {}
    for name, fl in (("jax", jfaults), ("port", tfaults)):
        fl.configure(spec, seed=seed)
        fires[name] = [(site, fl.should_fire(site))
                       for _ in range(40) for site in ("a", "b", "c")]
        fires[name + "_stats"] = fl.site_stats()
        fl.clear()
    assert fires["port"] == fires["jax"]
    assert fires["port_stats"] == fires["jax_stats"]


def test_fault_registry_contract():
    """Disarmed by default; fault_point raises InjectedFault; bad specs
    raise; the context manager disarms."""
    assert not tfaults.active() and not tfaults.should_fire("x")
    with tfaults.injected("x:at=1"):
        assert tfaults.active()
        with pytest.raises(tfaults.InjectedFault, match="'x'"):
            tfaults.fault_point("x")
    assert not tfaults.active()
    for bad in ("x", "x:zz=1", ":at=1"):
        with pytest.raises(ValueError):
            tfaults.configure(bad)


def test_env_knobs_match_jax(monkeypatch):
    """``ResilienceConfig.from_env`` and the flag readers give what the
    JAX package gives for the same environment."""
    from paddle_tpu.utils import flags as jflags
    from paddle_tpu_torch.utils import flags as tflags
    for k, v in {"PT_SERVING_DEADLINE_TICKS": "9", "PT_SERVING_RETRIES":
                 "4", "PT_SERVING_BACKOFF_S": "0.5",
                 "PT_SERVING_NAN_SENTINEL": "off",
                 "PT_SERVING_MAX_QUEUE_DEPTH": " ",
                 "FLAGS_check_nan_inf": "1"}.items():
        monkeypatch.setenv(k, v)
    assert ResilienceConfig.from_env().__dict__ == \
        JaxResConfig.from_env().__dict__
    for fn in ("env_float", "env_int"):
        assert getattr(tflags, fn)("PT_SERVING_RETRIES", 1) == \
            getattr(jflags, fn)("PT_SERVING_RETRIES", 1)
    assert tflags.env_set("PT_SERVING_MAX_QUEUE_DEPTH") and \
        not tflags.env_set("PT_NOT_SET_ANYWHERE")
    assert tflags.env_str("PT_SERVING_RETRIES") == "4"
    tflags.define_flag("check_nan_inf", False)
    assert tflags.FLAGS.check_nan_inf is True
    assert set(tflags.get_flags()) == set(jflags.get_flags())


# ---------------------------------------------------------------------------
# chaos parity
# ---------------------------------------------------------------------------

CHAOS = ("serving.step_block:p=0.08;serving.harvest:p=0.08;"
         "serving.prefill_tick:p=0.08;serving.allocate:p=0.15;"
         "server.tick:p=0.08;serving.poison:at=7,times=1")


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_chaos_parity(setup, kind):
    """One seeded schedule over the five transient sites plus a poison:
    the same results (rows token-identical; failures with the same
    reason and tokens), the same resilience counters and the same
    sequence of flight-event kinds in both packages; every request
    ends, nothing leaks, and the transient faults are invisible in the
    surviving streams."""
    engines, _ = setup
    reqs = _requests(11)
    cfg = dict(retry_attempts=3, retry_backoff_s=0.0005,
               breaker_threshold=12, seed=3)
    jsrv, tsrv, _, got = _both(engines, kind, reqs, spec=CHAOS, seed=3,
                               res_kw=cfg)
    assert _counters(tsrv) == _counters(jsrv)
    c = _counters(tsrv)
    assert c["retries"] > 0 and c["tick_faults"] > 0 and \
        c["failures_by_reason"] == {"poisoned": 1}
    assert [e["kind"] for e in tsrv.flight.events()] == \
        [e["kind"] for e in jsrv.flight.events()]
    _, clean = _run("port", engines, kind, reqs)
    for v, w in zip(got, clean):
        if not isinstance(v, RequestFailure):
            np.testing.assert_array_equal(v, w)
    te = engines[kind][1]
    assert not te.has_live() and tsrv.scheduler.pending() == 0
    if kind == "paged":
        te.manager.assert_consistent()
        assert not te.manager._ref


def test_harvest_retry_never_replays(setup):
    """A fault between the replay and the host read parks the block:
    the retry reads it without running the block again (the steps count
    the blocks dispatched, not the harvest attempts)."""
    engines, _ = setup
    reqs = _requests(12, n=2, arrivals=False)
    _, clean = _run("port", engines, "paged", reqs)
    steps = engines["paged"][1].steps
    srv, got = _run("port", engines, "paged", reqs,
                    spec="serving.harvest:every=2",
                    res_kw=dict(retry_backoff_s=0.0))
    _assert_same(got, clean)
    assert engines["paged"][1].steps == steps
    assert srv.stats()["retries"] > 0


# ---------------------------------------------------------------------------
# the NaN sentinel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_poison_quarantines_only_its_slot(setup, kind):
    """Poison at the third block: the victim alone ends "poisoned" and
    every other stream equals the clean run. JAX quarantines the same
    victim; on the dense engine its results are the port's. On the paged
    engine the later requests reuse the victim's freed blocks: JAX
    releases them with the NaN in them and its chunk read (masked
    columns still multiply, 0 x NaN) quarantines those requests too —
    the port zeroes them first (the deliberate difference), and agrees
    with JAX on every request JAX completes."""
    engines, _ = setup
    reqs = _requests(13, n=5, arrivals=False)
    _, jax_res = _run("jax", engines, kind, reqs,
                      spec="serving.poison:at=3")
    _, got = _run("port", engines, kind, reqs, spec="serving.poison:at=3")
    _, clean = _run("port", engines, kind, reqs)
    fails = [i for i, v in enumerate(got) if isinstance(v, RequestFailure)]
    assert len(fails) == 1 and got[fails[0]].reason == "poisoned"
    for i, (v, w) in enumerate(zip(got, clean)):
        if i not in fails:
            np.testing.assert_array_equal(v, w)
    jfails = [i for i, v in enumerate(jax_res)
              if isinstance(v, JaxFailure)]
    assert {jax_res[i].reason for i in jfails} == {"poisoned"}
    assert _outcome(jax_res[fails[0]]) == _outcome(got[fails[0]])
    for i, v in enumerate(jax_res):
        if i not in jfails:
            np.testing.assert_array_equal(got[i], v)
    assert len(jfails) == (1 if kind == "dense" else 3)


def test_sentinel_off_lets_the_stream_run(setup):
    """``nan_sentinel=False``: the gate is the config, not the flags —
    the poisoned request returns its (garbage) tokens, as in JAX."""
    engines, _ = setup
    reqs = _requests(14, n=1, arrivals=False)
    _, _, _, got = _both(engines, "dense", reqs,
                         spec="serving.poison:at=1",
                         res_kw=dict(nan_sentinel=False))
    assert not isinstance(got[0], RequestFailure)


# ---------------------------------------------------------------------------
# deadlines, queue wait, shedding, the breaker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_deadlines_and_queue_wait_match_jax(setup, kind):
    """Per-request tick deadlines (in flight and queued) and the
    server's queue-wait cap give JAX's outcomes; cancelled paged
    requests release their blocks at exact refcounts."""
    engines, _ = setup
    reqs = _requests(15, n=6, arrivals=False)
    reqs[1][1].update(max_new_tokens=20, deadline_ticks=2)  # in flight
    reqs[4][1]["deadline_ticks"] = 1                        # queued
    jsrv, tsrv, _, got = _both(engines, kind, reqs,
                               res_kw=dict(max_queue_wait_ticks=6))
    assert _counters(tsrv) == _counters(jsrv)
    assert _outcome(got[1])[:2] == _outcome(got[4])[:2] == \
        ("fail", "timeout")
    assert got[1].tokens_emitted > 0 and got[4].tokens_emitted == 0
    if kind == "paged":
        engines[kind][1].manager.assert_consistent()
        assert not engines[kind][1].manager._ref


def test_shedding_matches_jax(setup):
    """With ``max_queue_depth`` the overflow is shed at submit."""
    engines, _ = setup
    reqs = _requests(16, n=6, arrivals=False)
    jsrv, tsrv, _, got = _both(engines, "paged", reqs,
                               res_kw=dict(max_queue_depth=3))
    assert [_outcome(v)[1] for v in got[3:]] == ["shed"] * 3
    assert _counters(tsrv) == _counters(jsrv)
    assert tsrv.stats()["tenants"] == jsrv.stats()["tenants"]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_breaker_drains_everything(setup, kind, tmp_path):
    """Every dispatch fails: the breaker opens after the threshold, every
    request ends ``circuit_open``, the flight ring is dumped, and all
    blocks come back — as in JAX. The threshold is reached within one
    tick's retries: a prefill tick that succeeds between two failed
    decode dispatches resets the consecutive count, in both packages."""
    engines, _ = setup
    reqs = _requests(17, n=4, arrivals=False)
    cfg = dict(retry_attempts=3, retry_backoff_s=0.0, breaker_threshold=4)
    jsrv, _ = _run("jax", engines, kind, reqs,
                   spec="serving.step_block:every=1", res_kw=cfg,
                   dump_dir=str(tmp_path / "jax"))
    tsrv, got = _run("port", engines, kind, reqs,
                     spec="serving.step_block:every=1", res_kw=cfg,
                     dump_dir=str(tmp_path / "port"))
    assert {_outcome(v)[1] for v in got} == {"circuit_open"}
    assert _counters(tsrv) == _counters(jsrv)
    assert [e["kind"] for e in tsrv.flight.events()] == \
        [e["kind"] for e in jsrv.flight.events()]
    with open(tsrv.flight.last_dump_path) as f:
        dump = json.load(f)
    assert dump["reason"] == "circuit_open" and dump["events"]
    if kind == "paged":
        engines[kind][1].manager.assert_consistent()
        assert not engines[kind][1].manager._ref


# ---------------------------------------------------------------------------
# kill and restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kill", [("dense", 2), ("paged", 2),
                                       ("paged", 5)])
def test_kill_and_restore(setup, kind, kill, tmp_path):
    """Run ``kill`` ticks, snapshot, restore into a freshly built engine
    and finish: every stream equals the uninterrupted port run and the
    JAX run. The paged kill at tick 2 lands mid-prefill (a pending chunk
    job) with another request decoding."""
    engines, fresh = setup
    rs = np.random.RandomState(18)
    shape = ((5, dict(max_new_tokens=12)), (21, dict(max_new_tokens=6)),
             (9, dict(max_new_tokens=8, temperature=0.8, top_k=20,
                      seed=5)),
             (14, dict(max_new_tokens=10)), (6, dict(max_new_tokens=7)))
    reqs = [(rs.randint(0, 512, (L,)).astype(np.int32),
             dict(kw, arrival_step=i)) for i, (L, kw) in enumerate(shape)]
    _, _, ref, _ = _both(engines, kind, reqs)
    te = engines[kind][1]
    te.reset()
    srv = Server(te, Scheduler(prefill_token_budget=8))
    for p, kw in reqs:
        srv.submit(p, **kw)
    srv.run_until_idle(max_ticks=kill)
    assert te.has_live()
    if kind == "paged" and kill == 2:
        assert te._jobs and te.has_decoding()
    path = str(tmp_path / "snap.npz")
    srv.snapshot(path)
    eng2 = fresh(kind)
    srv2 = Server.restore(path, eng2, Scheduler(prefill_token_budget=8))
    res = srv2.run_until_idle()
    _assert_same([res[r] for r in range(len(reqs))], ref)
    assert eng2.decode_compile_count() == 0     # the CPU runs eagerly
    if kind == "paged":
        eng2.manager.assert_consistent()
        assert not eng2.manager._ref
    assert sorted(os.listdir(tmp_path)) == ["snap.npz",
                                            "snap.npz.flight.json"]
    kinds = [e["kind"] for e in srv2.flight.events()]
    assert kinds.count("snapshot") == 1 and kinds[-1] != "snapshot" \
        and "restored" in kinds


def test_restore_refuses_a_mismatched_engine(setup, tmp_path):
    """A dense snapshot into the paged engine, a key array of a dtype
    that does not hold key words (float32) and a different pool are all
    refused before any state is touched."""
    engines, fresh = setup
    te = engines["dense"][1]
    te.reset()
    path = str(tmp_path / "d.npz")
    te.snapshot(path)
    with pytest.raises(ValueError, match="pool_specs|mismatch"):
        engines["paged"][1].restore(path)
    meta, arrays = load_snapshot(path)
    arrays["state_key"] = arrays["state_key"].astype(np.float32)
    save_snapshot(path, meta, arrays)
    with pytest.raises(ValueError, match="state_key"):
        te.restore(path)
    assert sorted(os.listdir(tmp_path)) == ["d.npz"]


def test_snapshot_is_atomic(setup, tmp_path):
    """Overwrites go through a rename; a write that fails leaves no
    temp file."""
    from paddle_tpu_torch.distributed.checkpoint import atomic_write
    engines, _ = setup
    te = engines["paged"][1]
    te.reset()
    path = str(tmp_path / "s.npz")
    te.snapshot(path)
    te.snapshot(path)

    def boom(f):
        raise IOError("disk full")
    with pytest.raises(IOError):
        atomic_write(str(tmp_path / "t.bin"), boom)
    assert sorted(os.listdir(tmp_path)) == ["s.npz"]


# ---------------------------------------------------------------------------
# inertness, preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_disarmed_is_inert(setup, kind):
    """With faults disarmed (default config) the streams equal JAX's and
    nothing is counted; on the CPU nothing is captured either."""
    engines, _ = setup
    jsrv, tsrv, _, _ = _both(engines, kind, _requests(19))
    c = _counters(tsrv)
    assert c == _counters(jsrv) and c["requests_failed"] == 0 \
        and c["retries"] == c["step_failures"] == c["tick_faults"] == 0
    te = engines[kind][1]
    assert te.decode_compile_count() == te.prefill_compile_count() == 0


def test_preemption_is_refused(setup, monkeypatch):
    """Preemption is refused only over a scheduler that is not
    priority-aware (the FIFO one would hand the freed slot back to its
    victim), as in JAX; the env knob then leaves it off, and over a
    ``FairScheduler`` it arms."""
    engines, _ = setup
    with pytest.raises(ValueError, match="priority-aware"):
        Server(engines["dense"][1], preemption=True)
    assert Server(engines["dense"][1], FairScheduler(),
                  preemption=True).preemption is True
    monkeypatch.setenv("PT_SERVING_PREEMPTION", "1")
    assert Server(engines["dense"][1]).preemption is False
    assert Server(engines["dense"][1], FairScheduler()).preemption is True
