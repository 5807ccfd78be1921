"""The port's SLO autoscaler (``paddle_tpu_torch.serving.autoscaler``)
against the JAX package's, on the tiny Llama whose weights move through
numpy.

The pure decision kernel gives JAX's kernel's decision sequence on the
same synthetic observation streams (hysteresis, flap, both cooldowns, an
up arming the down-cooldown, the size bounds, draining workers not
counted as capacity, a lease death bypassing the guards, a missing TTFT
not counted as a breach). On a port fleet: ``dry_run`` acts on nothing,
scale actions retry under ``fleet.scale`` and are dropped past the
budget, the decision metrics are exported. The kill-and-burst trace of
the JAX tests, paged and over the int8 arena: the autoscaled fleet
scales up on the burst, repairs a killed worker at once and drains back
to its minimum, every request ends in a result or an explicit failure,
completed rows equal the static-peak fleet's, greedy rows equal the JAX
package's ``Server`` on the same trace; a journaled autoscaled fleet
recovers with its scaled topology."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import AutoscalerConfig as JaxAutoscalerConfig
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import DecisionKernel as JaxDecisionKernel
from paddle_tpu.serving import Observation as JaxObservation
from paddle_tpu.serving import Server as JaxServer

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import metrics as om
from paddle_tpu_torch.serving import (Autoscaler, AutoscalerConfig,
                                      DecisionKernel, DecodeWorker, Fleet,
                                      Observation, PagedEngine,
                                      PrefillPagedEngine, PrefillWorker,
                                      RequestFailure, TraceConfig,
                                      generate_trace, replay)
from paddle_tpu_torch.utils import faults

KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
          prefill_chunk=8)
FAIL_REASONS = ("timeout", "poisoned", "circuit_open", "shed", "handoff",
                "worker_lost")


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages; the port's paged pools (2
    prefill, 2 base decode, 2 spare decode for the scale-up factory) and
    the int8 set (1 prefill, 2 + 2 decode), all over ONE port model; the
    JAX paged engines the greedy references run on."""
    jax.config.update("jax_enable_compilation_cache", False)
    # one intra-op thread: the tiny model's ops are too small to split,
    # and the suite runs several workers on one host
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    cpu = dict(device="cpu")
    port = {"pf": [PrefillPagedEngine(tm, **KW, **cpu) for _ in range(2)],
            "dc": [PagedEngine(tm, **KW, **cpu) for _ in range(4)],
            "pf8": [PrefillPagedEngine(tm, kv_int8=True, **KW, **cpu)],
            "dc8": [PagedEngine(tm, kv_int8=True, **KW, **cpu)
                    for _ in range(4)]}
    ref = {False: JaxEngine(jm, paged=True, **KW),
           True: JaxEngine(jm, paged=True, kv_int8=True, **KW)}
    yield port, ref, tm, {}
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    yield
    faults.clear()


def _reset(*engines):
    for e in engines:
        e.reset()


# ---------------------------------------------------------------------------
# the decision kernel against JAX's, on synthetic observation streams
# ---------------------------------------------------------------------------

def _kcfg(**kw):
    base = dict(ttft_slo_s=0.25, window=8, queue_high=4, pressure_high=0.9,
                breach_intervals=2, clear_intervals=2, up_cooldown=2,
                down_cooldown=2, min_decode=1, max_decode=3)
    base.update(kw)
    return base


def _o(ttft=None, queue=0, pressure=0.0, size=2, draining=0, dead=0):
    return dict(ttft_p95_s=ttft, queue_depth=queue,
                block_pressure=pressure, fleet_size=size,
                draining=draining, dead=dead)


# (config overrides, observation stream, JAX's tests' expected actions
# where they pin one)
_STREAMS = {
    "hysteresis": ({}, [_o(ttft=0.5)] * 2, ["hold", "up"]),
    "flap": ({}, [_o(ttft=0.5 if i % 2 == 0 else 0.01) for i in range(8)],
             ["hold"] * 8),
    "up_cooldown": ({}, [_o(queue=9)] * 8,
                    ["hold", "up", "hold", "hold", "up", "hold", "hold",
                     "up"]),
    "down_cooldown": ({}, [_o(size=3)] * 8,
                      ["hold", "down", "hold", "hold", "down", "hold",
                       "hold", "down"]),
    "up_arms_down": ({}, [_o(ttft=0.5)] * 2 + [_o(ttft=0.01, size=3)] * 4,
                     ["hold", "up", "hold", "hold", "down", "hold"]),
    "max_bound": (dict(max_decode=2), [_o(queue=9, size=2)] * 6, None),
    "min_bound": (dict(min_decode=2), [_o(ttft=0.01, size=2)] * 6, None),
    "draining": ({}, [_o(ttft=0.01, size=3, draining=2)] * 4, None),
    "lease_death": (dict(min_decode=2, max_decode=4, up_cooldown=5),
                    [_o(queue=9, size=2)] * 2 + [_o(queue=9, size=1,
                                                    dead=1)],
                    ["hold", "up", "up"]),
    "missing_ttft": ({}, [_o(size=2)] * 3, None),
    "missing_ttft_queue": ({}, [_o(queue=9)] * 2, ["hold", "up"]),
    "pressure": (dict(breach_intervals=1), [_o(pressure=0.95, size=2),
                                           _o(pressure=0.5, size=3)] * 3,
                 None),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_decision_kernel_equals_jax(name):
    over, stream, expect = _STREAMS[name]
    port = DecisionKernel(AutoscalerConfig(**_kcfg(**over)))
    jk = JaxDecisionKernel(JaxAutoscalerConfig(**_kcfg(**over)))
    got = [port.decide(Observation(**o)) for o in stream]
    want = [jk.decide(JaxObservation(**o)) for o in stream]
    assert [(d.action, d.reason) for d in got] \
        == [(d.action, d.reason) for d in want]
    assert (port.breach_streak, port.clear_streak, port.up_cold,
            port.down_cold) == (jk.breach_streak, jk.clear_streak,
                                jk.up_cold, jk.down_cold)
    if expect is not None:
        assert [d.action for d in got] == expect
    acts = [d.action for d in got]
    if name == "max_bound":
        assert "up" not in acts and any(d.reason == "at_max" for d in got)
    if name in ("min_bound", "draining"):
        assert "down" not in acts
    if name == "lease_death":
        assert got[-1].reason == "below_min"
    if name == "missing_ttft":
        assert "up" not in acts


# ---------------------------------------------------------------------------
# the autoscaler on a port fleet
# ---------------------------------------------------------------------------

def _mk_fleet(pfs, dcs, **kw):
    _reset(*pfs, *dcs)
    return Fleet([PrefillWorker(e) for e in pfs],
                 [DecodeWorker(e) for e in dcs], spill_depth=100, **kw)


def _spares(engines, make=None):
    """Scale-up factory: the spare engines first (built before the
    traffic, reset between runs), then ``make()``'s fresh ones."""
    pool = list(engines)

    def factory():
        if not pool:
            return make()
        e = pool.pop(0)
        e.reset()
        return e
    return factory


class TestAutoscalerOnFleet:
    def test_dry_run_acts_on_nothing(self, setup):
        port, _, _, _ = setup
        fleet = _mk_fleet(port["pf"], port["dc"][:2])
        sc = Autoscaler(fleet, _spares(port["dc"][2:]),
                        config=AutoscalerConfig(
                            queue_high=-1, breach_intervals=1,
                            min_decode=1, max_decode=4, up_cooldown=0,
                            dry_run=True))
        for _ in range(3):
            d = sc.step()
            assert d.action == "up" and not d.acted
        assert len(fleet.decode) == 2 and sc.scale_ups == 0
        ev = [e for e in fleet.flight.events() if e["kind"] == "autoscale"]
        assert len(ev) == 3 and all(e["dry_run"] for e in ev)

    def test_scale_action_retries_under_faults(self, setup):
        port, _, _, _ = setup
        fleet = _mk_fleet(port["pf"], port["dc"][:2])
        sc = Autoscaler(fleet, _spares(port["dc"][2:3]),
                        config=AutoscalerConfig(
                            queue_high=-1, breach_intervals=1,
                            min_decode=1, max_decode=3, up_cooldown=0))
        with faults.injected("fleet.scale:at=1"):
            d = sc.step()
        assert d.action == "up" and d.acted
        assert [w.name for w in fleet.decode][-1] == "scale0"
        assert sc.retries >= 1

    def test_exhausted_retries_drop_the_action(self, setup):
        port, _, _, _ = setup
        fleet = _mk_fleet(port["pf"], port["dc"][:2])
        sc = Autoscaler(fleet, _spares(port["dc"][2:3]),
                        config=AutoscalerConfig(
                            queue_high=-1, breach_intervals=1,
                            min_decode=1, max_decode=3, up_cooldown=0))
        with faults.injected("fleet.scale:every=1"):
            d = sc.step()
        assert d.action == "up" and not d.acted
        assert len(fleet.decode) == 2
        assert any(e["kind"] == "autoscale_action_failed"
                   for e in fleet.flight.events())

    def test_decision_metrics_exported(self, setup):
        port, _, _, _ = setup
        fleet = _mk_fleet(port["pf"], port["dc"][:2])
        sc = Autoscaler(fleet, _spares([]),
                        config=AutoscalerConfig(dry_run=True))
        om.reset()
        om.enable(True)
        try:
            sc.step()
            sc.step()
            dec = om.REGISTRY.get("pt_autoscaler_decisions_total")
            size = om.REGISTRY.get("pt_autoscaler_fleet_size")
            assert dec.value(action="hold") == 2
            assert size.value() == 2
        finally:
            om.enable(False)
            om.reset()
        assert "pt_autoscaler_decisions_total" in om.render_prometheus()


# ---------------------------------------------------------------------------
# the kill-and-burst trace: autoscaled against static peak
# ---------------------------------------------------------------------------

TRACE = dict(horizon=20, base_rate=0.25, bursts=1, burst_mult=5.0,
             burst_len=(6, 9), prompt_lo=4, prompt_hi=12, output_lo=4,
             output_hi=8, shared_fraction=0.25, shared_len=8,
             sampled_fraction=0.3)
SCALER = dict(min_decode=2, max_decode=4, interval_ticks=2, queue_high=1,
              ttft_slo_s=10.0, breach_intervals=2, clear_intervals=3,
              up_cooldown=2, down_cooldown=2)


def _submit(fleet):
    def submit(r):
        return fleet.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                            temperature=r.temperature, top_k=r.top_k,
                            seed=r.seed, arrival_step=r.arrival_step,
                            tenant=r.tenant, priority=r.priority)
    return submit


def _drive(trace, pfs, dcs, factory, autoscale, kill_ticks, **fleet_kw):
    """Replay ``trace`` through a fleet (killing the last live decode
    worker at each of ``kill_ticks``), then tick on to horizon + 40.
    Returns (fleet, scaler, {trace id: row}, ids)."""
    fleet = _mk_fleet(pfs, dcs, lease_misses=2, **fleet_kw)
    scaler = Autoscaler(fleet, factory, config=AutoscalerConfig(**SCALER)) \
        if autoscale else None
    state = {"killed": 0, "clock": 0}
    kills = list(kill_ticks or ())

    def on_tick(clock):
        state["clock"] = clock
        if state["killed"] < len(kills) and clock >= kills[state["killed"]]:
            live = [i for i, d in enumerate(fleet.decode) if not d.killed]
            if len(live) > 1:
                fleet.kill_decode_worker(live[-1])
                state["killed"] += 1
        if scaler is not None:
            scaler.on_tick(clock)

    ids = replay(trace, _submit(fleet), fleet.tick, fleet.busy,
                 max_ticks=2000, on_tick=on_tick)
    while state["clock"] < trace.config.horizon + 40:
        fleet.tick()
        on_tick(state["clock"] + 1)
    res = fleet.results
    rows = {}
    for tid, rid in ids.items():
        assert rid in res, f"request {rid} vanished"
        v = res[rid]
        if isinstance(v, RequestFailure):
            assert v.reason in FAIL_REASONS
        else:
            rows[tid] = np.asarray(v)
    for w in list(fleet.prefill) + list(fleet.decode):
        if fleet._alive(w.name):
            assert not w.engine.manager._ref
            w.engine.manager.assert_consistent()
    return fleet, scaler, rows, ids


def _peak_rows(cache, int8, trace, pfs, dcs):
    """The static-peak arm's rows (four decode workers, no kill, no
    scaling), cached per arena kind."""
    if int8 not in cache:
        cache[int8] = _drive(trace, pfs, dcs, None, False, None)[2]
    return cache[int8]


def _jax_rows(engine, trace):
    """The JAX package's unified Server on the trace's requests."""
    engine.reset()
    srv = JaxServer(engine)
    ids = {r.request_id: srv.submit(r.prompt,
                                    max_new_tokens=r.max_new_tokens,
                                    temperature=r.temperature,
                                    top_k=r.top_k, seed=r.seed)
           for r in trace.requests}
    res = srv.run_until_idle()
    return {t: np.asarray(res[i]) for t, i in ids.items()}


@pytest.mark.parametrize("int8", [False, True], ids=["paged", "kv_int8"])
def test_kill_and_burst(setup, int8):
    port, ref, tm, cache = setup
    pfs = port["pf8"] if int8 else port["pf"]
    dcs = port["dc8"] if int8 else port["dc"]
    # seed 1's base trace is too light to breach queue_high: thicker
    # arrivals make the burst force a scale-up (as in the JAX tests)
    extra = dict(base_rate=0.5, burst_mult=6.0) if int8 else {}
    trace = generate_trace(TraceConfig(seed=int(int8), vocab_size=512,
                                       **{**TRACE, **extra}))
    b0, b1 = trace.burst_windows[0]
    kill_ticks = [(b0 + b1) // 2, trace.config.horizon + 15]
    peak_rows = _peak_rows(cache, int8, trace, pfs, dcs)
    fleet, scaler, rows, _ = _drive(
        trace, pfs, dcs[:2],
        _spares(dcs[2:], lambda: PagedEngine(tm, kv_int8=int8, **KW,
                                             device="cpu")),
        True, kill_ticks)
    assert scaler.scale_ups >= 1
    assert any(d.reason == "below_min" for d in scaler.decisions)
    assert scaler.peak_size > 2
    assert len(fleet._live_decode()) == 2
    assert scaler.scale_downs >= 1 and scaler.removals >= 1
    both = set(rows) & set(peak_rows)
    assert len(both) >= len(trace) * 0.8
    for t in both:
        np.testing.assert_array_equal(rows[t], peak_rows[t])
    assert any(trace.requests[t].temperature > 0 for t in both)
    jrows = _jax_rows(ref[int8], trace)
    greedy = [t for t in both if trace.requests[t].temperature == 0]
    assert greedy
    for t in greedy:
        np.testing.assert_array_equal(rows[t], jrows[t])
    # on the CPU the engines run eagerly and capture nothing (0); on the
    # card each captured its decode graph once, when it was built
    for d in fleet.decode:
        assert d.engine.decode_compile_count() <= 1
    for w in fleet.prefill:
        assert w.engine.prefill_compile_count() <= 1


def test_journaled_autoscaled_fleet_recovers_its_topology(setup,
                                                         tmp_path):
    """The autoscaler's actions are journal records: a durable fleet
    that scaled up (and was checkpointed before it did) and is killed
    mid-traffic comes back with the scaled topology, and every stream
    submitted before the kill ends with the static-peak fleet's row."""
    port, _, _, cache = setup
    pfs, dcs = port["pf"], port["dc"]
    trace = generate_trace(TraceConfig(seed=0, vocab_size=512, **TRACE))
    peak_rows = _peak_rows(cache, False, trace, pfs, dcs)
    d = str(tmp_path / "d")
    fleet = _mk_fleet(pfs, dcs[:2], lease_misses=2, durability=d)
    scaler = Autoscaler(fleet, _spares(dcs[2:]),
                        config=AutoscalerConfig(**SCALER))
    submit = _submit(fleet)
    sched = sorted(trace.schedule(), key=lambda e: (e[0], e[1].request_id))
    fleet.checkpoint()
    ids, i, clock = {}, 0, 0
    while scaler.scale_ups == 0 or clock < trace.burst_windows[0][1]:
        while i < len(sched) and sched[i][0] <= clock:
            ids[sched[i][1].request_id] = submit(sched[i][1])
            i += 1
        fleet.tick()
        clock += 1
        scaler.on_tick(clock)
        assert clock < 200, "the burst never scaled the pool up"
    live = [w.name for w in fleet.decode if fleet._alive(w.name)]
    assert any(n.startswith("scale") for n in live)
    by = {w.name: w.engine for w in fleet.prefill + fleet.decode}
    del fleet, scaler
    _reset(*pfs, *dcs)
    fleet2 = Fleet.recover(d, engine_factory=lambda role, name: by[name],
                           spill_depth=100, lease_misses=2)
    assert [w.name for w in fleet2.decode] == live
    assert fleet2.last_recovery["epoch"] == 1
    res = fleet2.run_until_idle(max_ticks=500)
    for t, rid in ids.items():
        np.testing.assert_array_equal(np.asarray(res[rid]), peak_rows[t])
    for w in fleet2.prefill + fleet2.decode:
        assert not w.engine.manager._ref
        w.engine.manager.assert_consistent()
