"""Port observability (``paddle_tpu_torch.observability``, the native host
tracer of ``core.native_api``, ``profiler``) against the JAX package.

The metrics registry renders the same bytes for the same operations and
the port's families carry JAX's names, help strings and labels; the
flight recorder's meta round trip and the request tracer's chrome
events equal JAX's (timestamps masked); a traced server run gives the
same request rows in both packages, with exactly one terminal per
request; the native tracer (built with ``g++``, and its Python path)
dumps JAX's event structure; the profiler gates its host ring as JAX's
does, and ``Server.export_trace`` merges request rows, tick markers and
``RecordEvent`` host spans into one trace."""
import json
import os
import time

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.profiler as jprofiler
from paddle_tpu.core.native_api import NativeTracer as JaxTracer
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.observability import FlightRecorder as JaxFlight
from paddle_tpu.observability import ObservabilityConfig as JaxObsConfig
from paddle_tpu.observability import RequestTracer as JaxTracerR
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import ResilienceConfig as JaxResConfig
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.utils import faults as jfaults

import paddle_tpu_torch.profiler as profiler
from paddle_tpu_torch import core
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.core.native_api import NativeTracer
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.observability import (FlightRecorder,
                                            ObservabilityConfig,
                                            RequestTracer, metrics)
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedEngine, ResilienceConfig, Server)
from paddle_tpu_torch.utils import faults as tfaults

DENSE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                prompt_buckets=(8, 16, 32))
PAGED_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                prefill_chunk=8)


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages (weights through numpy), one
    dense and one paged engine of each."""
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    return {"dense": (JaxEngine(jm, **DENSE_KW),
                      ContinuousBatchingEngine(tm, device="cpu",
                                               **DENSE_KW)),
            "paged": (JaxEngine(jm, paged=True, **PAGED_KW),
                      PagedEngine(tm, device="cpu", **PAGED_KW))}


@pytest.fixture(autouse=True)
def _isolated():
    """Disarmed faults and zeroed, disabled registries around every
    test, in both packages."""
    for fl in (jfaults, tfaults):
        fl.clear()
    prev = (jmetrics.enabled(), metrics.enabled())
    jmetrics.REGISTRY.reset()
    metrics.REGISTRY.reset()
    yield
    for fl in (jfaults, tfaults):
        fl.clear()
    jmetrics.enable(prev[0])
    metrics.enable(prev[1])
    jmetrics.REGISTRY.reset()
    metrics.REGISTRY.reset()


def _requests(seed, n=4):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 512, (int(rs.randint(4, 20)),)).astype(np.int32),
             dict(max_new_tokens=int(rs.randint(3, 9)), arrival_step=i))
            for i in range(n)]


def _mask(ev):
    """A chrome event without its clock and process fields."""
    return {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid")}


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _exercise(mod):
    """The same operations on a fresh registry of either package."""
    mod.enable(True)
    reg = mod.Registry()
    c = reg.counter("t_c", "a counter", labels=("site",))
    c.inc(site="a")
    c.inc(2.5, site='q"uo\\te\n')
    g = reg.gauge("t_g", "a gauge")
    g.set(7.5)
    g.inc(0.5)
    h = reg.histogram("t_h", "a histogram", labels=("tenant",),
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0, 1.0):
        h.observe(v, tenant="x")
    with pytest.raises(ValueError):
        c.inc(-1, site="a")
    with pytest.raises(ValueError):
        reg.gauge("t_c")
    return reg, h.recent_quantile(0.5, tenant="x")


def test_registry_renders_the_same_bytes():
    """Byte-identical ``render_prometheus()`` and ``dump()`` (as JSON)
    for the same operations; the same rolling quantile."""
    a, qa = _exercise(jmetrics)
    b, qb = _exercise(metrics)
    assert b.render_prometheus() == a.render_prometheus()
    assert json.dumps(b.dump(), sort_keys=True) == \
        json.dumps(a.dump(), sort_keys=True)
    assert qa == qb == 1.0


def test_families_match_jax():
    """Every family the port registers at import is JAX's family of the
    same name: kind, help string, labels (and buckets)."""
    jd, td = jmetrics.dump(), metrics.dump()
    assert len(td) >= 30
    for name, fam in td.items():
        assert name in jd, name
        assert {k: fam[k] for k in ("kind", "help", "label_names")} == \
            {k: jd[name][k] for k in ("kind", "help", "label_names")}, name
        if fam["kind"] == "histogram":
            assert metrics.REGISTRY.get(name).bounds == \
                jmetrics.REGISTRY.get(name).bounds


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_served_counters_match_stats_and_jax(setup, kind):
    """With metrics on, the engine's token and step counters equal
    ``Server.stats()``, and every count the two packages share equals
    JAX's over the same stream; with metrics off nothing is recorded."""
    reqs = _requests(3)
    got = {}
    for name, (eng, srv_cls, mod) in {
            "jax": (setup[kind][0], JaxServer, jmetrics),
            "port": (setup[kind][1], Server, metrics)}.items():
        eng.reset()
        mod.REGISTRY.reset()
        mod.enable(True)
        srv = srv_cls(eng)
        for p, kw in reqs:
            srv.submit(p, **kw)
        srv.run_until_idle()
        mod.enable(False)
        st = srv.stats()
        r = mod.REGISTRY
        assert r.get("pt_engine_tokens_emitted_total").value() == \
            st["tokens_emitted"]
        assert r.get("pt_engine_decode_steps_total").value() == \
            st["decode_steps"]
        got[name] = {n: f["samples"] for n, f in mod.dump().items()
                     if f["kind"] == "counter"}
    shared = set(got["port"]) & set(got["jax"])
    assert {"pt_server_requests_completed_total",
            "pt_engine_prefills_total",
            "pt_engine_decode_tokens_total"} <= shared
    for n in shared:
        assert got["port"][n] == got["jax"][n], n
    metrics.REGISTRY.reset()
    eng = setup[kind][1]
    eng.reset()
    srv = Server(eng)
    srv.submit(reqs[0][0], max_new_tokens=3)
    srv.run_until_idle()
    assert all(not f["samples"] for f in metrics.dump().values())


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _flight_ops(cls, capacity):
    fr = cls(capacity=capacity)
    for i in range(7):
        fr.record("tick", clock=i, queue=i % 3)
    fr.record("retry", attempt=1, backoff_s=0.25)
    return fr


def _no_t(meta):
    return dict(meta, events=[{k: v for k, v in e.items() if k != "t"}
                              for e in meta["events"]])


@pytest.mark.parametrize("capacity", [0, 4, 16])
def test_flight_meta_round_trip_matches_jax(capacity, tmp_path):
    """``to_meta``/``restore_meta`` give what JAX's give (the wall
    stamps masked); a restored ring continues the sequence; the dump
    file has JAX's keys and is written atomically."""
    a, b = _flight_ops(JaxFlight, capacity), _flight_ops(FlightRecorder,
                                                         capacity)
    assert _no_t(b.to_meta()) == _no_t(a.to_meta())
    a2, b2 = JaxFlight(capacity=capacity), FlightRecorder(capacity=capacity)
    a2.restore_meta(a.to_meta())
    b2.restore_meta(b.to_meta())
    for fr in (a2, b2):
        fr.record("restored", clock=9)
    assert _no_t(b2.to_meta()) == _no_t(a2.to_meta())
    pa = a.dump(str(tmp_path / "a" / "j.json"), reason="x")
    pb = b.dump(str(tmp_path / "b" / "p.json"), reason="x")
    with open(pa) as fa, open(pb) as fb:
        ja, jb = json.load(fa), json.load(fb)
    assert sorted(jb) == sorted(ja) and jb["format"] == ja["format"]
    assert os.listdir(tmp_path / "b") == ["p.json"]


def test_flight_capacity_knob(monkeypatch):
    monkeypatch.setenv("PT_FLIGHT_RECORDER_SIZE", "3")
    assert FlightRecorder().capacity == JaxFlight().capacity == 3
    with pytest.raises(ValueError):
        FlightRecorder(capacity=-1)


# ---------------------------------------------------------------------------
# request tracing
# ---------------------------------------------------------------------------

def _trace_ops(cls):
    t = cls(enabled=True, max_requests=2)
    for rid in (0, 1, 2):
        t.start(rid)
        t.span_end(rid, "queue_wait", shared_blocks=1)
        t.span_at(rid, "prefill", 0.0, tokens=5)
        t.span_begin(rid, "decode", slot=rid)
        t.instant(rid, "harvest", tokens=3)
        t.span_end(rid, "never_opened")
    t.server_instant("retry", attempt=0)
    t.server_span_at("tick", 0.0, clock=0)
    t.terminal(0, "completed", tokens=3)
    t.terminal(1, "timeout", tokens=1)
    t.terminal(1, "shed")                 # a double terminal is kept
    t.start(3)                            # evicts the oldest terminated
    t.terminal(3, "poisoned")
    return t


def test_tracer_events_match_jax():
    """The same calls give the same chrome events (clock masked), the
    same terminal states and the same eviction of terminated traces."""
    a, b = _trace_ops(JaxTracerR), _trace_ops(RequestTracer)
    assert [_mask(e) for e in b.chrome_events(pid=1)] == \
        [_mask(e) for e in a.chrome_events(pid=1)]
    assert b.terminal_states() == a.terminal_states()
    off = RequestTracer(enabled=False)
    off.start(0)
    off.terminal(0, "completed")
    assert off.traces == {} and len(off.chrome_events()) == 1


def _rows(srv):
    """Per request: its span names and args in order, clock masked."""
    return {rid: [(s["name"], s["args"]) for s in tr.spans]
            for rid, tr in srv.tracer.traces.items()}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_traced_serving_matches_jax(setup, kind):
    """A traced run under a seeded chaos schedule (retries, tick faults,
    a deadline; a poison on the dense engine — the paged poison's blast
    radius differs from JAX's by design, see
    test_torch_port_resilience.py): the port's request rows equal JAX's
    span for span, and every request has exactly one terminal."""
    reqs = [(p, dict(kw, arrival_step=0)) for p, kw in _requests(5, n=5)]
    reqs[4][1]["deadline_ticks"] = 1
    spec = ("serving.step_block:p=0.1;serving.harvest:p=0.1;"
            "server.tick:p=0.1" + (";serving.poison:at=2"
                                   if kind == "dense" else ""))
    rows, kinds = {}, {}
    for name, (eng, srv_cls, cfg_cls, obs_cls, fl) in {
            "jax": (setup[kind][0], JaxServer, JaxResConfig, JaxObsConfig,
                    jfaults),
            "port": (setup[kind][1], Server, ResilienceConfig,
                     ObservabilityConfig, tfaults)}.items():
        eng.reset()
        srv = srv_cls(eng, resilience=cfg_cls(retry_backoff_s=0.0,
                                              retry_attempts=4),
                      observability=obs_cls(trace_requests=True))
        for p, kw in reqs:
            srv.submit(p, **kw)
        with fl.injected(spec, seed=1):
            srv.run_until_idle()
        rows[name] = _rows(srv)
        kinds[name] = [e["kind"] for e in srv.flight.events()]
        assert all(len(t) == 1
                   for t in srv.tracer.terminal_states().values())
        assert eng.tracer is srv.tracer
    assert rows["port"] == rows["jax"]
    assert kinds["port"] == kinds["jax"]
    terminals = [s[0] for r in rows["port"].values() for s in r
                 if s[0].startswith("terminal:")]
    assert "terminal:timeout" in terminals
    assert ("terminal:poisoned" in terminals) == (kind == "dense")


def test_export_trace_merges_host_spans(setup, tmp_path):
    """One chrome-trace JSON from one served batch: request rows, tick
    markers on the server row, and the profiler's ``RecordEvent`` host
    spans of the same dispatches, on one clock."""
    eng = setup["paged"][1]
    eng.reset()
    srv = Server(eng, observability=ObservabilityConfig(
        trace_requests=True))
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    prof._drain_events()
    with prof:
        for p, kw in _requests(6, n=3):
            srv.submit(p, **kw)
        srv.run_until_idle()
    path = srv.export_trace(str(tmp_path / "nested" / "trace.json"),
                            profiler=prof)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rows = {e["tid"] for e in events if e.get("ph") == "M"
            and str(e["args"].get("name", "")).startswith("request ")}
    assert len(rows) == 3
    names = [e.get("name") for e in events]
    for n in ("queue_wait", "prefill_chunk", "decode", "tick",
              "serving.decode_block", "serving.prefill_chunk",
              "terminal:completed"):
        assert n in names, n
    assert names.count("terminal:completed") == 3
    ts = [e["ts"] for e in events if e.get("ph") == "X"]
    assert max(ts) - min(ts) < 600e6


# ---------------------------------------------------------------------------
# native host tracer, profiler
# ---------------------------------------------------------------------------

def _tracer_dump(t, path):
    t.clear()
    t.enable(True)
    t.begin("outer")
    t.begin("inner")
    time.sleep(0.002)
    t.end()
    t.end()
    t.instant("marker")
    t.counter("queue_depth", 7)
    t.enable(False)
    n = t.event_count()
    t.dump(path, pid=123)
    t.clear()
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    return n, sorted((e["ph"], e["name"], tuple(sorted(e)),
                      e.get("args")) for e in ev)


@pytest.mark.parametrize("native", [True, False], ids=["gxx", "python"])
def test_native_tracer_dumps_jax_structure(native, monkeypatch, tmp_path):
    """Built with ``g++`` into ``_build/`` at first use (where g++
    exists), or on the Python path: the same event structure as JAX's
    tracer for the same calls."""
    if native:
        if core.load_host_tracer() is None:
            pytest.skip("no g++ on this machine: the Python path only")
        assert core.lib_path("host_tracer").exists()
    else:
        monkeypatch.setattr("paddle_tpu_torch.core.native_api."
                            "load_host_tracer", lambda: None)
        monkeypatch.setattr("paddle_tpu.core.native_api.load_native",
                            lambda: None)
    t = NativeTracer()
    assert t.is_native is native
    got = _tracer_dump(t, str(tmp_path / "port.json"))
    want = _tracer_dump(JaxTracer(), str(tmp_path / "jax.json"))
    assert got == want and got[0] == (4 if native else 6)
    t.begin("x")                       # disabled: a no-op
    t.end()
    assert t.event_count() == 0


def test_profiler_gates_its_host_ring(tmp_path, capsys):
    """A CLOSED scheduler step records no host span, a RECORD step does
    (natively when the tracer builds); export creates its directory;
    summary aggregates and prints only when asked — as JAX's does."""
    sched = profiler.make_scheduler(closed=1, ready=0, record=1)
    jsched = jprofiler.make_scheduler(closed=1, ready=0, record=1)
    assert [sched(i) for i in range(5)] == \
        [profiler.ProfilerState[jsched(i).name] for i in range(5)]
    p = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU],
                          scheduler=sched)
    p._drain_events()
    p.start()
    with profiler.RecordEvent("closed_step"):
        pass
    p.step()
    with profiler.RecordEvent("recorded_step"):
        time.sleep(0.001)
    table, agg = p.summary(print_table=False)
    p.stop()
    assert set(agg) == {"recorded_step"} and agg["recorded_step"]["calls"]
    assert capsys.readouterr().out == ""
    with profiler.Profiler(targets=[profiler.ProfilerTarget.CPU]) as q:
        with profiler.RecordEvent("exported"):
            pass
    q.export(str(tmp_path / "deep" / "dir" / "t.json"))
    with open(tmp_path / "deep" / "dir" / "t.json") as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == \
            ["exported"]


def test_profiler_device_trace(tmp_path):
    """A device target records the ``torch.profiler`` trace beside the
    host spans and writes it when the profiler stops (on the CPU the
    trace holds the host activity)."""
    import torch
    with profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                    profiler.ProfilerTarget.GPU]) as p:
        torch.ones(8).sum()
    path = os.path.join(p.device_trace_dir, "device_trace.json")
    with open(path) as f:
        assert "traceEvents" in json.load(f)
