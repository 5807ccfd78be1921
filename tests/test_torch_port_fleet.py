"""The port's disaggregated serving fleet (``paddle_tpu_torch.serving
.fleet`` and ``prefix_cache``) against the JAX package's unified
``Server`` on the same weights (the tiny Llama, moved through numpy).

A request prefilled on a port prefill worker and decoded on a port
decode worker streams token-identical to the JAX unified ``Server``:
paged greedy with staggered arrivals, seeded sampled, dense, and the
int8 arena; after a remote prefix fetch; after a decode worker dies
mid-decode (the streams redrive from the fleet's records, the rng key
host-replayed) and after a prefill worker dies; under chaos on the
handoff fault sites; across a live migration and scale actions. Across
packages: a JAX prefill engine's encoded handoff adopts onto a port
decode worker and the greedy stream continues token-identical to the
JAX unified ``Server``, and the other way round. ``_replay_key`` is
bit-equal to ``jax.random.split`` applied n times. The JAX engines of
this file compile with the persistent compile cache off (two identical
paged programs compiled in one process are the jaxlib heap hazard the
JAX fleet tests guard against the same way)."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import DecodeWorker as JaxDecodeWorker
from paddle_tpu.serving import FleetRouter as JaxRouter
from paddle_tpu.serving import PrefillPagedEngine as JaxPrefillPaged
from paddle_tpu.serving import PrefillWorker as JaxPrefillWorker
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving import handoff as jhandoff

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      DecodeWorker, Fleet, FleetRouter,
                                      PagedEngine, PrefillDenseEngine,
                                      PrefillPagedEngine, PrefillWorker,
                                      Request, RequestFailure, ResumeState,
                                      Server, SocketTransport,
                                      decode_handoff, encode_handoff)
from paddle_tpu_torch.serving.fleet import _replay_key
from paddle_tpu_torch.utils import faults as tfaults

PAGED = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
             prefill_chunk=8)
DENSE = dict(num_slots=2, max_len=64, decode_block=4,
             prompt_buckets=(8, 16, 32))
VOCAB = 512


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages; the JAX unified references
    (paged, dense, paged int8) and a JAX prefill engine; the port's
    2-prefill/2-decode paged set and dense and int8 pairs, all over ONE
    port model (the fleet shares its weights)."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    cpu = dict(device="cpu")
    port = {
        "pf": [PrefillPagedEngine(tm, **PAGED, **cpu) for _ in range(2)],
        "dc": [PagedEngine(tm, **PAGED, **cpu) for _ in range(2)],
        "dense": (PrefillDenseEngine(tm, **DENSE, **cpu),
                  ContinuousBatchingEngine(tm, **DENSE, **cpu)),
        "int8": (PrefillPagedEngine(tm, kv_int8=True, **PAGED, **cpu),
                 PagedEngine(tm, kv_int8=True, **PAGED, **cpu)),
    }
    ref = {"paged": JaxEngine(jm, paged=True, **PAGED),
           "dense": JaxEngine(jm, **DENSE),
           "int8": JaxEngine(jm, paged=True, kv_int8=True, **PAGED),
           "prefill": JaxPrefillPaged(jm, **PAGED)}
    yield tm, port, ref, named
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(autouse=True)
def _disarmed():
    tfaults.clear()
    yield
    tfaults.clear()


def _requests(seed, n=6, max_new=(4, 10), sampled=(2,), arrivals=True,
              lens=(4, 30)):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        kw = dict(max_new_tokens=int(rs.randint(*max_new)))
        if i in sampled:
            kw.update(temperature=0.8, top_k=20, seed=5 + i)
        if arrivals:
            kw["arrival_step"] = i
        out.append((rs.randint(0, VOCAB, (int(rs.randint(*lens)),))
                    .astype(np.int32), kw))
    return out


def _jax_ref(engine, reqs):
    """The JAX unified Server's rows, in submission order."""
    engine.reset()
    srv = JaxServer(engine)
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    return [np.asarray(res[r]).tolist() for r in rids]


def _fleet(pf, dc, **kw):
    for e in list(pf) + list(dc):
        e.reset()
    return Fleet([PrefillWorker(e) for e in pf],
                 [DecodeWorker(e) for e in dc], **kw)


def _serve(fleet, reqs, max_ticks=500, **submit_kw):
    rids = [fleet.submit(p, **kw, **submit_kw) for p, kw in reqs]
    res = fleet.run_until_idle(max_ticks=max_ticks)
    return rids, [np.asarray(res[r]).tolist()
                  if not isinstance(res[r], RequestFailure) else res[r]
                  for r in rids]


def _check_clean(fleet):
    """Zero-leak teardown on every LIVE worker: empty slots, outboxes
    and queues, exact arena accounting."""
    assert not fleet.busy()
    for w in fleet.prefill + fleet.decode:
        if not fleet._alive(w.name):
            continue
        assert all(s is None for s in w.engine._slots)
        assert not getattr(w.engine, "_outbox", None)
        if hasattr(w.engine, "manager"):
            assert not w.engine.manager._ref
            w.engine.manager.assert_consistent()


class TestStreamsEqualJax:
    def test_paged_greedy_staggered(self, setup):
        _, port, ref, _ = setup
        reqs = _requests(0, sampled=())
        fleet = _fleet(port["pf"], port["dc"])
        rids, got = _serve(fleet, reqs)
        assert got == _jax_ref(ref["paged"], reqs)
        st = fleet.stats()
        assert st["handoffs"] == len(reqs)
        assert len(set(rids)) == len(rids) == len(fleet.results)
        assert {r // 1_000_000 for r in rids} <= {1, 2}
        assert all(v > 0 for v in st["handoff_ms_mean"].values())
        _check_clean(fleet)

    def test_paged_seeded_sampled(self, setup):
        _, port, ref, _ = setup
        reqs = _requests(1, sampled=(0, 2, 3, 5))
        fleet = _fleet(port["pf"], port["dc"])
        _, got = _serve(fleet, reqs)
        assert got == _jax_ref(ref["paged"], reqs)
        _check_clean(fleet)

    def test_dense_greedy_and_sampled(self, setup):
        _, port, ref, _ = setup
        reqs = _requests(2, lens=(4, 28))
        fleet = _fleet(*([e] for e in port["dense"]))
        _, got = _serve(fleet, reqs)
        assert got == _jax_ref(ref["dense"], reqs)
        assert fleet.stats()["handoffs"] == len(reqs)
        _check_clean(fleet)

    def test_paged_kv_int8(self, setup):
        _, port, ref, _ = setup
        reqs = _requests(3)
        fleet = _fleet(*([e] for e in port["int8"]))
        _, got = _serve(fleet, reqs)
        assert got == _jax_ref(ref["int8"], reqs)
        _check_clean(fleet)

    def test_finished_at_prefill_never_ships(self, setup):
        _, port, ref, _ = setup
        reqs = [(p, dict(max_new_tokens=1)) for p, _ in _requests(4, n=3)]
        fleet = _fleet(port["pf"], port["dc"])
        _, got = _serve(fleet, reqs)
        assert got == _jax_ref(ref["paged"], reqs)
        assert fleet.stats()["handoffs"] == 0
        _check_clean(fleet)


class TestPrograms:
    def test_prefill_engines_have_no_decode_program(self, setup):
        """A prefill-only engine is built without a decode program (on
        the card: no decode graph captured, no pool held); calling one
        raises instead of running a block eagerly. On the CPU every
        capture count is 0."""
        _, port, _, _ = setup
        from paddle_tpu_torch.graphs import CapturedProgram
        for e in port["pf"] + [port["dense"][0], port["int8"][0]]:
            assert e.decode_compile_count() == 0
            with pytest.raises(RuntimeError, match="prefill-only"):
                e.backend.decode_program()
        for e in port["pf"] + [port["int8"][0]]:
            assert isinstance(e.backend.prefill_program, CapturedProgram)
        for e in port["dc"]:
            assert isinstance(e.backend.decode_program, CapturedProgram)
            assert e.decode_compile_count() == e.prefill_compile_count() \
                == 0

    def test_pool_specs_and_leaf_order_equal_jax(self, setup):
        """``backend.pool_specs``: the JAX backends' leaf order, shapes
        and dtype names (fp32 and int8 arenas, and the dense pool)."""
        _, port, ref, _ = setup
        for te, je in ((port["dc"][0], ref["paged"]),
                       (port["int8"][1], ref["int8"]),
                       (port["dense"][1], ref["dense"])):
            want = [(tuple(s), str(np.dtype(d)))
                    for s, d in je.backend.pool_specs]
            assert list(te.backend.pool_specs) == want


class TestRouter:
    def test_affinity_keys_and_routes_equal_jax(self):
        rs = np.random.RandomState(5)
        a, b = FleetRouter(block_size=8), JaxRouter(block_size=8)
        for L in (3, 8, 9, 17, 40):
            p = rs.randint(0, VOCAB, (L,)).astype(np.int32)
            assert a.affinity_key(p) == b.affinity_key(p)
            for depths in ([0, 0], [3, 0, 1], [9, 0]):
                elig = list(range(len(depths)))
                assert a.route(p, depths, elig) == b.route(p, depths, elig)
        assert (a.affinity_routes, a.spillovers) == \
            (b.affinity_routes, b.spillovers)

    def test_spillover_and_knobs(self, monkeypatch):
        r = FleetRouter(block_size=8, spill_depth=2)
        p = np.arange(20, dtype=np.int32)
        pick = r.route(p, [0, 0], [0, 1])
        other = 1 - pick
        depths = [0, 0]
        depths[pick] = 5
        assert r.route(p, depths, [0, 1]) == other
        assert r.spillovers == 1
        monkeypatch.setenv("PT_SERVING_FLEET_AFFINITY", "0")
        monkeypatch.setenv("PT_SERVING_FLEET_SPILL_DEPTH", "3")
        r = FleetRouter(block_size=8)
        assert r.affinity is False and r.spill_depth == 3
        with pytest.raises(ValueError, match="spill_depth"):
            FleetRouter(block_size=8, spill_depth=0)


def _shared_group(seed, n, sys_len=24, tail=(3, 6)):
    rs = np.random.RandomState(seed)
    sys_p = rs.randint(0, VOCAB, (sys_len,)).astype(np.int32)
    return [np.concatenate([sys_p, rs.randint(
        0, VOCAB, (int(rs.randint(*tail)),)).astype(np.int32)])
        for _ in range(n)]


class TestPrefixCache:
    def test_remote_fetch_equals_jax(self, setup):
        """A shared prefix registered on prefill0 (and its decode
        worker) is FETCHED by prefill1: the greedy and seeded sampled
        streams equal the JAX unified Server's, and the fetched blocks
        are exactly the requester's shareable prefix."""
        _, port, ref, _ = setup
        ps = _shared_group(7, 3)
        warm = [(ps[0], dict(max_new_tokens=1))]
        later = [(ps[1], dict(max_new_tokens=6)),
                 (ps[2], dict(max_new_tokens=6, temperature=0.8,
                              top_k=20, seed=9))]
        fleet = _fleet(port["pf"], port["dc"])
        _, got0 = _serve(fleet, warm, prefill_worker="prefill0")
        _, got = _serve(fleet, later, prefill_worker="prefill1")
        assert got0 + got == _jax_ref(ref["paged"], warm + later)
        st = fleet.stats()
        assert st["prefix_fetches"] >= 1 and not st["prefix_fetch_failures"]
        assert port["pf"][1].fetched_tokens >= 16
        _check_clean(fleet)

    def test_fetch_over_socket_transport_under_wire_faults(self, setup):
        _, port, ref, _ = setup
        ps = _shared_group(8, 3)
        reqs = [(ps[0], dict(max_new_tokens=1))] + \
            [(p, dict(max_new_tokens=5)) for p in ps[1:]]
        t = SocketTransport("fleet", retry_backoff_s=0.001)
        try:
            fleet = _fleet(port["pf"], port["dc"], transport=t)
            with tfaults.injected("transport.corrupt:p=0.2;"
                                  "transport.disconnect:p=0.2", seed=3):
                _, got0 = _serve(fleet, reqs[:1],
                                 prefill_worker="prefill0")
                _, got = _serve(fleet, reqs[1:], prefill_worker="prefill1")
            assert fleet.prefix_fetches >= 1
            assert t.stats()["resends"] >= 1
        finally:
            t.close()
        assert got0 + got == _jax_ref(ref["paged"], reqs)
        _check_clean(fleet)

    def test_watermark_eviction_retracts_directory(self, setup):
        _, port, ref, _ = setup
        reqs = [(p, dict(max_new_tokens=4)) for p in
                [_shared_group(s, 1, sys_len=24)[0] for s in (31, 32, 33,
                                                              34)]]
        fleet = _fleet([port["pf"][0]], [port["dc"][0]], evict_high=0.35,
                       evict_low=0.15)
        _, got = _serve(fleet, reqs, max_ticks=400)
        assert got == _jax_ref(ref["paged"], reqs)
        assert fleet.prefix_evictions > 0
        fleet.tick()          # publish the post-eviction truth
        mgrs = [port["pf"][0].manager, port["dc"][0].manager]
        pressure = 1.0 - (sum(len(m._free) for m in mgrs)
                          / sum(m.usable_blocks() for m in mgrs))
        assert pressure <= 0.35 + 1e-9
        held = set().union(*(set(m.registered_chains()) for m in mgrs))
        assert fleet.directory.size() == len(held)
        _check_clean(fleet)

    def test_dead_owner_falls_back_to_local_prefill(self, setup):
        _, port, ref, _ = setup
        ps = _shared_group(9, 2)
        reqs = [(ps[0], dict(max_new_tokens=1)),
                (ps[1], dict(max_new_tokens=5))]
        fleet = _fleet(port["pf"], port["dc"], lease_misses=50)
        _, got0 = _serve(fleet, reqs[:1], prefill_worker="prefill0")
        fleet.kill_prefill_worker(0)          # killed, not yet detected
        for d in fleet.decode:                # and its decode copies
            fleet.directory.drop_worker(d.name)
        rid = fleet.submit(reqs[1][0], prefill_worker="prefill1",
                           **reqs[1][1])
        for _ in range(60):
            fleet.tick()
            if rid in fleet.results:
                break
        assert [got0[0], np.asarray(fleet.results[rid]).tolist()] == \
            _jax_ref(ref["paged"], reqs)
        assert fleet.prefix_fetch_failures.get("transport", 0) >= 1


class TestFailureDomains:
    def _kill_run(self, fleet, reqs, victim=1):
        rids = [fleet.submit(p, **kw) for p, kw in reqs]
        for _ in range(40):
            fleet.tick()
            if fleet.decode[victim].engine.has_live():
                break
        assert fleet.decode[victim].engine.has_live()
        fleet.kill_decode_worker(victim)
        res = fleet.run_until_idle(max_ticks=600)
        return [np.asarray(res[r]).tolist() for r in rids]

    def test_decode_worker_killed_mid_decode_redriven(self, setup):
        """Greedy and seeded sampled streams a dead decode worker owned
        are rebuilt from the fleet's records and finish identical to the
        JAX unified Server, under wire faults on a localhost socket."""
        _, port, ref, _ = setup
        reqs = _requests(11, n=6, max_new=(20, 26), sampled=(1, 4),
                         arrivals=False, lens=(4, 24))
        t = SocketTransport("fleet", retry_backoff_s=0.001)
        try:
            fleet = _fleet(port["pf"], port["dc"], transport=t,
                           lease_misses=2)
            with tfaults.injected("transport.corrupt:p=0.05;"
                                  "transport.disconnect:p=0.05", seed=1):
                got = self._kill_run(fleet, reqs)
        finally:
            t.close()
        assert got == _jax_ref(ref["paged"], reqs)
        st = fleet.stats()
        assert st["workers_lost"] == 1 and st["redrives"] >= 1
        assert st["worker_states"]["decode1"] == "dead"
        _check_clean(fleet)

    def test_dense_kill_redriven(self, setup):
        _, port, ref, _ = setup
        pf, dc = port["dense"]
        reqs = _requests(12, n=4, max_new=(20, 26), sampled=(2,),
                         arrivals=False, lens=(4, 24))
        spare = ContinuousBatchingEngine(dc.backend.model, device="cpu",
                                         **DENSE)
        fleet = _fleet([pf], [dc, spare], lease_misses=2)
        got = self._kill_run(fleet, reqs, victim=0)
        assert got == _jax_ref(ref["dense"], reqs)
        assert fleet.redrives >= 1

    def test_prefill_worker_killed_requests_resubmitted(self, setup):
        _, port, ref, _ = setup
        reqs = _requests(13, n=5, arrivals=False)
        fleet = _fleet(port["pf"], port["dc"], lease_misses=2)
        rids = [fleet.submit(p, **kw) for p, kw in reqs]
        fleet.kill_prefill_worker(0)
        res = fleet.run_until_idle(max_ticks=600)
        assert [np.asarray(res[r]).tolist() for r in rids] == \
            _jax_ref(ref["paged"], reqs)
        assert fleet.workers_lost == 1
        _check_clean(fleet)

    def test_chaos_on_handoff_sites(self, setup):
        """Seeded faults on serialize, transport and adopt: every request
        ends in a result equal to JAX's or an explicit failure, and no
        block leaks."""
        _, port, ref, _ = setup
        reqs = _requests(14, n=8, sampled=(3,))
        fleet = _fleet(port["pf"], port["dc"])
        with tfaults.injected("fleet.serialize:p=0.2;fleet.transport:"
                              "p=0.2;fleet.adopt:p=0.2", seed=4):
            _, got = _serve(fleet, reqs)
        want = _jax_ref(ref["paged"], reqs)
        for g, w in zip(got, want):
            assert g == w or (isinstance(g, RequestFailure)
                              and g.reason in ("handoff",
                                               "circuit_open"))
        assert fleet.stats()["handoff_retries"] >= 1
        _check_clean(fleet)

    def test_duplicate_and_tampered_adopts(self, setup):
        tm, port, _, _ = setup
        pf, dc = port["pf"][0], port["dc"][0]
        pf.reset()
        dc.reset()
        assert pf.try_admit(Request(request_id=3, prompt=np.arange(
            1, 12, dtype=np.int32), max_new_tokens=6))
        while not pf._outbox:
            pf.prefill_tick(None)
        ph, = pf.take_handoffs()
        h = pf.extract_handoff(ph)
        h.meta["seq"] = 1
        h.meta["crc32"] = h.payload_crc32()
        data = encode_handoff(h)
        d = DecodeWorker(dc)
        bad = decode_handoff(data)
        bad.arrays["kv_0"] = bad.arrays["kv_0"] + np.float32(1)
        free0 = len(dc.manager._free)
        with pytest.raises(ValueError, match="CRC"):
            d.adopt(bad)
        assert len(dc.manager._free) == free0
        assert d.adopt(decode_handoff(data)) == d.ADOPTED
        ref_count = dict(dc.manager._ref)
        assert d.adopt(decode_handoff(data)) == d.DUPLICATE
        assert dc.manager._ref == ref_count
        d.kill()
        from paddle_tpu_torch.serving import TransportError
        with pytest.raises(TransportError, match="dead"):
            d.adopt(decode_handoff(data))
        pf.release_handoff(ph)


class TestMigrationAndScale:
    def test_migrate_decode_worker_mid_stream(self, setup, tmp_path):
        tm, port, ref, _ = setup
        reqs = _requests(15, n=4, max_new=(14, 20), sampled=(1,),
                         arrivals=False)
        fleet = _fleet(port["pf"], port["dc"])
        rids = [fleet.submit(p, **kw) for p, kw in reqs]
        for _ in range(40):
            fleet.tick()
            if fleet.decode[0].engine.has_live():
                break
        fresh = PagedEngine(tm, device="cpu", **PAGED)
        fleet.migrate_decode_worker(0, fresh, str(tmp_path / "d0.npz"))
        assert fleet.decode[0].engine is fresh
        res = fleet.run_until_idle(max_ticks=500)
        assert [np.asarray(res[r]).tolist() for r in rids] == \
            _jax_ref(ref["paged"], reqs)
        assert fleet.migrations == 1
        _check_clean(fleet)

    def test_prefill_snapshot_carries_the_outbox(self, setup, tmp_path):
        """Un-shipped handoffs ride a prefill worker's snapshot: restored
        into a fresh prefill engine they ship and decode to JAX's
        streams."""
        tm, port, ref, _ = setup
        reqs = _requests(17, n=2, sampled=(1,), arrivals=False)
        pf = port["pf"][0]
        pf.reset()
        w = PrefillWorker(pf)
        for p, kw in reqs:
            w.server.submit(p, **kw)
        while len(pf._outbox) < 2:
            w.tick()
        path = str(tmp_path / "p0.npz")
        w.server.snapshot(path)
        fresh = PrefillPagedEngine(tm, device="cpu", **PAGED)
        srv = Server.restore(path, fresh)
        assert len(fresh._outbox) == 2
        port["dc"][0].reset()
        fleet = Fleet([PrefillWorker(fresh, server=srv)],
                      [DecodeWorker(port["dc"][0])])
        res = fleet.run_until_idle(max_ticks=200)
        assert [np.asarray(res[r]).tolist() for r in (0, 1)] == \
            _jax_ref(ref["paged"], reqs)
        assert fleet.handoffs == 2
        _check_clean(fleet)

    def test_add_drain_remove(self, setup):
        tm, port, ref, _ = setup
        reqs = _requests(16, n=6, sampled=())
        fleet = _fleet([port["pf"][0]], [port["dc"][0]])
        rids = [fleet.submit(p, **kw) for p, kw in reqs[:3]]
        fleet.tick()
        port["dc"][1].reset()
        fleet.add_decode_worker(DecodeWorker(port["dc"][1]))
        fleet.drain_decode_worker(0)
        fleet.drain_decode_worker(0)             # idempotent
        rids += [fleet.submit(p, **kw) for p, kw in reqs[3:]]
        res = fleet.run_until_idle(max_ticks=500)
        assert [np.asarray(res[r]).tolist() for r in rids] == \
            _jax_ref(ref["paged"], reqs)
        with pytest.raises(ValueError, match="last"):
            fleet.drain_decode_worker(1)
        removed = fleet.remove_decode_worker(0)
        assert removed.name == "decode0"
        assert set(rids) <= set(fleet.results)   # results survive removal
        with pytest.raises(ValueError, match="last"):
            fleet.remove_decode_worker(0)
        _check_clean(fleet)


class TestCompatAndRefusals:
    def test_mixed_fleet_and_geometry_refused(self, setup):
        _, port, _, _ = setup
        with pytest.raises(ValueError, match="dense/paged"):
            _fleet([port["pf"][0]], [port["dense"][1]])
        with pytest.raises(ValueError, match="layout mismatch"):
            _fleet([port["pf"][0]], [port["int8"][1]])
        fleet = _fleet([port["pf"][0]], [port["dc"][0]])
        with pytest.raises(ValueError, match="dense/paged"):
            fleet.add_decode_worker(DecodeWorker(port["dense"][1]))
        with pytest.raises(ValueError, match="already in the fleet"):
            fleet.add_decode_worker(DecodeWorker(port["dc"][1],
                                                 name="decode0"))

    def test_worker_role_and_knob_refusals(self, setup):
        _, port, _, _ = setup
        with pytest.raises(ValueError, match="prefill-only"):
            PrefillWorker(port["dc"][0])
        with pytest.raises(ValueError, match="decoding engine"):
            DecodeWorker(port["pf"][0])
        with pytest.raises(ValueError, match="lease_misses"):
            _fleet([port["pf"][0]], [port["dc"][0]], lease_misses=0)
        with pytest.raises(ValueError, match="watermark"):
            _fleet([port["pf"][0]], [port["dc"][0]], evict_high=0.2,
                   evict_low=0.5)
        with pytest.raises(ValueError, match="duplicate worker names"):
            Fleet([PrefillWorker(port["pf"][0], name="x")],
                  [DecodeWorker(port["dc"][0], name="x")])

    def test_impossible_request_refused_at_the_door(self, setup):
        _, port, _, _ = setup
        fleet = _fleet(port["pf"], port["dc"])
        with pytest.raises(ValueError, match="no decode worker"):
            fleet.submit(np.ones((4,), np.int32), max_new_tokens=1000)
        with pytest.raises(ValueError, match="not routable"):
            fleet.submit(np.ones((4,), np.int32), prefill_worker="nope")
        _check_clean(fleet)

    def test_user_resume_refused_on_prefill_workers(self, setup):
        _, port, _, _ = setup
        req = Request(request_id=1, prompt=np.ones((5,), np.int32),
                      max_new_tokens=8,
                      resume=ResumeState(tokens=[1, 2],
                                         key=np.zeros(2, np.uint32)))
        for e in (port["pf"][0], port["dense"][0]):
            e.reset()
            with pytest.raises(NotImplementedError, match="resume"):
                e.try_admit(req)

    def test_durability_refused_naming_the_item(self, setup, tmp_path):
        """The durable control plane is ported: what it still refuses is
        a checkpoint without ``durability=`` (naming the keyword) and a
        recovery from a directory holding nothing to recover."""
        _, port, _, _ = setup
        fleet = _fleet([port["pf"][0]], [port["dc"][0]])
        assert fleet.stats()["durability"] is None
        with pytest.raises(RuntimeError, match="durability="):
            fleet.checkpoint()
        with pytest.raises(FileNotFoundError, match="nothing to recover"):
            Fleet.recover(str(tmp_path / "none"), engine_factory=None)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_replay_key_bit_equal_to_jax_split(seed):
    k = jax.random.PRNGKey(seed)
    key0 = np.asarray(k, np.uint32)
    for n in range(65):
        np.testing.assert_array_equal(_replay_key(key0, n),
                                      np.asarray(k, np.uint32))
        k = jax.random.split(k)[0]


class TestCrossFramework:
    def test_jax_prefill_port_decode(self, setup):
        """A JAX prefill engine extracts and encodes the handoff; a port
        decode worker adopts the bytes; the greedy stream continues
        token-identical to the JAX unified Server."""
        _, port, ref, _ = setup
        reqs = _requests(20, n=2, max_new=(8, 12), sampled=(1,),
                         arrivals=False)
        jpf = ref["prefill"]
        jpf.reset()
        jw = JaxPrefillWorker(jpf)
        jrids = [jw.server.submit(p, **kw) for p, kw in reqs]
        port["dc"][0].reset()
        d = DecodeWorker(port["dc"][0])
        for seq in range(1, 40):
            jw.tick()
            for ph in jpf.take_handoffs():
                h = jpf.extract_handoff(ph, source="jax")
                h.meta["seq"] = seq
                h.meta["crc32"] = h.payload_crc32()
                data = jhandoff.encode_handoff(h)
                jpf.release_handoff(ph)
                assert d.adopt(decode_handoff(data)) == d.ADOPTED
            d.tick()
            if not jw.busy() and not d.busy():
                break
        got = [np.asarray(d.server.results[r]).tolist() for r in jrids]
        assert got == _jax_ref(ref["paged"], reqs)
        assert not port["dc"][0].manager._ref

    def test_port_prefill_jax_decode(self, setup):
        _, port, ref, _ = setup
        reqs = _requests(21, n=2, max_new=(8, 12), sampled=(0,),
                         arrivals=False)
        want = _jax_ref(ref["paged"], reqs)
        pf = port["pf"][0]
        pf.reset()
        w = PrefillWorker(pf)
        rids = [w.server.submit(p, **kw) for p, kw in reqs]
        je = ref["paged"]
        je.reset()
        d = JaxDecodeWorker(je)
        for seq in range(1, 40):
            w.tick()
            for ph in pf.take_handoffs():
                h = pf.extract_handoff(ph, source="port")
                h.meta["seq"] = seq
                h.meta["crc32"] = h.payload_crc32()
                data = encode_handoff(h)
                pf.release_handoff(ph)
                assert d.adopt(jhandoff.decode_handoff(data)) == d.ADOPTED
            d.tick()
            if not w.busy() and not d.busy():
                break
        got = [np.asarray(d.server.results[r]).tolist() for r in rids]
        assert got == want
        assert not pf.manager._ref
