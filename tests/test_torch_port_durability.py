"""The port's durable fleet control plane (``paddle_tpu_torch.serving
.durability`` and the durable paths of ``fleet``) against the JAX
package's, on the tiny Llama whose weights move through numpy.

The write-ahead journal frames, replays and truncates torn tails as
JAX's does, and the same record gives the same bytes in both packages;
manifests commit atomically; an un-shipped outbox rides a snapshot; the
disk spill tier round-trips evicted chains and falls back bit for bit;
a whole fleet killed mid-traffic comes back through ``Fleet.recover``
with every row equal to the uncrashed run (paged greedy and sampled,
int8 arena, dense, journal only, torn tail, scale records), one terminal
per request and no leaked block. Across packages: a durability
directory a JAX fleet wrote recovers in the port, token-identical to
JAX's uncrashed run, and the other way round; a snapshot of either
package restores into the other's engine. The JAX engines of this file
compile with the persistent compile cache off (the module fixture), as
in the port's fleet tests."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import BlockManager as JaxBlockManager
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import DecodeWorker as JaxDecodeWorker
from paddle_tpu.serving import Fleet as JaxFleet
from paddle_tpu.serving import PrefillPagedEngine as JaxPrefillPaged
from paddle_tpu.serving import PrefillWorker as JaxPrefillWorker
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving import WriteAheadJournal as JaxJournal
from paddle_tpu.serving import durability as jdur
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.distributed import checkpoint as _ckpt
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import (BlockManager,
                                      ContinuousBatchingEngine,
                                      DecodeWorker, Fleet, KVHandoff,
                                      PagedEngine, PrefillDenseEngine,
                                      PrefillPagedEngine, PrefillWorker,
                                      PrefixSpillStore, RequestFailure,
                                      Server, WriteAheadJournal,
                                      encode_handoff)
from paddle_tpu_torch.serving import durability as dur
from paddle_tpu_torch.serving.resilience import load_snapshot, save_snapshot
from paddle_tpu_torch.utils import faults

PAGED = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
             prefill_chunk=8)
DENSE = dict(num_slots=2, max_len=64, decode_block=4,
             prompt_buckets=(8, 16, 32))
VOCAB = 512


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages; the port's paged 2-prefill and
    2-decode engines, a dense pair and an int8 pair, all over ONE port
    model; a JAX prefill and decode pair for the cross-package
    directories. ``reset()`` frees slots and blocks and keeps the
    programs, so a crashed fleet's engines stand in for a new
    process's."""
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
    port = {
        "pf": [PrefillPagedEngine(tm, **PAGED, **cpu) for _ in range(2)],
        "dc": [PagedEngine(tm, **PAGED, **cpu) for _ in range(2)],
        "dense": (PrefillDenseEngine(tm, **DENSE, **cpu),
                  ContinuousBatchingEngine(tm, **DENSE, **cpu)),
        "int8": (PrefillPagedEngine(tm, kv_int8=True, **PAGED, **cpu),
                 PagedEngine(tm, kv_int8=True, **PAGED, **cpu)),
    }
    jx = {"pf": JaxPrefillPaged(jm, **PAGED),
          "dc": JaxEngine(jm, paged=True, **PAGED)}
    yield port, jx, {}
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, VOCAB, (L,)).astype(np.int32) for L in lens]


# four greedy requests and two seeded sampled ones; the first two are
# submitted before the checkpoint, the rest after it
_P = _prompts(41, (9, 13, 17, 11, 7, 12))
SUBS = [(_P[0], dict(max_new_tokens=10)), (_P[1], dict(max_new_tokens=12)),
        (_P[2], dict(max_new_tokens=9)), (_P[3], dict(max_new_tokens=11)),
        (_P[4], dict(max_new_tokens=10, temperature=0.9, top_k=40,
                     seed=11)),
        (_P[5], dict(max_new_tokens=8, temperature=1.1, top_p=0.9,
                     seed=3))]


def _reset(*engines):
    for e in engines:
        e.reset()


def _names(pfs, dcs):
    by = {f"prefill{i}": e for i, e in enumerate(pfs)}
    by.update({f"decode{i}": e for i, e in enumerate(dcs)})
    return by


def _factory(by_name):
    """``engine_factory`` for ``Fleet.recover`` over the (reset) fixture
    engines."""
    return lambda role, name: by_name[name]


def _fleet(cls, pw, dw, pfs, dcs, **kw):
    _reset(*pfs, *dcs)
    return cls([pw(e) for e in pfs], [dw(e) for e in dcs], **kw)


def _clean_rows(setup, key, pfs, dcs, subs, jax_side=False):
    """The uncrashed fleet's rows (cached per configuration)."""
    port, jx, cache = setup
    if key not in cache:
        if jax_side:
            f = _fleet(JaxFleet, JaxPrefillWorker, JaxDecodeWorker,
                       pfs, dcs)
        else:
            f = _fleet(Fleet, PrefillWorker, DecodeWorker, pfs, dcs)
        ids = [f.submit(p, **kw) for p, kw in subs]
        res = f.run_until_idle(max_ticks=500)
        cache[key] = [np.asarray(res[r]) for r in ids]
    return cache[key]


def _crash(fleet_cls, pw, dw, pfs, dcs, d, subs, split=2, pre_ticks=4,
           post_ticks=2, checkpoint=True, torn=False):
    """Submit, checkpoint mid-traffic, submit more, crash with streams
    queued, mid-prefill, in transit and decoding. Returns the ids in
    submission order."""
    fleet = _fleet(fleet_cls, pw, dw, pfs, dcs, durability=d)
    ids = [fleet.submit(p, **kw) for p, kw in subs[:split]]
    for _ in range(pre_ticks):
        fleet.tick()
    if checkpoint:
        fleet.checkpoint()
    ids += [fleet.submit(p, **kw) for p, kw in subs[split:]]
    fl = faults if fleet_cls is Fleet else jfaults
    with fl.injected("journal.torn_tail:at=1" if torn else ""):
        for _ in range(post_ticks):
            fleet.tick()
    del fleet
    _reset(*pfs, *dcs)
    return ids


def _check_clean(fleet):
    assert not fleet.busy()
    for w in fleet.prefill + fleet.decode:
        assert all(s is None for s in w.engine._slots)
        if hasattr(w.engine, "manager"):
            assert not w.engine.manager._ref
            w.engine.manager.assert_consistent()
    for w in fleet.prefill:
        assert not w.engine._outbox


def _terminal_owner_count(fleet, rid):
    n = sum(1 for w in fleet.prefill + fleet.decode
            if rid in w.server.results)
    return n + int(rid in fleet._local_results) \
        + int(rid in fleet._failures)


def _assert_recovered(fleet2, ids, want):
    res = fleet2.results
    for rid, ref in zip(ids, want):
        v = res.get(rid)
        assert v is not None and not isinstance(v, RequestFailure), \
            f"rid {rid}: {v}"
        np.testing.assert_array_equal(np.asarray(v), ref)
        assert _terminal_owner_count(fleet2, rid) == 1, rid
    _check_clean(fleet2)


# ---------------------------------------------------------------------------
# the write-ahead journal
# ---------------------------------------------------------------------------

class TestJournal:
    def test_append_replay_roundtrip(self, tmp_path):
        p = str(tmp_path / "j.log")
        j = WriteAheadJournal(p)
        recs = [{"k": "submit", "rid": 7, "prompt": [1, 2, 3]},
                {"k": "progress", "rid": 7, "base": 0, "ext": [4, 5]},
                {"k": "terminal", "rid": 7, "tokens": [1, 2, 3, 4, 5]}]
        for r in recs:
            j.append(r)
        j.close()
        got, torn = WriteAheadJournal.replay(p)
        assert not torn and got == recs

    def test_reopen_continues_seq(self, tmp_path):
        p = str(tmp_path / "j.log")
        j = WriteAheadJournal(p)
        j.append({"k": "a"})
        j.append({"k": "b"})
        j.close()
        j2 = WriteAheadJournal(p)
        assert j2.seq == 2
        j2.append({"k": "c"})
        j2.close()
        got, torn = WriteAheadJournal.replay(p)
        assert not torn and [r["k"] for r in got] == ["a", "b", "c"]

    def test_torn_tail_truncated_with_a_warning(self, tmp_path):
        p = str(tmp_path / "j.log")
        j = WriteAheadJournal(p)
        j.append({"k": "a"})
        j.append({"k": "b"})
        with faults.injected("journal.torn_tail:at=1"):
            with pytest.raises(faults.InjectedFault):
                j.append({"k": "lost"})
        j.close()
        with pytest.warns(RuntimeWarning, match="torn"):
            got, torn = WriteAheadJournal.replay(p)
        assert torn and [r["k"] for r in got] == ["a", "b"]
        got2, torn2 = WriteAheadJournal.replay(p)
        assert not torn2 and [r["k"] for r in got2] == ["a", "b"]
        j3 = WriteAheadJournal(p)
        assert j3.seq == 2
        j3.close()

    def test_crc_flip_truncates_at_the_corrupt_frame(self, tmp_path):
        p = str(tmp_path / "j.log")
        j = WriteAheadJournal(p)
        offsets = []
        for k in ("a", "b", "c"):
            offsets.append(os.path.getsize(p))
            j.append({"k": k})
        j.close()
        with open(p, "r+b") as f:        # flip one payload byte of "b"
            f.seek(offsets[1] + 16 + 2)
            b = f.read(1)
            f.seek(offsets[1] + 16 + 2)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.warns(RuntimeWarning):
            got, torn = WriteAheadJournal.replay(p)
        assert torn and [r["k"] for r in got] == ["a"]

    def test_journal_write_fault_is_retried_by_the_fleet(self, setup,
                                                        tmp_path):
        port, _, _ = setup
        d = str(tmp_path / "d")
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, port["pf"],
                       port["dc"], durability=d)
        p, kw = SUBS[0]
        with faults.injected("journal.write:at=1"):
            rid = fleet.submit(p, **kw)
        res = fleet.run_until_idle(max_ticks=300)
        want = _clean_rows(setup, "paged", port["pf"], port["dc"], SUBS)
        np.testing.assert_array_equal(res[rid], want[0])
        recs, torn = WriteAheadJournal.replay(dur.journal_path(d, 0))
        assert not torn
        assert any(r.get("k") == "submit" and r["rid"] == rid
                   for r in recs)
        assert fleet.stats()["durability"]["journal_appends"] >= 2

    def test_journal_write_fault_past_budget_raises(self, setup, tmp_path):
        """A journal still failing past the retry budget fails the
        operation: the fleet never goes on without its log."""
        port, _, _ = setup
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, port["pf"],
                       port["dc"], durability=str(tmp_path / "d"))
        with faults.injected("journal.write:every=1"):
            with pytest.raises(RuntimeError, match="journal"):
                fleet.submit(SUBS[0][0], **SUBS[0][1])


_RECORDS = [
    {"k": "genesis", "prefill": ["prefill0"], "decode": ["decode0"]},
    {"k": "submit", "rid": 1000000, "prompt": [5, 6, 7], "worker":
     "prefill0", "kw": {"max_new_tokens": 8, "temperature": 0.9,
                        "seed": 11}},
    {"k": "ship", "rid": 1000000, "dst": "decode0", "seq": 1,
     "key0": [4294967295, 0], "base_len": 1, "tokens0": [9],
     "t_admit": 12.5},
    {"k": "terminal", "rid": 3, "failure": {
        "reason": "handoff", "message": "é ✓", "tokens_emitted": 2}},
]


class TestJournalAcrossPackages:
    @pytest.mark.parametrize("i", range(len(_RECORDS)))
    def test_same_record_same_frame(self, tmp_path, i):
        paths = [str(tmp_path / n) for n in ("port.log", "jax.log")]
        for path, cls in zip(paths, (WriteAheadJournal, JaxJournal)):
            j = cls(path)
            j.append({"k": "pad"})
            j.append(_RECORDS[i])
            j.close()
        blobs = [open(p, "rb").read() for p in paths]
        assert blobs[0] == blobs[1]

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_each_package_replays_the_others_segment(self, tmp_path,
                                                     writer):
        p = str(tmp_path / "j.log")
        w_cls, r_cls = (WriteAheadJournal, JaxJournal) \
            if writer == "port" else (JaxJournal, WriteAheadJournal)
        j = w_cls(p)
        for r in _RECORDS:
            j.append(r)
        j.close()
        with open(p, "ab") as f:                 # and a torn tail
            f.write(b"PTJ1\x00\x00")
        with pytest.warns(RuntimeWarning, match="torn"):
            got, torn = r_cls.replay(p)
        assert torn and got == _RECORDS
        j2 = r_cls(p)
        assert j2.seq == len(_RECORDS)
        j2.close()


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

class TestManifests:
    def test_atomic_write_fsyncs_parent_directory(self, tmp_path,
                                                  monkeypatch):
        calls = []
        real = _ckpt._fsync_dir
        monkeypatch.setattr(_ckpt, "_fsync_dir",
                            lambda d: (calls.append(d), real(d)))
        path = dur.write_manifest(str(tmp_path), 3, {"workers": []})
        assert calls == [str(tmp_path)]
        doc = json.load(open(path))
        assert (doc["format"], doc["epoch"]) == ("pt-fleet-manifest", 3)
        assert dur.load_latest_manifest(str(tmp_path)) == (3, doc)

    def test_commit_fault_leaves_no_manifest(self, setup, tmp_path):
        """An armed ``checkpoint.commit`` dies before the rename: no
        manifest of the new epoch, the journal keeps its records, and the
        fleet recovers from them."""
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        d = str(tmp_path / "d")
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, pf, dc,
                       durability=d)
        rid = fleet.submit(SUBS[0][0], **SUBS[0][1])
        fleet.tick()
        with faults.injected("checkpoint.commit:at=1"):
            with pytest.raises(faults.InjectedFault):
                fleet.checkpoint()
        assert dur.list_epochs(d, "manifest") == []
        assert fleet._dur_epoch == 0
        del fleet
        _reset(*pf, *dc)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        res = fleet2.run_until_idle(max_ticks=300)
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        np.testing.assert_array_equal(res[rid], want[0])

    def test_torn_manifest_falls_back_with_a_warning(self, tmp_path):
        d = str(tmp_path)
        dur.write_manifest(d, 1, {"workers": []})
        with open(dur.manifest_path(d, 2), "w") as f:
            f.write('{"format": "pt-fleet-man')
        with pytest.warns(RuntimeWarning, match="manifest-00000002"):
            epoch, doc = dur.load_latest_manifest(d)
        assert epoch == 1 and doc["epoch"] == 1

    def test_recover_of_an_empty_directory_refuses(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="nothing to recover"):
            Fleet.recover(str(tmp_path), engine_factory=None)


# ---------------------------------------------------------------------------
# an un-shipped outbox rides the snapshot
# ---------------------------------------------------------------------------

def test_unshipped_outbox_roundtrips_bit_identical(setup, tmp_path):
    port, _, _ = setup
    pf, dc = port["pf"], port["dc"]
    _reset(pf[0], dc[0])
    w = PrefillWorker(pf[0], name="prefill0")
    p, kw = SUBS[4]                             # the sampled one
    rid = w.server.submit(p, **kw)
    for _ in range(30):
        w.tick()
        if w.engine._outbox:
            break
    assert w.engine._outbox
    ph0 = w.engine._outbox[0]
    tok0, key0, prompt0 = ph0.tok0, np.array(ph0.key), np.array(ph0.prompt)
    path = str(tmp_path / "pf.npz")
    w.server.snapshot(path)
    _reset(pf[0])
    srv = Server.restore(path, pf[0])
    (ph1,) = pf[0]._outbox
    assert ph1.tok0 == tok0
    np.testing.assert_array_equal(ph1.key, key0)
    np.testing.assert_array_equal(ph1.prompt, prompt0)
    pf[0].manager.assert_consistent()
    fleet = Fleet([PrefillWorker(pf[0], name="prefill0", server=srv)],
                  [DecodeWorker(dc[0])])
    fleet._requests[rid] = {"prompt": np.asarray(p, np.int32),
                            "worker": "prefill0", "t_submit": 0.0,
                            "kw": dict(kw)}
    res = fleet.run_until_idle(max_ticks=300)
    want = _clean_rows(setup, "paged", pf, dc, SUBS)
    np.testing.assert_array_equal(res[rid], want[4])
    _check_clean(fleet)


# ---------------------------------------------------------------------------
# the disk spill tier
# ---------------------------------------------------------------------------

class TestSpillTier:
    def _warm(self, fleet, i=2):
        p, kw = SUBS[i]
        rid = fleet.submit(p, **kw)
        return rid, fleet.run_until_idle(max_ticks=300)[rid]

    def test_extract_chain_store_roundtrip(self, setup, tmp_path):
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, pf[:1], dc[:1])
        self._warm(fleet)
        m = pf[0].manager
        chains = m.registered_chains()
        depth = max(chains.values())
        digest = next(d for d, k in chains.items() if k == depth)
        hits, lru = dict(m._hits), list(m._cached)
        toks = m.chain_tokens_map()[digest]
        h = dur.extract_chain(pf[0], toks, depth, source="prefill0")
        assert h is not None and h.meta["source"]["spilled"]
        assert dict(m._hits) == hits and list(m._cached) == lru
        store = PrefixSpillStore(str(tmp_path / "spill"))
        assert store.put(digest, h)
        probe = np.asarray(list(toks) + [0], np.int32)
        assert store.lookup(probe, pf[0].kv_block_size, m.hash_fn) \
            == (depth, digest)
        h2 = store.read(digest)
        h2.verify_crc()
        np.testing.assert_array_equal(h2.arrays["tokens"],
                                      h.arrays["tokens"])
        for k in h.arrays:
            np.testing.assert_array_equal(h2.arrays[k], h.arrays[k])
        sliced = dur.slice_prefix_payload(h2, 1)
        assert sliced.meta["skip"] == 1 and "crc32" not in sliced.meta
        for k, a in sliced.arrays.items():
            if k != "tokens":
                assert a.shape[0] == depth - 1
        # the JAX package's store reads the port's spill file
        jh = jdur.PrefixSpillStore(str(tmp_path / "spill")).read(digest)
        jh.verify_crc()
        np.testing.assert_array_equal(jh.arrays["kv_0"], h.arrays["kv_0"])

    def test_watermark_eviction_spills_then_spill_hit(self, setup,
                                                      tmp_path):
        """Chains the watermark evicts land in the spill tier; after a
        whole restart (cold arenas, empty directory) the same prompt is
        served from disk: a spill hit, the same row."""
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        d = str(tmp_path / "d")
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, pf[:1], dc[:1],
                       durability=d, evict_high=0.02, evict_low=0.01)
        _, row = self._warm(fleet)
        np.testing.assert_array_equal(row, want[2])
        fleet.tick()                    # an idle tick runs the eviction
        assert fleet._spill.stats()["writes"] >= 1
        assert fleet.prefix_evictions >= 1
        del fleet
        fleet2 = _fleet(Fleet, PrefillWorker, DecodeWorker, pf[:1],
                        dc[:1], durability=d)
        _, row = self._warm(fleet2)
        np.testing.assert_array_equal(row, want[2])
        st = fleet2.stats()["durability"]["spill"]
        assert st["hits"] >= 1, st
        assert fleet2.prefix_fetches >= 1
        _check_clean(fleet2)

    def test_spill_read_fault_falls_back_bit_identical(self, setup,
                                                       tmp_path):
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        d = str(tmp_path / "d")
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, pf[:1], dc[:1],
                       durability=d, evict_high=0.02, evict_low=0.01)
        self._warm(fleet)
        fleet.tick()
        assert fleet._spill.stats()["writes"] >= 1
        del fleet
        fleet2 = _fleet(Fleet, PrefillWorker, DecodeWorker, pf[:1],
                        dc[:1], durability=d)
        with faults.injected("spill.read:every=1"):
            _, row = self._warm(fleet2)
        np.testing.assert_array_equal(row, want[2])
        st = fleet2.stats()["durability"]["spill"]
        assert st["hits"] == 0 and st["misses"] >= 1, st
        assert fleet2.prefix_fetch_failures.get("spill", 0) >= 1
        _check_clean(fleet2)

    def test_lru_byte_cap_evicts_oldest(self, tmp_path):
        def mk():
            rs = np.random.RandomState(0)
            return KVHandoff(
                meta={"format": dur.FETCH_FORMAT, "kind": "prefix",
                      "n_blocks": 1, "skip": 0, "block_size": 8,
                      "kv_int8": False, "leaf_specs": [],
                      "src_tp_degree": 1},
                arrays={"tokens": rs.randint(0, 100, (8,))
                        .astype(np.int32)})
        one = len(encode_handoff(mk()))
        store = PrefixSpillStore(str(tmp_path / "s"),
                                 max_bytes=one + one // 2)
        for i in range(3):
            assert store.put(bytes([i]) * 20, mk())
        assert len(store) == 1
        assert store.stats()["evictions"] == 2
        tiny = PrefixSpillStore(str(tmp_path / "t"), max_bytes=1)
        assert not tiny.put(b"x" * 20, mk())
        assert len(tiny) == 0
        with pytest.raises(ValueError, match="not in spill index"):
            store.read(b"\x07" * 20)

    def test_previews_leave_hits_and_lru_untouched(self):
        """``eviction_victims`` and ``chain_tokens_map`` equal the JAX
        manager's after the same operations, move no hit count and no
        LRU position, and the victims are what ``evict_cached`` then
        evicts."""
        rs = np.random.RandomState(3)
        shared = rs.randint(0, VOCAB, (16,)).astype(np.int32)
        mgrs = [BlockManager(12, 4), JaxBlockManager(12, 4)]
        for m in mgrs:
            held = []
            for i in range(4):
                p = np.concatenate([shared[:4 * (i % 3 + 1)],
                                    np.full(5, i, np.int32)])
                got = m.match_prefix(p)
                new = m.allocate(-(-len(p) // 4) - len(got))
                m.register_prefix(p, got + new)
                held.append(got + new)
            for b in held:
                m.release(b)
        port, jm = mgrs
        before = (dict(port._hits), list(port._cached))
        for n in (1, 3, 20):
            assert port.eviction_victims(n) == jm.eviction_victims(n)
        assert port.chain_tokens_map() == jm.chain_tokens_map()
        assert (dict(port._hits), list(port._cached)) == before
        victims = port.eviction_victims(3)
        free0 = set(port._free)
        assert port.evict_cached(3) == 3
        assert set(port._free) - free0 == set(victims)


# ---------------------------------------------------------------------------
# whole-fleet crash and Fleet.recover
# ---------------------------------------------------------------------------

class TestWholeFleetRecovery:
    def test_paged_greedy_and_sampled(self, setup, tmp_path):
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        d = str(tmp_path / "d")
        ids = _crash(Fleet, PrefillWorker, DecodeWorker, pf, dc, d, SUBS)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        assert fleet2.recoveries == 1
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)
        assert fleet2.last_recovery["redriven"] >= 1
        st = fleet2.stats()["durability"]
        assert st["recoveries"] == 1 and st["epoch"] == 1
        # an id issued after the recovery is past every pre-crash id of
        # its worker's range
        rid = fleet2.submit(SUBS[0][0], **SUBS[0][1])
        assert rid > max(i for i in ids if i // 10**6 == rid // 10**6)

    def test_kv_int8(self, setup, tmp_path):
        port, _, _ = setup
        pf, dc = [port["int8"][0]], [port["int8"][1]]
        want = _clean_rows(setup, "int8", pf, dc, SUBS)
        d = str(tmp_path / "d")
        ids = _crash(Fleet, PrefillWorker, DecodeWorker, pf, dc, d, SUBS)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)

    def test_dense(self, setup, tmp_path):
        port, _, _ = setup
        pf, dc = [port["dense"][0]], [port["dense"][1]]
        want = _clean_rows(setup, "dense", pf, dc, SUBS)
        d = str(tmp_path / "d")
        ids = _crash(Fleet, PrefillWorker, DecodeWorker, pf, dc, d, SUBS)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)

    def test_journal_only_without_a_checkpoint(self, setup, tmp_path):
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        d = str(tmp_path / "d")
        ids = _crash(Fleet, PrefillWorker, DecodeWorker, pf, dc, d, SUBS,
                     checkpoint=False, pre_ticks=2, post_ticks=1)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)
        assert fleet2.last_recovery["epoch"] == 0

    def test_torn_tail_recovers_loudly_and_bit_identical(self, setup,
                                                         tmp_path):
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        d = str(tmp_path / "d")
        ids = _crash(Fleet, PrefillWorker, DecodeWorker, pf, dc, d, SUBS,
                     post_ticks=3, torn=True)
        with pytest.warns(RuntimeWarning, match="torn"):
            fleet2 = Fleet.recover(
                d, engine_factory=_factory(_names(pf, dc)))
        assert fleet2.last_recovery["torn_tail"] is True
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)

    def test_scale_records_replay_onto_the_manifest_topology(
            self, setup, tmp_path):
        """A decode worker drained and removed after the checkpoint
        stays gone at recovery; one added after it comes back."""
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        want = _clean_rows(setup, "paged", pf, dc, SUBS)
        d = str(tmp_path / "d")
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, pf, dc[:1],
                       durability=d)
        rid = fleet.submit(SUBS[0][0], **SUBS[0][1])
        fleet.run_until_idle(max_ticks=300)
        fleet.checkpoint()
        dc[1].reset()
        fleet.add_decode_worker(DecodeWorker(dc[1], name="scale0"))
        fleet.drain_decode_worker(0)
        fleet.remove_decode_worker(0)
        del fleet
        _reset(*pf, *dc)
        by = _names(pf, [])
        by["scale0"] = dc[1]
        fleet2 = Fleet.recover(d, engine_factory=_factory(by))
        assert [w.name for w in fleet2.decode] == ["scale0"]
        np.testing.assert_array_equal(fleet2.results[rid], want[0])
        rid2 = fleet2.submit(SUBS[2][0], **SUBS[2][1])
        assert rid2 > rid
        res = fleet2.run_until_idle(max_ticks=300)
        np.testing.assert_array_equal(res[rid2], want[2])

    def test_flight_ring_survives_with_continuing_seqs(self, setup,
                                                       tmp_path):
        port, _, _ = setup
        pf, dc = port["pf"], port["dc"]
        d = str(tmp_path / "d")
        fleet = _fleet(Fleet, PrefillWorker, DecodeWorker, pf, dc,
                       durability=d)
        fleet.submit(SUBS[0][0], **SUBS[0][1])
        for _ in range(3):
            fleet.tick()
        fleet.checkpoint()
        pre_total = fleet.flight.recorded_total()
        del fleet
        _reset(*pf, *dc)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        kinds = [e["kind"] for e in fleet2.flight.events()]
        assert "checkpoint" in kinds and "recovered" in kinds
        seqs = [e["seq"] for e in fleet2.flight.events()]
        assert seqs == sorted(seqs)
        assert fleet2.flight.recorded_total() >= pre_total + 1
        fleet2.run_until_idle(max_ticks=300)
        _check_clean(fleet2)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

class TestAcrossPackages:
    def test_jax_directory_recovers_in_the_port(self, setup, tmp_path):
        """A JAX fleet checkpoints, takes more submissions and is dropped
        two ticks later; the port's ``Fleet.recover`` over port engines
        completes every row token-identical to JAX's uncrashed run,
        greedy and sampled."""
        port, jx, _ = setup
        jpf, jdc = [jx["pf"]], [jx["dc"]]
        want = _clean_rows(setup, "jax", jpf, jdc, SUBS, jax_side=True)
        d = str(tmp_path / "d")
        ids = _crash(JaxFleet, JaxPrefillWorker, JaxDecodeWorker, jpf,
                     jdc, d, SUBS)
        pf, dc = port["pf"][:1], port["dc"][:1]
        _reset(*pf, *dc)
        fleet2 = Fleet.recover(d, engine_factory=_factory(_names(pf, dc)))
        assert fleet2.last_recovery["redriven"] >= 1
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)

    def test_port_directory_recovers_in_jax(self, setup, tmp_path):
        port, jx, _ = setup
        jpf, jdc = [jx["pf"]], [jx["dc"]]
        want = _clean_rows(setup, "jax", jpf, jdc, SUBS, jax_side=True)
        pf, dc = port["pf"][:1], port["dc"][:1]
        d = str(tmp_path / "d")
        ids = _crash(Fleet, PrefillWorker, DecodeWorker, pf, dc, d, SUBS)
        _reset(*jpf, *jdc)
        fleet2 = JaxFleet.recover(
            d, engine_factory=_factory(_names(jpf, jdc)))
        fleet2.run_until_idle(max_ticks=500)
        _assert_recovered(fleet2, ids, want)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_a_snapshot_restores_into_the_other_engine(self, setup,
                                                       tmp_path, writer):
        """A paged Server snapshotted mid-stream (slots decoding, one
        mid-prefill, one queued) by either package restores into the
        other's engine and finishes every row as the writer's uncrashed
        run does."""
        port, jx, _ = setup
        engines = {"jax": (jx["dc"], JaxServer), "port": (port["dc"][0],
                                                          Server)}
        (weng, wsrv), (reng, rsrv) = engines[writer], \
            engines["port" if writer == "jax" else "jax"]
        weng.reset()
        srv = wsrv(weng)
        ids = [srv.submit(p, **kw) for p, kw in SUBS[:4]]
        want = srv.run_until_idle()
        want = [np.asarray(want[r]) for r in ids]
        weng.reset()
        srv = wsrv(weng)
        ids = [srv.submit(p, **kw) for p, kw in SUBS[:4]]
        for _ in range(3):
            srv.run_until_idle(max_ticks=1)
        path = str(tmp_path / "s.npz")
        srv.snapshot(path)
        reng.reset()
        srv2 = rsrv.restore(path, reng)
        res = srv2.run_until_idle()
        for r, w in zip(ids, want):
            np.testing.assert_array_equal(np.asarray(res[r]), w)
        reng.manager.assert_consistent()
        assert not reng.manager._ref


@pytest.mark.parametrize("key_dtype", [np.uint32, np.int64])
def test_key_words_restore_bit_exactly(setup, tmp_path, key_dtype):
    """Slot keys as the JAX package's uint32 words (what the port now
    writes) and as the port's older int64 words both restore bit-exactly
    into the int64 slot state; a file without the port-only counters (a
    JAX file) restores them as 0."""
    port, _, _ = setup
    eng = port["dc"][0]
    eng.reset()
    keys = np.array([[0xFFFFFFFF, 1], [7, 0x80000000]], np.uint32)
    eng._state["key"].copy_(torch.from_numpy(keys.astype(np.int64)))
    path = str(tmp_path / "p.npz")
    eng.snapshot(path)
    meta, arrays = load_snapshot(path)
    assert arrays["state_key"].dtype == np.uint32
    assert meta["engine"]["backend_artifact"] is None
    arrays["state_key"] = arrays["state_key"].astype(key_dtype)
    for c in ("decode_s", "prefills", "prefill_s"):
        del meta["engine"]["counters"][c]
    save_snapshot(path, meta, arrays)
    eng.reset()
    eng._state["key"].fill_(3)
    eng.restore(path)
    np.testing.assert_array_equal(eng._state["key"].numpy(),
                                  keys.astype(np.int64))
    assert (eng.decode_s, eng.prefills, eng.prefill_s) == (0.0, 0, 0.0)
    eng.reset()


@pytest.mark.parametrize("words", ["|V2", "int16"])
def test_bf16_arena_snapshot_is_jax_words(setup, tmp_path, words):
    """A bf16 arena snapshots as npz ``|V2`` words, the dtype a JAX
    (ml_dtypes) bf16 array takes in an npz, and restores bit-exactly
    from them and from the port's older int16 bits; a float16 array is
    refused."""
    m = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    m.to(torch.bfloat16)
    eng = PagedEngine(m, device="cpu", **PAGED)
    (k0,) = eng.backend.caches()[:1]
    assert k0.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for t in eng.backend.caches():
        t.copy_(torch.randn(t.shape, generator=g).to(torch.bfloat16))
    want = [t.clone() for t in eng.backend.caches()]
    path = str(tmp_path / "b.npz")
    eng.snapshot(path)
    meta, arrays = load_snapshot(path)
    assert arrays["cache_0"].dtype == np.dtype("V2")
    arrays = {k: (a.view(np.int16) if words == "int16"
                  and a.dtype == np.dtype("V2") else a)
              for k, a in arrays.items()}
    save_snapshot(path, meta, arrays)
    eng.reset()
    eng.restore(path)
    for t, w in zip(eng.backend.caches(), want):
        assert torch.equal(t.view(torch.int16), w.view(torch.int16))
    arrays["cache_0"] = arrays["cache_0"].view(np.float16)
    save_snapshot(path, meta, arrays)
    with pytest.raises(ValueError, match="cache_0"):
        eng.restore(path)


def test_metric_families_registered_at_import():
    from paddle_tpu_torch.observability import metrics as om
    fams = om.render_prometheus()
    for name in ("pt_journal_appends_total", "pt_journal_bytes_total",
                 "pt_journal_replays_total", "pt_journal_torn_tails_total",
                 "pt_checkpoint_commits_total",
                 "pt_checkpoint_recoveries_total",
                 "pt_prefix_spill_writes_total",
                 "pt_prefix_spill_hits_total",
                 "pt_prefix_spill_misses_total"):
        assert name in fams, name
