"""The port's KV handoff wire format (``paddle_tpu_torch.serving
.handoff``) and fleet transports (``serving.transport``) against the JAX
package's.

Wire compatibility: each package decodes the other's bytes into equal
meta, equal arrays and an equal CRC (fp32, int8 and uint32 leaves; bf16
leaves travel as npz's raw ``|V2`` words in both, and the port's CRC
names them ``bfloat16`` on both sides of the wire, as the JAX sender
does). Payloads extracted from the port's prefill engine ship only the
prompt blocks, int8 arenas as codes + scales (never dequantized).
``reshard_kv_chunks`` equals JAX's. The localhost ``SocketTransport``
delivers under the ``transport.corrupt``, ``transport.partial_write`` and
``transport.disconnect`` fault sites with the JAX transport's counters,
and every fault site threaded in the port appears in its catalog."""
import io
import json
import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.serving import handoff as jhandoff
from paddle_tpu.serving import transport as jtransport
from paddle_tpu.utils import faults as jfaults

from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import (KVHandoff, PrefillPagedEngine,
                                      Request, SocketTransport,
                                      TransportError, decode_handoff,
                                      encode_handoff, reshard_kv_chunks)
from paddle_tpu_torch.serving.handoff import leaf_to_wire, wire_to_tensor
from paddle_tpu_torch.utils import faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
          prefill_chunk=8, device="cpu")


@pytest.fixture(autouse=True)
def _disarmed():
    jfaults.clear()
    tfaults.clear()
    yield
    jfaults.clear()
    tfaults.clear()


def _payload(rs, kind="paged"):
    """A synthetic payload with every leaf kind the wire carries."""
    return ({"kind": kind, "request": {"request_id": 7, "seed": 3},
             "tok0": 3, "pos0": 13, "rem0": 4, "n_blocks": 3,
             "n_ship": 2, "block_size": 8, "kv_int8": True,
             "leaf_specs": [[[8, 4, 32], "int8"], [[8, 4], "float32"]],
             "t_admit": 1.5, "seq": 9},
            {"prompt": rs.randint(0, 512, (13,)).astype(np.int32),
             "key": rs.randint(0, 2 ** 32, (2,), dtype=np.uint64)
             .astype(np.uint32),
             "kv_0": rs.randint(-127, 128, (2, 8, 4, 32)).astype(np.int8),
             "kv_1": rs.rand(2, 8, 4).astype(np.float32),
             "kv_2": rs.randn(2, 8, 4, 32).astype(np.float32)})


def _assert_same(a, b):
    assert a.meta == b.meta
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        x, y = a.arrays[k], b.arrays[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k
    assert a.payload_crc32() == b.payload_crc32()


class TestWireFormat:
    def test_roundtrip_and_refusals(self):
        meta, arrays = _payload(np.random.RandomState(0))
        h = KVHandoff(meta=dict(meta), arrays=dict(arrays))
        h.meta["crc32"] = h.payload_crc32()
        back = decode_handoff(encode_handoff(h))
        assert back.request_id == 7 and back.kind == "paged"
        back.verify_crc()
        for k, v in arrays.items():
            np.testing.assert_array_equal(back.arrays[k], v)
            assert back.arrays[k].dtype == v.dtype
        assert back.kv_bytes() == sum(arrays[k].nbytes for k in arrays
                                      if k.startswith("kv_"))
        tampered = KVHandoff(meta=dict(back.meta), arrays=dict(
            back.arrays, kv_0=back.arrays["kv_0"] + np.int8(1)))
        with pytest.raises(ValueError, match="CRC"):
            tampered.verify_crc()
        with pytest.raises(Exception):
            decode_handoff(b"not an npz payload")
        for bad, msg in (({"format": "other"}, "not a KV handoff"),
                         ({"version": 2}, "unsupported")):
            bio = io.BytesIO()
            np.savez(bio, __meta__=np.array(json.dumps(
                dict({"format": "pt-kv-handoff", "version": 1}, **bad))))
            with pytest.raises(ValueError, match=msg):
                decode_handoff(bio.getvalue())

    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_each_package_decodes_the_others_bytes(self, direction):
        """Equal meta, arrays and CRC from either decoder, and from the
        other encoder's bytes (npz stamps its entries with the wall
        clock, so two encodes are compared decoded)."""
        meta, arrays = _payload(np.random.RandomState(1))
        jh = jhandoff.KVHandoff(meta=dict(meta), arrays=dict(arrays))
        th = KVHandoff(meta=dict(meta), arrays=dict(arrays))
        jh.meta["crc32"] = jh.payload_crc32()
        th.meta["crc32"] = th.payload_crc32()
        assert jh.meta["crc32"] == th.meta["crc32"]
        jb, tb = jhandoff.encode_handoff(jh), encode_handoff(th)
        data, other = (jb, tb) if direction == "jax_to_port" else (tb, jb)
        got_t, got_j = decode_handoff(data), jhandoff.decode_handoff(data)
        _assert_same(got_t, got_j)
        _assert_same(got_t, decode_handoff(other))
        got_t.verify_crc()
        got_j.verify_crc()

    def test_bf16_round_trip(self):
        """A bf16 leaf ships as its raw words: the port's payload decodes
        to the JAX package's (ml_dtypes) one, its CRC is the JAX
        sender's, and the words come back bit for bit. (The JAX decoder
        names the words ``|V2`` in its CRC and so refuses bf16 payloads,
        its own included: ROADMAP C.)"""
        x = torch.randn(2, 8, 4, 32).to(torch.bfloat16)
        w = leaf_to_wire(x)
        assert w.dtype == np.dtype("V2")
        jx = x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        th = KVHandoff(meta={"kind": "paged",
                             "request": {"request_id": 1}},
                       arrays={"kv_0": w})
        jh = jhandoff.KVHandoff(meta=dict(th.meta), arrays={"kv_0": jx})
        assert th.payload_crc32() == jh.payload_crc32()
        th.meta["crc32"] = th.payload_crc32()
        jh.meta["crc32"] = jh.payload_crc32()
        data = encode_handoff(th)
        from_jax = decode_handoff(jhandoff.encode_handoff(jh))
        back = decode_handoff(data)
        _assert_same(back, from_jax)
        back.verify_crc()
        from_jax.verify_crc()
        with pytest.raises(ValueError, match="CRC"):
            jhandoff.decode_handoff(data).verify_crc()
        y = wire_to_tensor(back.arrays["kv_0"], torch.bfloat16, "cpu")
        assert y.dtype == torch.bfloat16
        assert torch.equal(y.view(torch.int16), x.view(torch.int16))
        with pytest.raises(ValueError, match="bfloat16"):
            wire_to_tensor(np.zeros(3, np.float32), torch.bfloat16, "cpu")
        with pytest.raises(ValueError, match="arena holds"):
            wire_to_tensor(np.zeros(3, np.float64), torch.float32, "cpu")

    @pytest.mark.parametrize("src,dst", [(1, 2), (2, 1), (2, 4), (4, 2),
                                         (3, 1), (1, 4)])
    def test_reshard_kv_chunks_equals_jax(self, src, dst):
        rs = np.random.RandomState(src * 10 + dst)
        full = rs.randn(3, 8, 12, 16).astype(np.float32)
        chunks = np.split(full, src, axis=2)
        got = reshard_kv_chunks(chunks, dst, axis=2)
        want = jhandoff.reshard_kv_chunks(chunks, dst, axis=2)
        assert len(got) == len(want) == dst
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.concatenate(got, axis=2), full)
        with pytest.raises(ValueError):
            reshard_kv_chunks(chunks, 5, axis=2)
        with pytest.raises(ValueError):
            reshard_kv_chunks(chunks, 0, axis=2)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return LlamaForCausalLM(llama_tiny_config(), device="cpu")


def _parked(engine, prompt, max_new=6):
    """Prefill one request on a prefill-only engine until it parks in
    the outbox; returns the pending handoff."""
    engine.reset()
    assert engine.try_admit(Request(request_id=11, prompt=prompt,
                                    max_new_tokens=max_new))
    while not engine._outbox:
        engine.prefill_tick(None)
    ph, = engine.take_handoffs()
    return ph


class TestExtract:
    def test_int8_payload_ships_codes_never_dequantized(self, model):
        prompt = np.random.RandomState(2).randint(0, 512, (21,)) \
            .astype(np.int32)
        sizes = {}
        for kv_int8 in (False, True):
            eng = PrefillPagedEngine(model, kv_int8=kv_int8, **KW)
            ph = _parked(eng, prompt)
            h = eng.extract_handoff(ph, source="p0")
            leaves = [h.arrays[f"kv_{i}"]
                      for i in range(len(eng.backend.pool_specs))]
            want = [d for _, d in eng.backend.pool_specs]
            assert [str(a.dtype) for a in leaves] == want
            if kv_int8:
                assert want[:2] == ["int8", "int8"] \
                    and want[2:4] == ["float32", "float32"]
                # the wire arrays are the arena's bytes as they are
                ids = torch.as_tensor(ph.run.block_ids[:3])
                for a, t in zip(leaves, eng.backend.caches()):
                    assert a.tobytes() == t[ids].numpy().tobytes()
            sizes[kv_int8] = h.kv_bytes()
            eng.release_handoff(ph)
            assert not eng.manager._ref
            eng.manager.assert_consistent()
        d = 128 // 4
        assert sizes[False] / sizes[True] == pytest.approx(
            4 * d / (d + 4))

    def test_only_prompt_blocks_ship(self, model):
        """ceil(L / bs) blocks ship of the blocks_needed the request
        holds; the key ships as the JAX (2,) uint32 words of the slot's
        int64 key."""
        eng = PrefillPagedEngine(model, **KW)
        prompt = np.random.RandomState(3).randint(0, 512, (13,)) \
            .astype(np.int32)
        ph = _parked(eng, prompt, max_new=20)
        h = eng.extract_handoff(ph)
        assert h.meta["n_ship"] == 2
        assert h.meta["n_blocks"] == eng.blocks_needed(13, 20) == 4
        assert h.arrays["kv_0"].shape == (2, 8, 4, 32)
        assert h.arrays["key"].dtype == np.uint32
        assert h.arrays["key"].shape == (2,)
        assert h.meta["pos0"] == 13 and h.meta["rem0"] == 19
        eng.release_handoff(ph)
        assert not eng.manager._ref


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def _drain(t, dst):
    got = []
    while True:
        d = t.recv(dst)
        if d is None:
            return got
        got.append(d)


@pytest.fixture
def pair_of_transports():
    ts = (SocketTransport("fleet", retry_backoff_s=0.001),
          jtransport.SocketTransport("fleet", retry_backoff_s=0.001))
    yield ts
    for t in ts:
        t.close()


class TestSocketTransport:
    @pytest.mark.parametrize("spec,want", [
        ("", [b"one", b"two"]),
        ("transport.corrupt:at=1", [b"one", b"two"]),
        ("transport.partial_write:at=2", [b"one", b"two"]),
        ("transport.disconnect:at=1", [b"one", b"one", b"two"]),
    ])
    def test_delivery_under_wire_faults_equals_jax(self, pair_of_transports,
                                                   spec, want):
        """The same frames delivered and the same counters as the JAX
        transport under the same fault schedule; a disconnect before the
        ack delivers a duplicate (at-least-once)."""
        stats = []
        for t, fl in zip(pair_of_transports, (tfaults, jfaults)):
            with fl.injected(spec, seed=0):
                t.send("w1", b"one")
                t.send("w1", b"two")
            assert _drain(t, "w1") == want
            assert t.pending() == 0
            stats.append(t.stats())
        assert stats[0] == stats[1]
        if spec:
            assert stats[0]["resends"] >= 1

    def test_fifo_counters_drop_and_close(self, pair_of_transports):
        t = pair_of_transports[0]
        t.send("w1", b"payload-one")
        t.send("w2", b"other")
        assert t.pending() == 2
        assert t.recv("w1") == b"payload-one" and t.recv("w2") == b"other"
        assert t.stats()["bytes_sent"] == len(b"payload-one") + 5
        t.send("w1", b"doomed")
        t.drop_endpoint("w1")
        assert t.recv("w1") is None
        t.send("w1", b"successor")
        assert t.recv("w1") == b"successor"
        t.close()
        with pytest.raises(TransportError, match="closed"):
            t.send("w1", b"x")

    def test_exhausted_retry_budget_raises(self):
        t = SocketTransport("fleet", retry_attempts=1,
                            retry_backoff_s=0.001)
        try:
            with tfaults.injected("transport.corrupt:every=1"):
                with pytest.raises(TransportError, match="failed"):
                    t.send("w1", b"never-arrives-intact")
            assert t.recv("w1") is None
        finally:
            t.close()
        with pytest.raises(ValueError):
            SocketTransport("fleet", retry_attempts=-1)

    def test_transport_error_is_transient(self):
        from paddle_tpu_torch.serving.resilience import (ResilienceConfig,
                                                         ResilienceState)
        assert TransportError in ResilienceState(ResilienceConfig()) \
            .transient


class TestFaultSiteTable:
    def test_every_armed_site_appears_in_the_docstring_table(self):
        """The faults docstring table is the site catalog; every site the
        port threads appears in it, and they are the JAX package's sites,
        the durable control plane's included."""
        pat = re.compile(
            r"(?:fault_point|should_fire)\(\s*[\"']([a-z_.]+)[\"']")

        def sites(pkg):
            out = set()
            for dirpath, _dirs, files in os.walk(os.path.join(ROOT, pkg)):
                for fn in files:
                    if fn.endswith(".py"):
                        with open(os.path.join(dirpath, fn)) as f:
                            out.update(pat.findall(f.read()))
            return out

        port, jax_sites = sites("paddle_tpu_torch"), sites("paddle_tpu")
        missing = {s for s in port if s not in tfaults.__doc__}
        assert not missing, sorted(missing)
        assert port == jax_sites
        for s in ("fleet.serialize", "fleet.transport", "fleet.adopt",
                  "fleet.fetch", "fleet.directory", "fleet.scale",
                  "transport.partial_write", "transport.corrupt",
                  "transport.disconnect", "journal.write",
                  "journal.torn_tail", "checkpoint.commit", "spill.read"):
            assert s in port
            assert s in jfaults.__doc__
