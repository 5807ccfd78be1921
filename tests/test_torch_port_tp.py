"""The port's tensor-parallel serving against the JAX package's.

``ContinuousBatchingEngine(model, tp=TPConfig(...))`` (dense, or
``paged=True``) shards its programs over a mesh from one controller
(``paddle_tpu_torch/serving/tp.py``): each shard runs the model's own
cache-path forward, split at the hook sites, on its slice of the heads
and of the KV cache, and the collectives run at the sites. JAX's engine
runs the same programs under ``shard_map`` over the 8 simulated CPU
devices ``tests/conftest.py`` forces; the port's over 8 logical CPU
devices. Both packages load the same weights (``convert.params_from_
jax``). Mirroring ``tests/test_serving_tp.py`` on its 2x4 mesh and
``llama_tiny_config(num_attention_heads=8, num_key_value_heads=8)``:

- exact-mode streams, dense and paged, greedy with staggered arrivals,
  seeded sampling, a chunked prefill under a token budget, the int8
  arena, and ``quant=`` weights: token-identical to the port's
  unsharded engine and to JAX's sharded one; JAX compiles each program
  once, the port captures nothing on the CPU (its count is 0) and
  builds no second program;
- every KV leaf holds ``kvh / 8`` heads a shard; the column weights
  are split, the replicated ones shared;
- psum mode: one decode step's log-probs within ``PSUM_ATOL`` of JAX's
  psum engine's on the same state (both reassociate the sums of the
  row-parallel products, in different orders); the int8 hop's bound
  equal to JAX's on the same state within ``BOUND_RTOL``, at least
  the measured |int8 - fp32| hidden state, and the armed gate refusing
  and staying armed;
- snapshots: a sharded engine's snapshot holds the global arena
  (``pt-serving-snapshot`` v1, global ``pool_specs``), restores into a
  fresh sharded engine, an unsharded one and JAX's sharded engine, and
  a JAX sharded snapshot restores into the port's;
- a sharded owner's prefix fetch (``kv_{i}_p{s}`` chunks and
  ``src_tp_degree``) and its disk spill are adopted by a degree-1 and a
  degree-2 requester with the owner's stream;
- the env knobs, the validation errors and JAX's refusals (spec,
  preemption, megakernel; quant with psum), ``Server.stats()
  ["tp_degree"]`` and the collective accounting."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import build_device_mesh as jax_mesh
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving import TPConfig as JaxTPConfig

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.distributed.mesh import (build_device_mesh,
                                               set_current_mesh)
from paddle_tpu_torch.models import (LlamaForCausalLM, decode_step_logprobs,
                                     llama_tiny_config)
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      DecodeWorker, FairScheduler, Fleet,
                                      PagedEngine, PrefillPagedEngine,
                                      PrefillWorker, Scheduler, Server,
                                      SpecConfig, adopt_prefix,
                                      extract_prefix)
from paddle_tpu_torch.serving.durability import (extract_chain,
                                                 slice_prefix_payload)
from paddle_tpu_torch.serving.resilience import load_snapshot
from paddle_tpu_torch.serving.tp import (ShardedLeaf,
                                         ShardedModelStepBackend,
                                         ShardedPagedStepBackend, TPConfig,
                                         resolve_tp_config)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8,
    reason="needs 8 (simulated) devices for the 2x4 mesh")

DENSE = dict(num_slots=2, max_len=64, decode_block=4,
             prompt_buckets=(8, 16))
PAGED = dict(num_slots=2, max_len=64, decode_block=4, paged=True)
CPU = dict(device="cpu")
# psum: the row-parallel partial sums (4 shards of a 128-wide hidden
# state, two layers) add in another order than XLA's psum; each sum
# moves by a few fp32 ulps of values below ~10, which the head
# (V = 512, h = 128, weights ~N(0, 0.02)) carries into the log-probs
# well under 1e-5; 1e-4 leaves a factor of ten
PSUM_ATOL = 1e-4
# the bound is a max over bucket absmaxes of hidden states that the two
# packages compute with differently ordered sums and int8 hops
BOUND_RTOL = 1e-3


@pytest.fixture(scope="module")
def setup():
    """The tiny 8-head model in both packages, both 2x4 meshes, and a
    lazily built engine per (package, kind)."""
    jax.config.update("jax_enable_compilation_cache", False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.seed(0)
    jcfg = jax_tiny_config(num_attention_heads=8, num_key_value_heads=8)
    jm = JaxLlama(jcfg)
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    cfg = llama_tiny_config(num_attention_heads=8, num_key_value_heads=8)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(params_from_jax(named))
    mesh = build_device_mesh({"dp": 2, "mp": 4}, devices=["cpu"] * 8)
    jmesh = jax_mesh({"dp": 2, "mp": 4})
    built = {}

    def engine(name):
        if name in built:
            return built[name]
        tp = TPConfig(axes=("dp", "mp"), mesh=mesh)
        jtp = JaxTPConfig(axes=("dp", "mp"), mesh=jmesh)
        make = {
            "dense": lambda: ContinuousBatchingEngine(tm, **DENSE, **CPU),
            "dense_tp": lambda: ContinuousBatchingEngine(tm, tp=tp, **DENSE,
                                                         **CPU),
            "jax_dense_tp": lambda: JaxEngine(jm, tp=jtp, **DENSE),
            "paged": lambda: ContinuousBatchingEngine(tm, **PAGED, **CPU),
            "paged_tp": lambda: ContinuousBatchingEngine(tm, tp=tp, **PAGED,
                                                         **CPU),
            "jax_paged_tp": lambda: JaxEngine(jm, tp=jtp, **PAGED),
            "int8": lambda: ContinuousBatchingEngine(tm, kv_int8=True,
                                                     **PAGED, **CPU),
            "int8_tp": lambda: ContinuousBatchingEngine(
                tm, kv_int8=True, tp=tp, **PAGED, **CPU),
            "jax_int8_tp": lambda: JaxEngine(jm, kv_int8=True, tp=jtp,
                                             **PAGED),
            "psum": lambda: ContinuousBatchingEngine(
                tm, tp=TPConfig(axes=("mp",), mode="psum", mesh=mesh),
                **DENSE, **CPU),
            "jax_psum": lambda: JaxEngine(
                jm, tp=JaxTPConfig(axes=("mp",), mode="psum", mesh=jmesh),
                **DENSE),
            "psum8": lambda: ContinuousBatchingEngine(
                tm, tp=TPConfig(axes=("mp",), mode="psum", int8=True,
                                mesh=mesh), **DENSE, **CPU),
            "jax_psum8": lambda: JaxEngine(
                jm, tp=JaxTPConfig(axes=("mp",), mode="psum", int8=True,
                                   mesh=jmesh), **DENSE),
        }
        built[name] = make[name]()
        return built[name]

    yield dict(cfg=cfg, tm=tm, jm=jm, mesh=mesh, jmesh=jmesh,
               engine=engine)
    torch.set_num_threads(threads)
    jax.config.update("jax_enable_compilation_cache", True)


def _prompts(cfg, seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lens]


def _serve(engine, prompts, news, stagger=0, server=None, sched=None,
           **kw):
    engine.reset()
    is_jax = isinstance(engine, JaxEngine)
    srv_cls = server or (JaxServer if is_jax else Server)
    sch = sched() if sched is not None else None
    srv = srv_cls(engine, sch) if sch is not None else srv_cls(engine)
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=i * stagger, **kw)
            for i, (p, mn) in enumerate(zip(prompts, news))]
    res = srv.run_until_idle()
    return [np.asarray(res[r]) for r in rids]


def _same(*runs):
    for other in runs[1:]:
        assert len(other) == len(runs[0])
        for w, g in zip(runs[0], other):
            np.testing.assert_array_equal(w, g)


CASES = {
    "greedy_staggered": (0, (5, 9, 12, 5, 9), [6, 4, 7, 5, 6], 2, {}),
    "seeded_sampling": (1, (5, 9, 7), [6, 5, 6], 0,
                        dict(temperature=0.8, top_k=40, top_p=0.9,
                             seed=7)),
}


class TestExactStreams:
    @pytest.mark.parametrize("case", sorted(CASES))
    @pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
    def test_streams_equal_unsharded_and_jax(self, setup, kind, case):
        """Sharded streams token-identical to the port's unsharded
        engine and to JAX's sharded engine; the port builds ONE program
        of each kind (captured on the card; 0 captures on the CPU) and
        JAX compiles one."""
        seed, lens, news, stagger, kw = CASES[case]
        cfg, eng = setup["cfg"], setup["engine"]
        prompts = _prompts(cfg, seed, lens)
        ref = _serve(eng(kind), prompts, news, stagger, **kw)
        tp = eng(f"{kind}_tp")
        got = _serve(tp, prompts, news, stagger, **kw)
        jax_tp = eng(f"jax_{kind}_tp")
        want = _serve(jax_tp, prompts, news, stagger, **kw)
        _same(ref, got, want)
        assert tp.tp_degree() == jax_tp.tp_degree() == 8
        assert tp.decode_compile_count() == 0
        assert jax_tp.decode_compile_count() == 1
        if kind != "dense":
            assert tp.prefill_compile_count() == 0
            assert jax_tp.prefill_compile_count() == 1
            tp.manager.assert_consistent()

    def test_chunked_prefill_budget(self, setup):
        """A long prompt paced by a small prefill budget crosses chunk
        boundaries on the sharded paged engine: streams still equal."""
        cfg, eng = setup["cfg"], setup["engine"]
        rs = np.random.RandomState(6)
        long_p = rs.randint(0, cfg.vocab_size, (21,)).astype(np.int32)
        short_p = rs.randint(0, cfg.vocab_size, (5,)).astype(np.int32)

        def run(engine, srv_cls, sched_cls):
            engine.reset()
            srv = srv_cls(engine, sched_cls(prefill_token_budget=8))
            a = srv.submit(long_p, max_new_tokens=6)
            b = srv.submit(short_p, max_new_tokens=8, arrival_step=1)
            res = srv.run_until_idle()
            return [np.asarray(res[a]), np.asarray(res[b])]

        _same(run(eng("paged"), Server, Scheduler),
              run(eng("paged_tp"), Server, Scheduler),
              run(eng("jax_paged_tp"), JaxServer, JaxScheduler))

    @pytest.mark.parametrize("paged", [False, True])
    def test_quant_exact_layout(self, setup, paged):
        """``quant=`` under exact tp: per-shard codes and scales ride the
        weights' out-dim shards; streams equal the unsharded quantized
        engine's."""
        cfg, tm, mesh = setup["cfg"], setup["tm"], setup["mesh"]
        kw = PAGED if paged else DENSE
        prompts = _prompts(cfg, 14, (5, 9, 12))
        news = [6, 5, 6]
        for quant in ("int8", "int4"):
            ref = ContinuousBatchingEngine(tm, quant=quant, **kw, **CPU)
            tp = ContinuousBatchingEngine(
                tm, quant=quant, tp=TPConfig(axes=("mp",), mesh=mesh),
                **kw, **CPU)
            _same(_serve(ref, prompts, news, stagger=1),
                  _serve(tp, prompts, news, stagger=1))
            q = tp.backend.model.shards[1].llama.layers[0].self_attn.q_proj
            assert q.codes.shape[0] == cfg.hidden_size // 4
            assert q.scales.shape[0] == cfg.hidden_size // 4
            assert tp.weight_error_bound() == ref.weight_error_bound()


class TestShardedState:
    @pytest.mark.parametrize("kind", ["dense", "paged", "int8"])
    def test_kv_cache_shards_head_dim(self, setup, kind):
        """Every pool leaf (4-D arenas and 3-D int8 scales) holds kvh/8
        heads a shard, each shard its own contiguous tensor; snapshots
        and payloads see the global shape."""
        eng = setup["engine"](f"{kind}_tp")
        leaves = eng.backend.caches()
        if kind == "int8":
            assert any(len(leaf.shape) == 3 for leaf in leaves)
        for leaf in leaves:
            assert isinstance(leaf, ShardedLeaf)
            assert len(leaf.shards) == 8
            for t in leaf.shards:
                assert t.shape[2] == leaf.shape[2] // 8
                assert t.is_contiguous()
            assert len({t.data_ptr() for t in leaf.shards}) == 8
        ref = setup["engine"](kind)
        assert eng.backend.pool_specs == ref.backend.pool_specs
        per = eng.backend.shard_kv_bytes()
        assert len(per) == 8 and sum(per) == sum(
            t.numel() * t.element_size() for t in ref.backend.caches())

    def test_weights_split_and_shared(self, setup):
        eng, cfg = setup["engine"]("paged_tp"), setup["cfg"]
        shards = eng.backend.model.shards
        h, ff = cfg.hidden_size, cfg.intermediate_size
        a0, a1 = (m.llama.layers[0].self_attn for m in shards[:2])
        assert a0.q_proj.weight.shape == (h // 8, h)
        assert a0.k_proj.weight.shape == (h // 8, h)
        assert shards[0].llama.layers[0].mlp.up_proj.weight.shape == \
            (ff // 8, h)
        assert shards[0].lm_head.weight.shape == (cfg.vocab_size // 8, h)
        # column slices are views of the model's weight; the exact mode's
        # replicated o_proj is the model's own storage on every shard
        full = setup["tm"].llama.layers[0].self_attn
        assert a1.q_proj.weight.data_ptr() == \
            full.q_proj.weight[h // 8:].data_ptr()
        assert a0.o_proj.weight.data_ptr() == a1.o_proj.weight.data_ptr() \
            == full.o_proj.weight.data_ptr()

    def test_collective_accounting_and_gauges(self, setup):
        """2L + 1 collectives a dispatch, JAX's bytes a token; with the
        registry armed a served stream notes them and the mesh gauges."""
        eng, cfg = setup["engine"]("dense_tp"), setup["cfg"]
        L, h, ff, V = (cfg.num_hidden_layers, cfg.hidden_size,
                       cfg.intermediate_size, cfg.vocab_size)
        assert eng.backend.collective_accounting() == {
            "calls_per_dispatch": 2 * L + 1,
            "bytes_per_token": 4 * (L * (h + ff) + V)}
        prev = metrics.enabled()
        metrics.enable(True)
        try:
            bytes_c = metrics.counter(
                "pt_collectives_bytes_total",
                "payload bytes handed to collectives",
                labels=("op", "mode"))
            b0 = bytes_c.value(op="tp_block", mode="tp_graph")
            _serve(eng, _prompts(cfg, 12, (5, 9)), [4, 4])
            assert bytes_c.value(op="tp_block", mode="tp_graph") > b0
            assert metrics.gauge("pt_serving_tp_devices").value() == 8
            ax = metrics.gauge("pt_serving_tp_mesh_axis_size",
                               labels=("axis",))
            assert ax.value(axis="dp") == 2 and ax.value(axis="mp") == 4
        finally:
            metrics.enable(prev)


def _step_logprobs(engine):
    """One decode step's (S, V) log-probs on the engine's live state."""
    b, st = engine.backend, engine._state
    return decode_step_logprobs(b.model, st["tok"][:, None], b.cache,
                                st["pos"], pad=st["pad"])


def _jax_step_logprobs(engine):
    """The same from JAX's sharded dense engine: its own pure step under
    its backend's shard_map."""
    from jax.sharding import PartitionSpec as P
    b = engine.backend

    def step(pv, bv, cache_flat, state):
        logp, _ = b._pure(pv, bv, state["tok"][:, None], cache_flat,
                          state["pos"], None, state["pad"])
        return logp

    fn = b._shard_jit(step, in_specs=(b._pv_pspecs, b._bv_pspecs,
                                      b._cache_pspecs, b._state_pspecs),
                      out_specs=P())
    return np.asarray(fn(b._pv, b._bv, engine._cache, engine._state))


def _one_tick(engine, prompts):
    engine.reset()
    srv = (JaxServer if isinstance(engine, JaxEngine) else Server)(engine)
    for p in prompts:
        srv.submit(p, max_new_tokens=12)
    srv.run_until_idle(max_ticks=1)


class TestPsum:
    def test_logits_within_tolerance_of_jax(self, setup):
        """psum mode: row-sharded o/down, the hidden state all-reduced.
        After the same admissions and one block, both packages hold the
        same tokens; one step's log-probs agree within PSUM_ATOL, and
        the greedy streams agree."""
        cfg, eng = setup["cfg"], setup["engine"]
        prompts = _prompts(cfg, 7, (5, 9))
        port, jx = eng("psum"), eng("jax_psum")
        _one_tick(port, prompts)
        _one_tick(jx, prompts)
        np.testing.assert_array_equal(port._state["tok"].numpy(),
                                      np.asarray(jx._state["tok"]))
        got = _step_logprobs(port).numpy()
        want = _jax_step_logprobs(jx)
        np.testing.assert_allclose(got, want, rtol=0, atol=PSUM_ATOL)
        _same(_serve(port, prompts, [6, 5]), _serve(jx, prompts, [6, 5]))
        assert port.tp_degree() == 4
        assert port.tp_int8_error_bound() == 0.0

    def test_int8_bound_matches_jax_and_covers_the_error(self, setup):
        """The int8 hop's bound, probed on the live state, equals JAX's
        on the same state within BOUND_RTOL, is positive and small, and
        is at least the measured |int8 - fp32| of the step's log-probs'
        inputs (the fp32 psum engine on the same state); the probe
        leaves the programs alone."""
        cfg, eng = setup["cfg"], setup["engine"]
        prompts = _prompts(cfg, 8, (5, 9))
        port, jx = eng("psum8"), eng("jax_psum8")
        _one_tick(port, prompts)
        _one_tick(jx, prompts)
        np.testing.assert_array_equal(port._state["tok"].numpy(),
                                      np.asarray(jx._state["tok"]))
        bound = port.tp_int8_error_bound()
        assert 0.0 < bound < 1.0
        np.testing.assert_allclose(bound, jx.tp_int8_error_bound(),
                                   rtol=BOUND_RTOL)
        assert port.decode_compile_count() == 0
        assert jx.decode_compile_count() == 1

    def test_hidden_state_error_within_bound(self, setup):
        """One hop measured: the int8 all-reduce of the first layer's
        o_proj partial sums against the fp32 one, on the live state,
        within the hop's runtime bound."""
        from paddle_tpu_torch.distributed.collectives.hierarchical import (
            hier_all_reduce)
        from paddle_tpu_torch.distributed.collectives.quantized import (
            quantized_all_reduce)
        from paddle_tpu_torch.utils import tp_hooks
        cfg, eng = setup["cfg"], setup["engine"]
        port = eng("psum8")
        _one_tick(port, _prompts(cfg, 8, (5, 9)))
        seen = []
        orig = tp_hooks.maybe_reduce

        def spy(ts):
            if not seen:
                seen.append([t.clone() for t in ts])
            return orig(ts)
        tp_hooks.maybe_reduce = spy
        try:
            port.tp_int8_error_bound()
        finally:
            tp_hooks.maybe_reduce = orig
        plan = port.backend.tp_plan
        exact = hier_all_reduce(seen[0], plan)[0]
        q, b = quantized_all_reduce(seen[0], plan, return_error_bound=True)
        err = float((q[0] - exact).abs().max())
        assert 0.0 < err <= float(b)

    def test_budget_gate_refuses_and_stays_armed(self, setup):
        cfg, eng = setup["cfg"], setup["engine"]
        port = eng("psum8")
        backend = port.backend
        old = backend.tp
        backend.tp = dataclasses.replace(old, int8_max_error=1e-12)
        backend._int8_gate_pending = True
        try:
            with pytest.raises(RuntimeError, match="error bound"):
                _serve(port, _prompts(cfg, 9, (5,)), [4])
            assert backend._int8_gate_pending
            with pytest.raises(RuntimeError, match="error bound"):
                _serve(port, _prompts(cfg, 9, (5,)), [4])
        finally:
            backend.tp = old
            backend._int8_gate_pending = False
        assert len(_serve(port, _prompts(cfg, 9, (5,)), [4])[0]) == 9


def _snapshot_midstream(engine, srv_cls, prompts, path):
    engine.reset()
    srv = srv_cls(engine)
    ids = [srv.submit(p, max_new_tokens=6, arrival_step=i)
           for i, p in enumerate(prompts)]
    srv.run_until_idle(max_ticks=2)
    srv.snapshot(path)
    return ids


class TestSnapshots:
    @pytest.mark.parametrize("kind", ["dense", "paged"])
    def test_round_trip_and_across_degrees(self, setup, tmp_path, kind):
        """Kill mid-stream: the sharded snapshot holds the global arena
        (the unsharded engine's pool_specs) and restores into a fresh
        sharded engine and an unsharded one, every stream identical."""
        cfg, tm, mesh, eng = (setup["cfg"], setup["tm"], setup["mesh"],
                              setup["engine"])
        prompts = _prompts(cfg, 10, (5, 9, 12))
        tp = eng(f"{kind}_tp")
        tp.reset()
        srv = Server(tp)
        for i, p in enumerate(prompts):
            srv.submit(p, max_new_tokens=6, arrival_step=i)
        want = dict(srv.run_until_idle())
        path = str(tmp_path / "tp.npz")
        _snapshot_midstream(tp, Server, prompts, path)
        meta, arrays = load_snapshot(path)
        assert meta["engine"]["pool_specs"] == \
            [[list(s), d] for s, d in eng(kind).backend.pool_specs]
        kw = PAGED if kind == "paged" else DENSE
        fresh = ContinuousBatchingEngine(
            tm, tp=TPConfig(axes=("mp",), mesh=mesh), **kw, **CPU)
        for target in (fresh, eng(kind)):
            target.reset()
            res = Server.restore(path, target).run_until_idle()
            for rid in want:
                np.testing.assert_array_equal(res[rid], want[rid])

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_crosses_packages(self, setup, tmp_path, writer):
        """A JAX sharded snapshot restores into the port's sharded
        engine, and the port's into JAX's."""
        cfg, eng = setup["cfg"], setup["engine"]
        prompts = _prompts(cfg, 11, (5, 9, 12))
        engines = {"jax": (eng("jax_paged_tp"), JaxServer),
                   "port": (eng("paged_tp"), Server)}
        (w_eng, w_srv) = engines[writer]
        (r_eng, r_srv) = engines["port" if writer == "jax" else "jax"]
        w_eng.reset()
        srv = w_srv(w_eng)
        ids = [srv.submit(p, max_new_tokens=6, arrival_step=i)
               for i, p in enumerate(prompts)]
        want = srv.run_until_idle()
        path = str(tmp_path / "s.npz")
        ids = _snapshot_midstream(w_eng, w_srv, prompts, path)
        r_eng.reset()
        res = r_srv.restore(path, r_eng).run_until_idle()
        for rid in ids:
            np.testing.assert_array_equal(np.asarray(res[rid]),
                                          np.asarray(want[rid]))


class TestPrefixFetchAndSpill:
    def test_sharded_owner_adopted_by_both_degrees(self, setup):
        """A degree-8 owner's fetch payload ships per-shard chunks; a
        degree-1 and a degree-2 requester adopt it (and its disk-spill
        twin, re-skipped past a local block) and serve the owner's
        stream from the fetched blocks."""
        cfg, tm, eng = setup["cfg"], setup["tm"], setup["engine"]
        owner = eng("paged_tp")
        rs = np.random.RandomState(13)
        prompt = rs.randint(0, cfg.vocab_size, (40,)).astype(np.int32)
        want = _serve(owner, [prompt], [6])[0]
        n = (len(prompt) - 1) // owner.kv_block_size
        h = extract_prefix(owner, prompt, n)
        assert h.meta["src_tp_degree"] == 8
        assert "kv_0_p7" in h.arrays and "kv_0" not in h.arrays
        spill = extract_chain(owner, prompt, n)
        assert spill.meta["src_tp_degree"] == 8
        mesh2 = build_device_mesh({"mp": 2}, devices=["cpu"] * 2)
        kw = dict(num_slots=2, max_len=64, decode_block=4, **CPU)
        for tp in (None, TPConfig(mesh=mesh2)):
            for payload, local in ((h, 0), (spill, 1)):
                req = PagedEngine(tm, tp=tp, **kw)
                req.reset()
                local_blocks = []
                if local:
                    # one chain block held locally: prefill a prompt that
                    # shares it, then re-skip the stored payload
                    _serve(req, [prompt[:req.kv_block_size + 1]], [1])
                    local_blocks = req.manager.match_prefix(
                        prompt[:req.kv_block_size + 1])
                    payload = slice_prefix_payload(payload, local)
                got = adopt_prefix(req, payload, local_blocks, prompt)
                assert got is not None
                req.manager.release(local_blocks + got)
                srv = Server(req)
                rid = srv.submit(prompt, max_new_tokens=6)
                out = srv.run_until_idle()[rid]
                np.testing.assert_array_equal(out, want)
                assert req.shared_tokens == n * req.kv_block_size


class TestFleetHandoff:
    def test_sharded_prefill_worker_hands_off_to_both_degrees(self, setup):
        """A degree-8 prefill-only engine (no decode program) hands each
        prompt to a degree-1 and a degree-8 decode worker; the handoff's
        ``source`` carries ``tp_degree`` 8 (JAX's meta) and its arrays
        the global rows; the fleet's streams equal the unsharded paged
        engine's."""
        cfg, tm, mesh, eng = (setup["cfg"], setup["tm"], setup["mesh"],
                              setup["engine"])
        kw = dict(num_slots=2, max_len=64, decode_block=4, **CPU)
        tp = TPConfig(axes=("dp", "mp"), mesh=mesh)
        pf = PrefillPagedEngine(tm, tp=tp, **kw)
        assert pf.tp_degree() == 8 and pf.decode_compile_count() == 0
        metas = []
        orig = pf.extract_handoff

        def spy(ph, source=""):
            h = orig(ph, source)
            metas.append(h.meta)
            return h
        pf.extract_handoff = spy
        prompts = _prompts(cfg, 15, (5, 9, 12, 7))
        news = [6, 5, 4, 6]
        want = _serve(eng("paged"), prompts, news)
        for dc in (PagedEngine(tm, **kw), PagedEngine(tm, tp=tp, **kw)):
            pf.reset()
            fleet = Fleet([PrefillWorker(pf)], [DecodeWorker(dc)])
            rids = [fleet.submit(p, max_new_tokens=n)
                    for p, n in zip(prompts, news)]
            res = fleet.run_until_idle()
            _same(want, [np.asarray(res[r]) for r in rids])
        assert metas and all(m["source"]["tp_degree"] == 8 for m in metas)


class TestRoutesAndRefusals:
    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("PT_SERVING_TP", "1")
        monkeypatch.setenv("PT_SERVING_TP_AXES", " dp , mp ")
        monkeypatch.setenv("PT_SERVING_TP_MODE", "psum")
        monkeypatch.setenv("PT_SERVING_TP_INT8", "1")
        cfg = resolve_tp_config(None)
        assert cfg.axes == ("dp", "mp")
        assert cfg.mode == "psum" and cfg.int8
        monkeypatch.delenv("PT_SERVING_TP")
        assert resolve_tp_config(None) is None
        assert resolve_tp_config(False) is None
        assert resolve_tp_config(True) == TPConfig()

    def test_env_flag_constructs_sharded_backends(self, setup, monkeypatch):
        tm, mesh, eng = setup["tm"], setup["mesh"], setup["engine"]
        monkeypatch.setenv("PT_SERVING_TP", "1")
        monkeypatch.setenv("PT_SERVING_TP_AXES", "mp")
        set_current_mesh(mesh)
        try:
            dense = ContinuousBatchingEngine(tm, num_slots=1, max_len=32,
                                             decode_block=2, **CPU)
            assert isinstance(dense.backend, ShardedModelStepBackend)
            assert dense.tp_degree() == 4
            paged = PagedEngine(tm, num_slots=1, max_len=32,
                                decode_block=2, **CPU)
            assert isinstance(paged.backend, ShardedPagedStepBackend)
            # an explicit backend is never rerouted by the env knobs
            again = ContinuousBatchingEngine(backend=eng("dense").backend)
            assert again.tp_degree() == 1
        finally:
            set_current_mesh(None)

    def test_server_stats_carry_tp_degree(self, setup):
        cfg, eng = setup["cfg"], setup["engine"]
        for name, want in (("dense_tp", 8), ("dense", None)):
            e = eng(name)
            e.reset()
            srv = Server(e)
            srv.submit(_prompts(cfg, 3, (5,))[0], max_new_tokens=4)
            srv.run_until_idle()
            assert srv.stats().get("tp_degree") == want

    def test_validation(self, setup):
        tm, mesh = setup["tm"], setup["mesh"]
        kw = dict(num_slots=1, max_len=32, decode_block=2, **CPU)
        with pytest.raises(ValueError, match="expected"):
            TPConfig(mode="fast")
        with pytest.raises(ValueError, match="psum"):
            TPConfig(int8=True)
        with pytest.raises(ValueError, match="pass a TPConfig"):
            ContinuousBatchingEngine(tm, tp=4, **kw)
        set_current_mesh(None)
        with pytest.raises(ValueError, match="needs a mesh"):
            ContinuousBatchingEngine(tm, tp=TPConfig(), **kw)
        with pytest.raises(ValueError, match="not in mesh"):
            ContinuousBatchingEngine(tm, tp=TPConfig(axes=("nope",),
                                                     mesh=mesh), **kw)
        with pytest.raises(ValueError, match="nothing to shard"):
            ContinuousBatchingEngine(tm, tp=TPConfig(axes=("pp",),
                                                     mesh=mesh), **kw)
        m4 = LlamaForCausalLM(llama_tiny_config(), device="cpu")
        with pytest.raises(ValueError, match="divisible"):
            ContinuousBatchingEngine(m4, tp=TPConfig(axes=("dp", "mp"),
                                                     mesh=mesh), **kw)
        m0 = LlamaForCausalLM(llama_tiny_config(tensor_parallel=False),
                              device="cpu")
        with pytest.raises(ValueError, match="partition specs"):
            ContinuousBatchingEngine(m0, tp=TPConfig(mesh=mesh), **kw)

    def test_refusals_are_jax_s(self, setup):
        """spec=, megakernel= and preemption= beside tp=, and quant= with
        the psum layout, are refused as JAX refuses them."""
        tm, mesh, eng = setup["tm"], setup["mesh"], setup["engine"]
        kw = dict(num_slots=2, max_len=32, decode_block=2, **CPU)
        tp = TPConfig(mesh=mesh)
        for paged in (False, True):
            with pytest.raises(NotImplementedError,
                               match="speculative decoding is not yet"):
                ContinuousBatchingEngine(tm, spec=SpecConfig(k=2), tp=tp,
                                         paged=paged, **kw)
            with pytest.raises(NotImplementedError, match="megakernel"):
                ContinuousBatchingEngine(tm, megakernel=True, tp=tp,
                                         paged=paged, **kw)
            with pytest.raises(NotImplementedError, match="mode='exact'"):
                ContinuousBatchingEngine(
                    tm, quant="int8", paged=paged,
                    tp=TPConfig(mode="psum", mesh=mesh), **kw)
        with pytest.raises(NotImplementedError, match="preemption"):
            Server(eng("dense_tp"), FairScheduler(), preemption=True)
