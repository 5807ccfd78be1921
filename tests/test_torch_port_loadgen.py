"""The port's open-loop load generator (``paddle_tpu_torch.serving
.loadgen``) against the JAX package's.

The same ``TraceConfig`` gives the same trace JSON string in both
packages (plain; diurnal with bursts; shared prefixes with sampled
requests), a trace written by either package reads back in the other
with equal requests, and ``replay`` of one trace through the port's
``Server`` and through the JAX ``Server`` (the same tiny Llama, weights
moved through numpy) gives the same results under the same ids."""
import jax
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving import loadgen as jloadgen

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import (PagedEngine, Request, Server, Trace,
                                      TraceConfig, generate_trace, replay)

ENGINE_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                 prefill_chunk=8)

CONFIGS = {
    "plain": dict(seed=3, horizon=40, base_rate=0.4),
    "diurnal_bursts": dict(seed=11, horizon=90, base_rate=0.3,
                           diurnal_period=30, diurnal_amplitude=0.7,
                           bursts=2, burst_mult=3.0, burst_len=(5, 9),
                           tenants={"a": 2.0, "b": 1.0},
                           priority_weights={0: 3.0, 1: 1.0}),
    "shared_sampled": dict(seed=5, horizon=50, base_rate=0.5,
                           shared_fraction=0.5, shared_len=12,
                           shared_prompts=2, sampled_fraction=0.25,
                           prompt_lo=4, prompt_hi=30, output_lo=2,
                           output_hi=10),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trace_json_equals_jax(name):
    """Byte-identical JSON for the same config, and each package reads
    the other's JSON back into equal requests."""
    kw = CONFIGS[name]
    tj = jloadgen.generate_trace(jloadgen.TraceConfig(**kw))
    tt = generate_trace(TraceConfig(**kw))
    assert len(tt) > 5
    assert tt.to_json() == tj.to_json()
    assert tt.stats() == tj.stats()
    back = Trace.from_json(tj.to_json())
    assert back.to_json() == tj.to_json()
    assert all(isinstance(r, Request) for r in back.requests)
    assert jloadgen.Trace.from_json(tt.to_json()).to_json() == \
        tt.to_json()


def test_sampled_fraction_does_not_shift_arrivals():
    """The per-component streams: changing the sampled fraction moves no
    arrival tick and no prompt length."""
    a = generate_trace(TraceConfig(seed=2, horizon=60, base_rate=0.5))
    b = generate_trace(TraceConfig(seed=2, horizon=60, base_rate=0.5,
                                   sampled_fraction=0.5))
    assert [(r.arrival_step, r.prompt.size) for r in a.requests] == \
        [(r.arrival_step, r.prompt.size) for r in b.requests]
    assert any(r.temperature > 0 for r in b.requests)


@pytest.fixture(scope="module")
def servers():
    """The tiny Llama in both packages over one paged engine each; the
    JAX engine compiles with the persistent compile cache off (a second
    identical paged program in one process is a jaxlib heap hazard)."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    yield (JaxEngine(jm, paged=True, **ENGINE_KW),
           PagedEngine(tm, device="cpu", **ENGINE_KW))
    jax.config.update("jax_enable_compilation_cache", True)


def _submit(srv):
    def go(r):
        return srv.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                          temperature=r.temperature, top_k=r.top_k,
                          seed=r.seed, tenant=r.tenant,
                          priority=r.priority)
    return go


def test_replay_through_server_equals_jax(servers):
    """One open-loop trace (shared prefixes, a sampled quarter) replayed
    through the port's ``Server`` gives the JAX ``Server``'s results,
    request for request; every request ends in a result."""
    cfg = dict(seed=0, horizon=24, base_rate=0.5, shared_fraction=0.5,
               shared_len=10, sampled_fraction=0.25, prompt_lo=4,
               prompt_hi=24, output_lo=2, output_hi=8, vocab_size=512)
    je, te = servers
    out = {}
    for name, eng, srv_cls, gen, cfg_cls, drive in (
            ("jax", je, JaxServer, jloadgen.generate_trace,
             jloadgen.TraceConfig, jloadgen.replay),
            ("port", te, Server, generate_trace, TraceConfig, replay)):
        eng.reset()
        srv = srv_cls(eng)
        trace = gen(cfg_cls(**cfg))
        ids = drive(trace, _submit(srv), lambda: srv.run_until_idle(
            max_ticks=1), lambda: bool(srv.scheduler.pending()
                                       or srv.engine.has_live()))
        assert len(ids) == len(trace)
        out[name] = {t: np.asarray(srv.results[i]).tolist()
                     for t, i in ids.items()}
    assert any(r.temperature > 0 for r in
               generate_trace(TraceConfig(**cfg)).requests)
    assert out["port"] == out["jax"]
