"""A sliding-window Llama served by the port's engines against the JAX
package's, on the CPU.

Beside ``tests/test_torch_port_dense.py``: ``llama_tiny`` with
``sliding_window=6`` (MHA) and with ``sliding_window=4`` and 2 kv heads
(GQA), each through the port's dense ``ContinuousBatchingEngine`` and
its ``PagedEngine`` under ``Server``, against the JAX dense and paged
``Server``s on the same weights. Six ragged greedy requests, every
prompt and most streams longer than the window, so the window masks
keys in the prefill, in the paged prefill chunks and in the decode
steps: the streams must be token-identical (and differ from the same
weights' streams without a window, so the window decides tokens). The
JAX paged engines run with the persistent compile cache off
(``tests/test_resilience.py`` ``_no_compile_cache``: two paged JAX
backends in one process)."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                      Scheduler, Server)

CONFIGS = {"window6": dict(sliding_window=6),
           "window4_gqa": dict(sliding_window=4, num_key_value_heads=2)}
DENSE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                prompt_buckets=(8, 16))
PAGED_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                prefill_chunk=8)


@pytest.fixture(scope="module")
def no_compile_cache():
    import jax
    jax.config.update("jax_enable_compilation_cache", False)
    yield
    jax.config.update("jax_enable_compilation_cache", True)


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            paddle.seed(0)
            kw = CONFIGS[name]
            jm = JaxLlama(jax_tiny_config(tensor_parallel=False, **kw))
            tm = LlamaForCausalLM(llama_tiny_config(**kw), device="cpu")
            tm.load_state_dict(params_from_jax(
                {n: np.asarray(p._value) for n, p in jm.named_parameters()}))
            built[name] = (jm, tm)
        return built[name]
    return get


def _requests():
    """Six ragged greedy requests of 6-15 new tokens; every prompt is
    longer than the windows."""
    rs = np.random.RandomState(7)
    lens, new = (7, 9, 12, 8, 14, 11), (6, 10, 15, 8, 12, 7)
    return [(rs.randint(0, 512, (L,)).astype(np.int32),
             dict(max_new_tokens=n)) for L, n in zip(lens, new)]


def _serve(server_cls, sched_cls, engine, reqs):
    srv = server_cls(engine, sched_cls())
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    return [np.asarray(res[r]) for r in rids]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_windowed_streams_match_jax(models, no_compile_cache, name, paged):
    jm, tm = models(name)
    kw = PAGED_KW if paged else DENSE_KW
    je = JaxEngine(jm, paged=paged, **kw)
    te = (PagedEngine(tm, device="cpu", **kw) if paged
          else ContinuousBatchingEngine(tm, device="cpu", **kw))
    reqs = _requests()
    want = _serve(JaxServer, JaxScheduler, je, reqs)
    got = _serve(Server, Scheduler, te, reqs)
    window = CONFIGS[name]["sliding_window"]
    assert all(len(p) + kw["max_new_tokens"] > 2 * window
               for p, kw in reqs)
    for (p, rkw), w, g in zip(reqs, want, got):
        assert len(g) == len(p) + rkw["max_new_tokens"]
        np.testing.assert_array_equal(g, w)
    if paged:
        te.manager.assert_consistent()
        return
    # the window decides tokens here: without it the streams differ
    full = LlamaForCausalLM(llama_tiny_config(**{
        **CONFIGS[name], "sliding_window": None}), device="cpu")
    full.load_state_dict(tm.state_dict())
    unwindowed = _serve(Server, Scheduler, ContinuousBatchingEngine(
        full, device="cpu", **kw), reqs)
    assert any(not np.array_equal(u, g) for u, g in zip(unwindowed, got))
