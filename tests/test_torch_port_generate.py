"""Port ``generate()`` and ``cached_attention`` against the JAX package.

On ``llama_tiny`` (2 layers, hidden 128) with the JAX model's weights
moved through numpy (``convert.params_from_jax``), the port's
``LlamaForCausalLM.generate`` must give the JAX ``generate()``'s tokens
exactly: greedy, GQA (kv heads 2) with a tied head, seeded sampling
(temperature, top-k, top-p, both, and ``do_sample`` defaulting hot),
eos padding with a sparse host poll, left-padded ragged prompts, the
scan path against the loop path, a sliding window, and beam search (3
beams, with and without a length penalty, ragged), with the same
refusals. Every branch of ``cached_attention`` that does not read
through a paged-decode kernel is held against JAX's on the same numpy
inputs, fp32, atol 1e-6: one position for the batch, per-row positions
with pad counts (a start past the cache clamped as
``dynamic_update_slice`` clamps it), windows of 3 and 8 over a dense
cache and over the paged arena's gathered route. The JAX side runs as
its tests run it on the CPU (``fused_rope`` through ``_rope_ref``). The
sampled draw takes one key over the whole (b, V) batch, which the port
checks against ``jax.random.categorical`` directly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.generation import cached_attention as jax_cached
from paddle_tpu.models.generation import sample_logits as jax_sample
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.models import (LlamaForCausalLM, cached_attention,
                                     llama_tiny_config, sample_logits)
from paddle_tpu_torch.models.llama import _rope_cache
from paddle_tpu_torch.utils.enforce import OutOfRangeError

CONFIGS = {"base": {},
           "gqa_tied": dict(num_key_value_heads=2, tie_word_embeddings=True),
           "window": dict(sliding_window=5)}


def _pair(kw):
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False, **kw))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(**kw), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(name):
        if name not in built:
            built[name] = _pair(CONFIGS[name])
        return built[name]
    return get


def _prompts(seed=0, b=2, s=7):
    return np.random.RandomState(seed).randint(0, 512, (b, s)) \
        .astype(np.int32)


def _both(models, name, prompts, **kw):
    jm, tm = models(name)
    want = jm.generate(paddle.to_tensor(prompts), **kw).numpy()
    got = tm.generate(prompts, **kw)
    return want, got.numpy()


GREEDY = {
    "greedy": ("base", dict(max_new_tokens=9)),
    "gqa_tied": ("gqa_tied", dict(max_new_tokens=9)),
    "window": ("window", dict(max_new_tokens=12)),
    "max_length": ("base", dict(max_length=13)),
    "loop": ("base", dict(max_new_tokens=9, use_scan_decode=False)),
}


@pytest.mark.parametrize("case", sorted(GREEDY))
def test_greedy_token_identical(models, case):
    name, kw = GREEDY[case]
    want, got = _both(models, name, _prompts(), **kw)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


SAMPLED = {
    "temperature": dict(do_sample=True, temperature=0.8, seed=3),
    "top_k": dict(do_sample=True, temperature=0.9, top_k=20, seed=5),
    "top_p": dict(do_sample=True, temperature=1.1, top_p=0.9, seed=7),
    "top_k_top_p": dict(do_sample=True, temperature=0.7, top_k=30,
                        top_p=0.8, seed=11),
    "hot_default": dict(do_sample=True, seed=2 ** 32 + 5),
}


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_sampled_token_identical(models, case):
    want, got = _both(models, "base", _prompts(1, b=3), max_new_tokens=8,
                      **SAMPLED[case])
    np.testing.assert_array_equal(got, want)


def test_sampled_loop_equals_scan(models):
    """The loop and the scan tail split the key in the same order."""
    _, tm = models("base")
    p = _prompts(2)
    kw = dict(max_new_tokens=8, do_sample=True, top_k=40, seed=9)
    scan = tm.generate(p, use_scan_decode=True, **kw)
    loop = tm.generate(p, use_scan_decode=False, **kw)
    torch.testing.assert_close(scan, loop, rtol=0, atol=0)
    want, _ = _both(models, "base", p, use_scan_decode=False, **kw)
    np.testing.assert_array_equal(scan.numpy(), want)


@pytest.mark.parametrize("every", [1, 3])
def test_eos_padding(models, every):
    """Rows that hit eos are padded with it; the early exit (polled
    every ``every`` steps) pads the remaining columns."""
    jm, tm = models("base")
    p = _prompts(3)
    plain = tm.generate(p, max_new_tokens=10).numpy()
    eos = int(plain[0, 7 + 2])
    want, got = _both(models, "base", p, max_new_tokens=10,
                      eos_token_id=eos, eos_check_every=every)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 7 + 2:] == eos).all()


RAGGED = np.array([[0, 0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1, 1],
                   [0, 1, 1, 1, 1, 1, 1]], np.int32)


@pytest.mark.parametrize("name", ["base", "gqa_tied"])
def test_ragged_attention_mask(models, name):
    """Left-padded rows give the tokens of their unpadded prompt."""
    p = _prompts(4, b=3)
    want, got = _both(models, name, p, max_new_tokens=8,
                      attention_mask=RAGGED)
    np.testing.assert_array_equal(got, want)
    _, tm = models(name)
    alone = tm.generate(p[:1, 3:], max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got[0, 3:], alone[0])


@pytest.mark.parametrize("kw", [
    dict(num_beams=3),
    dict(num_beams=3, length_penalty=1.0),
    dict(num_beams=3, length_penalty=0.6, attention_mask=RAGGED),
], ids=["plain", "length_penalty", "ragged"])
def test_beam_search(models, kw):
    p = _prompts(5, b=3)
    want, got = _both(models, "base", p, max_new_tokens=7, **kw)
    np.testing.assert_array_equal(got, want)


def test_beam_search_eos(models):
    """Finished beams continue only with eos, at no cost."""
    _, tm = models("base")
    p = _prompts(6, b=2)
    eos = int(tm.generate(p, max_new_tokens=6, num_beams=3).numpy()[0, 8])
    want, got = _both(models, "base", p, max_new_tokens=6, num_beams=3,
                      eos_token_id=eos)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw, err", [
    (dict(attention_mask=np.array([[1, 1, 0, 1, 1, 1, 1],
                                   [1] * 7])), "LEFT-padded"),
    (dict(attention_mask=np.array([[0] * 7, [1] * 7])), "all-pad row"),
    (dict(attention_mask=np.ones((2, 6))), "shape"),
    (dict(max_new_tokens=250), "max_position_embeddings"),
    (dict(use_scan_decode=True, eos_token_id=3), "early-exit"),
    (dict(num_beams=2, do_sample=True), "beam sampling"),
    (dict(num_beams=2, use_scan_decode=True), "per-token host"),
], ids=["right_pad", "all_pad", "mask_shape", "positions", "scan_eos",
        "beam_sample", "beam_scan"])
def test_refusals(models, kw, err):
    jm, tm = models("base")
    p = _prompts()
    with pytest.raises(ValueError, match=err):
        jm.generate(paddle.to_tensor(p), **kw)
    with pytest.raises(ValueError, match=err):
        tm.generate(p, **kw)


def test_position_error_type_and_nothing_to_generate(models):
    _, tm = models("base")
    p = _prompts()
    with pytest.raises(OutOfRangeError):
        tm.generate(p, max_new_tokens=250)
    np.testing.assert_array_equal(tm.generate(p, max_length=5).numpy(), p)


def test_decode_programs_cached_and_released(models):
    """One step program per (batch, cache length, dtype, padding,
    sampling configuration), reused by a call with the same key; a call
    with another key (another length, sampling) replaces it, so the
    model holds one step's cache; on the CPU nothing is captured."""
    _, tm = models("base")
    tm.release_decode_programs()
    p = _prompts(7)
    tm.generate(p, max_new_tokens=4)
    progs = tm.__dict__["_decode_fn_cache"]
    (first,) = progs.values()
    tm.generate(p[::-1].copy(), max_new_tokens=4)
    assert list(progs.values()) == [first]
    tm.generate(p, max_new_tokens=9)
    (longer,) = progs.values()
    assert longer is not first and longer.cache[0][0].shape[1] == \
        p.shape[1] + 9
    tm.generate(p, max_new_tokens=4, do_sample=True)
    assert len(progs) == 1 and longer not in progs.values()
    assert all(s.program.captures == 0 for s in progs.values())
    tm.release_decode_programs()
    assert "_decode_fn_cache" not in tm.__dict__


@pytest.mark.parametrize("kw", [dict(temperature=0.8),
                                dict(temperature=0.8, top_k=17),
                                dict(temperature=1.3, top_p=0.85),
                                dict(temperature=0.6, top_k=40, top_p=0.7)],
                         ids=["t", "k", "p", "kp"])
def test_sample_logits_one_key(kw):
    """One key over the (b, V) batch, as the JAX ``sample_logits``."""
    rs = np.random.RandomState(8)
    logits = (3 * rs.randn(6, 512)).astype(np.float32)
    for seed in (0, 7, 123):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_sample(jnp.asarray(logits), key, **kw))
        got = sample_logits(torch.from_numpy(logits),
                            torch.from_numpy(np.asarray(key).astype(
                                np.int64)), **kw)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# cached_attention, branch by branch
# ---------------------------------------------------------------------------

B, H, KVH, D, T = 3, 4, 2, 16, 24


def _tables():
    cos, sin = _rope_cache(llama_tiny_config(hidden_size=H * D,
                                             num_attention_heads=H,
                                             max_position_embeddings=64),
                           "cpu")
    return cos, sin


def _qkv(rs, b, s):
    return (rs.randn(b, s, H, D).astype(np.float32),
            rs.randn(b, s, KVH, D).astype(np.float32),
            rs.randn(b, s, KVH, D).astype(np.float32))


def _jax_and_port(q, k, v, ck, cv, pos, **kw):
    cos, sin = _tables()
    jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    jo, jk, jv = jax_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(pos), scale=D ** -0.5,
                            cos=jnp.asarray(cos.numpy()),
                            sin=jnp.asarray(sin.numpy()), **jkw)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
           for n, x in kw.items()}
    tpos = torch.from_numpy(np.asarray(pos)) \
        if isinstance(pos, np.ndarray) else pos
    to = cached_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), tck, tcv, tpos,
                          scale=D ** -0.5, cos=cos, sin=sin, **tkw)
    return (np.asarray(jo), np.asarray(jk), np.asarray(jv)), \
        (to.numpy(), tck.numpy(), tcv.numpy())


def _close(want, got, paged=False):
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for w, g in zip(want[1:], got[1:]):
        if paged:                        # junk lands in the trash block
            w, g = w[1:], g[1:]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


DENSE = {
    "scalar_prefill": dict(s=5, pos=0),
    "scalar_decode": dict(s=1, pos=9),
    "scalar_device_pos": dict(s=1, pos=np.array(9, np.int32)),
    "scalar_clamped": dict(s=4, pos=T - 2),
    "scalar_pad_prefill": dict(s=6, pos=0, pad=[0, 2, 5]),
    "scalar_pad_decode": dict(s=1, pos=np.array(11, np.int32),
                              pad=[0, 2, 5]),
    "rows_pad": dict(s=1, pos=[4, 11, 17], pad=[1, 3, 0]),
    "rows_no_pad": dict(s=1, pos=[0, 7, 12]),
    "rows_past_end": dict(s=1, pos=[T - 1, T + 2, 3], pad=[0, 1, 0]),
}


@pytest.mark.parametrize("window", [None, 3, 8])
@pytest.mark.parametrize("case", sorted(DENSE))
def test_cached_attention_dense(case, window):
    spec = DENSE[case]
    rs = np.random.RandomState(sorted(DENSE).index(case))
    q, k, v = _qkv(rs, B, spec["s"])
    ck = rs.randn(B, T, KVH, D).astype(np.float32)
    cv = rs.randn(B, T, KVH, D).astype(np.float32)
    pos = spec["pos"]
    if isinstance(pos, list):
        pos = np.array(pos, np.int32)
    kw = {} if window is None else dict(window=window)
    if "pad" in spec:
        kw["pad"] = np.array(spec["pad"], np.int32)
    want, got = _jax_and_port(q, k, v, ck, cv, pos, **kw)
    _close(want, got)


@pytest.mark.parametrize("window", [3, 8])
@pytest.mark.parametrize("s", [1, 5])
def test_cached_attention_paged_window(s, window):
    """A windowed paged step never takes the decode kernel: the gathered
    route with the window mask, for decode and for a chunk."""
    rs = np.random.RandomState(s * 10 + window)
    bs, mb = 4, 6
    nb = 1 + B * mb
    q, k, v = _qkv(rs, B, s)
    ka = rs.randn(nb, bs, KVH, D).astype(np.float32)
    va = rs.randn(nb, bs, KVH, D).astype(np.float32)
    table = (1 + np.arange(B * mb)).reshape(B, mb).astype(np.int32)
    pos = np.array([2, 9, 17], np.int32)
    want, got = _jax_and_port(q, k, v, ka, va, pos, window=window,
                              block_table=table)
    _close(want, got, paged=True)


def test_cached_attention_per_row_chunk_refused():
    """A per-row write of s > 1 positions (the speculative verify
    window) against JAX's scatter:
    rows with pad counts, the last one's window hanging two columns past
    the cache (JAX drops those updates; a clamp would move them back over
    valid entries): output and both caches within 1e-6, and every entry
    outside the windows unchanged."""
    rs = np.random.RandomState(0)
    q, k, v = _qkv(rs, B, 4)
    ck = rs.randn(B, T, KVH, D).astype(np.float32)
    cv = rs.randn(B, T, KVH, D).astype(np.float32)
    pos = np.array([1, 9, T - 2], np.int32)
    want, got = _jax_and_port(q, k, v, ck, cv, pos,
                              pad=np.array([1, 0, 3], np.int32))
    _close(want, got)
    written = np.zeros((B, T), bool)
    for r, p0 in enumerate(pos):
        written[r, p0:min(p0 + 4, T)] = True
    np.testing.assert_array_equal(got[1][~written], ck[~written])
    np.testing.assert_array_equal(got[2][~written], cv[~written])
