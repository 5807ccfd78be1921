"""Weight-only quantized serving in the port (``paddle_tpu_torch.nn.quant``,
``serving.quant``, ``ops.weight_only``) against the JAX package.

- ``quantize_array``'s codes and scales are bit-equal to JAX's after the
  layout map (JAX (in, out) -> the port's (out, in); int4 nibbles packed
  along the in axis), int8 and int4, per channel and grouped, odd
  in_features included; ``dequantize_array`` (a product, then a true
  division) is bit-equal to JAX's eager function; ``quant_step_bound``
  equal; ``weight_only_linear`` / ``llm_int8_linear`` within 1e-5 of
  JAX's (fp32 products summed in another order), with JAX's refusals;
- the quantized dense and paged engines' streams (greedy and one seeded
  sampled request) are token-identical to the JAX quantized engines',
  and bit-identical to a port fp32 engine whose weights are the
  dequantized codes (the "dequant twin"): on the CPU the weight-only
  product is ``dequantize_array`` + ``F.linear``, the twin's linear;
- int4 grouped, the int8 KV arena under int8 weights, the megakernel
  request under quant (every layer counted, none fused), the refusals
  and env routing of JAX's contract, the gauges, the bounds and the
  bytes a decode step reads.

The JAX paged engines of this file run with the persistent compile
cache off (the second-paged-backend heap hazard of jaxlib, see
``tests/test_torch_port_resilience.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import llama_tiny_config as jax_tiny_config
from paddle_tpu.nn import quant as jq
from paddle_tpu.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.serving import Scheduler as JaxScheduler
from paddle_tpu.serving import Server as JaxServer
from paddle_tpu.serving.quant import QuantConfig as JaxQuantConfig

from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.distributed.mesh import build_device_mesh
from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny_config
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving.tp import TPConfig
from paddle_tpu_torch.serving import (ContinuousBatchingEngine, PagedEngine,
                                      QuantConfig, Scheduler, Server,
                                      WeightOnlyLinear)

DENSE_KW = dict(num_slots=2, max_len=64, decode_block=4,
                prompt_buckets=(8, 16, 32))
PAGED_KW = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                prefill_chunk=8)
L = 2


@pytest.fixture(scope="module")
def setup():
    """The tiny Llama in both packages (weights through numpy) and a
    cache of engines built on first use, the JAX ones with the
    persistent compile cache off."""
    jax.config.update("jax_enable_compilation_cache", False)
    paddle.seed(0)
    jm = JaxLlama(jax_tiny_config(tensor_parallel=False))
    named = {n: np.asarray(p._value) for n, p in jm.named_parameters()}
    tm = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    tm.load_state_dict(params_from_jax(named))
    built = {}

    def engine(side, kind, quant=None, **kw):
        key = (side, kind, str(quant), tuple(sorted(kw.items())))
        if key not in built:
            base = DENSE_KW if kind == "dense" else PAGED_KW
            if side == "jax":
                q = quant if quant is None or isinstance(quant, str) \
                    else JaxQuantConfig(quant.weights, quant.group_size)
                built[key] = JaxEngine(jm, paged=kind == "paged", quant=q,
                                       **base, **kw)
            else:
                built[key] = ContinuousBatchingEngine(
                    tm, paged=kind == "paged", quant=quant, device="cpu",
                    **base, **kw)
        return built[key]
    yield jm, tm, engine
    jax.config.update("jax_enable_compilation_cache", True)


def _requests(seed=0, sampled=True):
    rs = np.random.RandomState(seed)
    out = []
    for i, (n, mn) in enumerate(zip((5, 9, 12, 7, 15), (7, 5, 8, 6, 9))):
        kw = dict(max_new_tokens=mn, arrival_step=i // 2)
        if sampled and i == 3:
            kw.update(temperature=0.8, top_k=20, seed=5)
        out.append((rs.randint(0, 512, (n,)).astype(np.int32), kw))
    return out


def _serve(engine, reqs, jax_side=False):
    engine.reset()
    srv = (JaxServer if jax_side else Server)(
        engine, (JaxScheduler if jax_side else Scheduler)())
    rids = [srv.submit(p, **kw) for p, kw in reqs]
    res = srv.run_until_idle()
    return [np.asarray(res[r]) for r in rids]


def _twin(tm, engine):
    """A port fp32 model whose serving linears hold the dequantized
    codes of ``engine``'s quantized copy, and its engine of the same
    kind and shape."""
    twin = LlamaForCausalLM(llama_tiny_config(), device="cpu")
    twin.load_state_dict(tm.state_dict())
    n = 0
    with torch.no_grad():
        for name, mod in engine.backend.model.named_modules():
            if isinstance(mod, WeightOnlyLinear):
                twin.get_submodule(name).weight.copy_(tq.dequantize_array(
                    mod.codes, mod.scales, mod.bits,
                    in_features=mod.in_features))
                n += 1
    assert n == 7 * L + 1           # the seven projections and the head
    return twin


def _twin_engine(tm, engine, kind, **kw):
    base = DENSE_KW if kind == "dense" else PAGED_KW
    return ContinuousBatchingEngine(_twin(tm, engine), paged=kind == "paged",
                                    device="cpu", **base, **kw)


# ---------------------------------------------------------------------------
# nn.quant against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,group,shape", [
    (8, -1, (64, 48)), (8, 16, (64, 48)), (4, -1, (64, 48)),
    (4, 16, (64, 48)), (8, -1, (129, 40)), (4, -1, (129, 40)),
    (4, 43, (129, 40))])
def test_quantize_and_dequantize_match_jax(bits, group, shape):
    """Codes and scales bit-equal after the layout map; the dequantized
    weight bit-equal to JAX's eager ``dequantize_array`` (its true
    division; XLA's jit multiplies by a rounded reciprocal instead, 1
    ulp off in places); the step bound equal."""
    w = np.random.RandomState(bits * 7 + group + shape[0]) \
        .randn(*shape).astype(np.float32)
    qj, sj = jq.quantize_array(jnp.asarray(w), bits, group)
    qt, st = tq.quantize_array(torch.from_numpy(w.T.copy()), bits, group)
    qj, sj = np.asarray(qj), np.asarray(sj)
    np.testing.assert_array_equal(qt.numpy(), qj.T)
    np.testing.assert_array_equal(st.numpy(), sj.T if group > 0 else sj)
    dj = np.asarray(jq.dequantize_array(jnp.asarray(qj), jnp.asarray(sj),
                                        bits, in_features=shape[0]))
    dt = tq.dequantize_array(qt, st, bits, in_features=shape[0])
    np.testing.assert_array_equal(dt.numpy(), dj.T)
    assert tq.quant_step_bound(st, bits) == jq.quant_step_bound(sj, bits)


def test_weight_only_linear_matches_jax():
    """The Tensor-API functions: ``weight_quantize`` / ``weight_dequantize``
    round trips (the int4 in_features tag), ``weight_only_linear`` with
    per-channel int8, grouped int4 and a bias, ``llm_int8_linear``; fp32
    products within 1e-5 of JAX's. The refusals are JAX's."""
    rs = np.random.RandomState(3)
    x = rs.randn(3, 5, 65).astype(np.float32)
    w = rs.randn(65, 24).astype(np.float32)
    b = rs.randn(24).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w.T.copy())
    for algo, dt in (("weight_only_int8", "int8"),
                     ("weight_only_int4", "int4")):
        qj, sj = jq.weight_quantize(paddle.to_tensor(w), algo=algo)
        qt, st = tq.weight_quantize(wt, algo=algo)
        np.testing.assert_array_equal(
            tq.weight_dequantize(qt, st, algo=algo).numpy(),
            jq.weight_dequantize(qj, sj, algo=algo).numpy().T)
        want = jq.weight_only_linear(paddle.to_tensor(x), qj,
                                     bias=paddle.to_tensor(b),
                                     weight_scale=sj, weight_dtype=dt)
        got = tq.weight_only_linear(xt, qt, bias=torch.from_numpy(b),
                                    weight_scale=st, weight_dtype=dt)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)
    w64 = rs.randn(64, 24).astype(np.float32)
    x64 = rs.randn(4, 64).astype(np.float32)
    qj, sj = jq.weight_quantize(paddle.to_tensor(w64),
                                algo="weight_only_int4", group_size=16)
    qt, st = tq.weight_quantize(torch.from_numpy(w64.T.copy()),
                                algo="weight_only_int4", group_size=16)
    np.testing.assert_allclose(
        tq.weight_only_linear(torch.from_numpy(x64), qt, weight_scale=st,
                              weight_dtype="int4", group_size=16).numpy(),
        jq.weight_only_linear(paddle.to_tensor(x64), qj, weight_scale=sj,
                              weight_dtype="int4",
                              group_size=16).numpy(), atol=1e-5, rtol=1e-5)
    q8j, s8j = jq.weight_quantize(paddle.to_tensor(w64))
    q8t, s8t = tq.weight_quantize(torch.from_numpy(w64.T.copy()))
    np.testing.assert_allclose(
        tq.llm_int8_linear(torch.from_numpy(x64), q8t,
                           weight_scale=s8t).numpy(),
        jq.llm_int8_linear(paddle.to_tensor(x64), q8j,
                           weight_scale=s8j).numpy(), atol=1e-5, rtol=1e-5)
    # refusals: a group that does not divide, per-channel scales under a
    # group request, a mismatched group count, an int4 width mismatch
    for mod, arr in ((jq, jnp.asarray(w)), (tq, wt)):
        with pytest.raises(ValueError, match="does not divide"):
            mod.quantize_array(arr, 8, 16)
    with pytest.raises(ValueError, match="per-channel"):
        tq.weight_only_linear(torch.from_numpy(x64), q8t, weight_scale=s8t,
                              group_size=16)
    with pytest.raises(ValueError, match="contradicts"):
        tq.weight_only_linear(torch.from_numpy(x64), qt, weight_scale=st,
                              weight_dtype="int4", group_size=32)
    with pytest.raises(ValueError, match="quantized from"):
        tq.weight_only_linear(torch.from_numpy(x64[:, :62]), qt,
                              weight_scale=st, weight_dtype="int4")
    with pytest.raises(ValueError, match="packed int4"):   # the tag lost
        tq.weight_only_linear(torch.from_numpy(x64[:, :60]), qt.clone(),
                              weight_scale=st, weight_dtype="int4")


# ---------------------------------------------------------------------------
# the quantized engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,quant", [
    ("dense", "int8"), ("dense", QuantConfig("int4", group_size=32)),
    ("paged", "int8"), ("paged", QuantConfig("int4", group_size=32))])
def test_quantized_streams_match_jax_and_twin(setup, kind, quant):
    """Greedy and seeded sampled streams token-identical to the JAX
    quantized engine's and bit-identical to the port's dequant twin; the
    backend's copy holds the codes, the caller's model its fp32
    weights."""
    jm, tm, engine = setup
    reqs = _requests()
    te = engine("port", kind, quant)
    got = _serve(te, reqs)
    want = _serve(engine("jax", kind, quant), reqs, jax_side=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    twin = _serve(_twin_engine(tm, te, kind), reqs)
    for g, w in zip(got, twin):
        np.testing.assert_array_equal(g, w)
    assert isinstance(te.backend.model.lm_head, WeightOnlyLinear)
    assert isinstance(tm.lm_head, torch.nn.Linear)
    assert te.decode_compile_count() == 0       # nothing captured on CPU


def test_paged_int8_arena_and_int8_weights(setup):
    """The bandwidth stack: int8 KV arena plus int8 weights, against the
    JAX engine and the twin (over the same int8 arena); both bounds are
    positive and the gauges carry them."""
    jm, tm, engine = setup
    reqs = _requests(1)
    te = engine("port", "paged", "int8", kv_int8=True)
    got = _serve(te, reqs)
    want = _serve(engine("jax", "paged", "int8", kv_int8=True), reqs,
                  jax_side=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    twin = _serve(_twin_engine(tm, te, "paged", kv_int8=True), reqs)
    for g, w in zip(got, twin):
        np.testing.assert_array_equal(g, w)
    metrics.enable()
    try:
        b = te.quant_error_bound()
        assert b["kv"] > 0 and b["weights"] == te.weight_error_bound() > 0
        assert metrics.REGISTRY.get(
            "pt_serving_weight_error_bound").value() == b["weights"]
        assert metrics.REGISTRY.get(
            "pt_serving_kv_error_bound").value() == b["kv"]
    finally:
        metrics.enable(False)


def test_weight_bound_and_bytes_match_jax(setup):
    """The build-time bound equals JAX's (the same scales); a decode
    step's weight bytes count codes and scales: JAX's figure, and far
    under the fp32 engine's."""
    jm, tm, engine = setup
    for quant in ("int8", QuantConfig("int4", group_size=32)):
        te, je = engine("port", "dense", quant), engine("jax", "dense",
                                                       quant)
        assert te.weight_error_bound() == pytest.approx(
            je.weight_error_bound(), rel=1e-7)
        te.reset()
        je.reset()
        assert te.decode_bytes_per_step()["weights"] == \
            je.decode_bytes_per_step()["weights"]
    fp32 = engine("port", "dense").decode_bytes_per_step()["weights"]
    assert engine("port", "dense", "int8").decode_bytes_per_step()[
        "weights"] < fp32 / 2
    assert engine("port", "dense").weight_error_bound() == 0.0


def test_megakernel_under_quant_counts_rewrites_only(setup):
    """megakernel=True on a quantized paged engine: every decode layer
    is routed (rewrites == L) and none reaches the fused call, which
    reads fp32 weights (kernel calls 0), as JAX pins the unfused body
    under quant; the stream is the quantized engine's."""
    jm, tm, engine = setup
    reqs = _requests(2, sampled=False)
    mk = engine("port", "paged", "int8", megakernel=True)
    got = _serve(mk, reqs)
    assert mk.megakernel_rewrites() == L and mk.megakernel_kernel_calls() == 0
    for g, w in zip(got, _serve(engine("port", "paged", "int8"), reqs)):
        np.testing.assert_array_equal(g, w)


def test_quant_routing_and_refusals(setup, monkeypatch):
    """JAX's contract: ``quant=`` beside an explicit backend is refused;
    ``PT_SERVING_QUANT_WEIGHTS`` / ``_GROUP`` route a model-built engine
    and never reroute an explicit backend; a direct ``PagedEngine(quant=)``
    is honoured; a group that divides no weight and bad configs raise."""
    jm, tm, engine = setup
    plain = engine("port", "dense")
    with pytest.raises(ValueError, match="explicit backend"):
        ContinuousBatchingEngine(backend=plain.backend, quant="int8")
    monkeypatch.setenv("PT_SERVING_QUANT_WEIGHTS", "int4")
    monkeypatch.setenv("PT_SERVING_QUANT_GROUP", "32")
    again = ContinuousBatchingEngine(backend=plain.backend)
    assert again.backend.quant_cfg is None and again.weight_error_bound() == 0
    env = ContinuousBatchingEngine(tm, device="cpu", **DENSE_KW)
    assert env.backend.quant_cfg == QuantConfig("int4", 32)
    monkeypatch.delenv("PT_SERVING_QUANT_WEIGHTS")
    direct = PagedEngine(tm, quant="int8", device="cpu", **PAGED_KW)
    assert direct.backend.quant_cfg == QuantConfig("int8")
    assert direct.weight_error_bound() > 0
    with pytest.raises(ValueError, match="does not divide"):
        ContinuousBatchingEngine(tm, quant=QuantConfig("int8", 48),
                                 device="cpu", **DENSE_KW)
    for bad in (dict(weights="int2"), dict(group_size=0)):
        with pytest.raises(ValueError):
            QuantConfig(**bad)
    with pytest.raises(ValueError, match="quant="):
        ContinuousBatchingEngine(tm, quant=8, device="cpu", **DENSE_KW)
    # tensor-parallel quant composes with the exact layout only (JAX's
    # refusal of the psum layout, whose row shards split the in axis)
    mesh = build_device_mesh({"mp": 2}, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError, match="mode='exact'"):
        ContinuousBatchingEngine(tm, tp=TPConfig(mode="psum", mesh=mesh),
                                 quant="int8", device="cpu", **DENSE_KW)
    sharded = ContinuousBatchingEngine(tm, tp=TPConfig(mesh=mesh),
                                       quant="int8", device="cpu",
                                       **DENSE_KW)
    assert sharded.tp_degree() == 2
    assert sharded.weight_error_bound() == ContinuousBatchingEngine(
        tm, quant="int8", device="cpu", **DENSE_KW).weight_error_bound()


def test_bound_gauges_registered_at_import():
    """Both bound gauges exist from import (the catalog is complete at
    zero), as in JAX."""
    import paddle_tpu_torch.serving  # noqa: F401
    names = set(metrics.REGISTRY.families())
    assert {"pt_serving_kv_error_bound",
            "pt_serving_weight_error_bound"} <= names


@pytest.mark.parametrize("qmax", [127.0, 7.0])
def test_kernel_division_is_the_true_division(qmax):
    """The weight-only kernel divides by qmax as ``y0 = a * r`` (r =
    fl(1 / qmax)), ``e = fma(-y0, qmax, a)``, ``fma(e, r, y0)``
    (``csrc/weight_only_gemm.cu`` ``dequant``): for every fp32
    significand (the sequence is scale-invariant, so every exponent) it
    equals the correctly rounded a / qmax that ``dequantize_array``
    computes. The remainder is exact in fp64; the last fma is emulated
    in extended precision, and no extended sum lands on an fp32
    midpoint, so its rounding to fp32 is the fma's."""
    if np.finfo(np.longdouble).nmant < 63:
        pytest.skip("needs x87 extended precision for the fma emulation")
    a = ((np.arange(2 ** 23, dtype=np.int64) + 2 ** 23).astype(np.float64)
         * 2.0 ** -23).astype(np.float32)
    b = np.float32(qmax)
    r = np.float32(1.0) / b
    y0 = a * r
    e64 = a.astype(np.float64) - y0.astype(np.float64) * np.float64(b)
    e = e64.astype(np.float32)
    np.testing.assert_array_equal(e.astype(np.float64), e64)
    s = e.astype(np.longdouble) * np.longdouble(r) + y0.astype(np.longdouble)
    got = s.astype(np.float32)
    up = np.nextafter(got, np.float32(np.inf)).astype(np.longdouble)
    dn = np.nextafter(got, np.float32(-np.inf)).astype(np.longdouble)
    g = got.astype(np.longdouble)
    assert not ((s == (g + up) / 2) | (s == (g + dn) / 2)).any()
    want = (a.astype(np.float64) / np.float64(b)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def _split3(w):
    """The weight-only kernel's split of fp32 values (``split3`` in
    ``csrc/weight_only_gemm.cu``): w1 = w truncated to its top 16 bits,
    r = w - w1, w2 = r truncated, w3 = r - w2, all in fp32."""
    mask = np.uint32(0xFFFF0000)
    w = np.asarray(w, np.float32)
    w1 = (w.view(np.uint32) & mask).view(np.float32)
    r = w - w1
    w2 = (r.view(np.uint32) & mask).view(np.float32)
    return w1, r, w2, r - w2


def _significands():
    """Every fp32 significand, as the values 1 + i 2^-23 in [1, 2)."""
    return ((np.arange(2 ** 23, dtype=np.int64) + 2 ** 23).astype(np.float64)
            * 2.0 ** -23).astype(np.float32)


@pytest.mark.parametrize("source", ["significands", "q127", "q7"])
def test_kernel_split_is_exact(source):
    """The weight-only kernel feeds the tensor cores each fp32 weight (and
    fp32 activation) as three bf16 pieces cut by truncation: over every
    fp32 significand (``significands``), and over every quotient the
    dequantization makes of one (a / qmax, ``q127`` and ``q7``), at
    exponents 2^-60, 1 and 2^60, every other one negated (truncation is
    symmetric in the sign), both subtractions are exact,
    each piece is a bf16 (its low 16 bits zero), the pieces sum back to w
    exactly, |w2 + w3| < 2^-7 |w| and |w3| < 2^-15 |w|: the bounds the
    kernel's error argument uses."""
    a = _significands()
    if source != "significands":
        a = a / np.float32(127.0 if source == "q127" else 7.0)
    sign = np.where(np.arange(a.size) % 2, -1, 1).astype(np.float32)
    for scale in (2.0 ** -60, 1.0, 2.0 ** 60):
        w = a * sign * np.float32(scale)
        w1, r, w2, w3 = _split3(w)
        w64 = w.astype(np.float64)
        np.testing.assert_array_equal(
            r.astype(np.float64), w64 - w1.astype(np.float64))
        np.testing.assert_array_equal(
            w3.astype(np.float64),
            r.astype(np.float64) - w2.astype(np.float64))
        for piece in (w1, w2, w3):
            assert not (piece.view(np.uint32) & 0xFFFF).any()
        np.testing.assert_array_equal(
            w1.astype(np.float64) + w2.astype(np.float64)
            + w3.astype(np.float64), w64)
        assert (np.abs(r.astype(np.float64))
                < 2.0 ** -7 * np.abs(w64)).all()
        assert (np.abs(w3.astype(np.float64))
                < 2.0 ** -15 * np.abs(w64)).all()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_kernel_kept_products_within_bound(bits, x_dtype):
    """The six products the kernel keeps (x3w1, x2w2, x1w3, x2w1, x1w2,
    x1w1 of the truncated pieces; bf16 x is one piece and keeps x w3, x
    w2, x w1), summed exactly in fp64, against the exact products: every
    term within (2^-21 + 2^-30) |x w| (the dropped x2w3 + x3w2 + x3w3),
    every bf16-x term exact, and a row's sum within that share of
    sum|x w|, which is inside the 2 K 2^-24 sum|x w| summation bound
    the kernel is held to on the card for K >= 9. Seeded codes, scales
    spanning six decades and activations, plus activations and weights
    whose significands are all ones (the largest pieces)."""
    rng = np.random.RandomState(bits)
    qmax = 2 ** (bits - 1) - 1
    k, n = 4096, 16
    q = rng.randint(-qmax - 1, qmax + 1, (n, k)).astype(np.float32)
    s = (10.0 ** rng.uniform(-3, 3, (n, 1))).astype(np.float32)
    w = (q * s) / np.float32(qmax)                  # dequantize_array's
    x = (rng.randn(8, k) * 10.0 ** rng.uniform(-2, 2, (8, 1))) \
        .astype(np.float32)
    ones = np.float32(2.0 - 2.0 ** -23)             # all-ones significand
    x[0] = ones * np.sign(x[0])
    w[0] = ones * np.where(w[0] < 0, -1, 1) * s[0]
    if x_dtype == "bfloat16":
        x = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    x1, _, x2, x3 = (p.astype(np.float64)[:, None, :] for p in _split3(x))
    w1, _, w2, w3 = (p.astype(np.float64)[None] for p in _split3(w))
    if x_dtype == "bfloat16":
        np.testing.assert_array_equal(x2, 0.0)
        kept = x1 * w3 + x1 * w2 + x1 * w1
    else:
        kept = x3 * w1 + x2 * w2 + x1 * w3 + x2 * w1 + x1 * w2 + x1 * w1
    exact = x.astype(np.float64)[:, None, :] * w.astype(np.float64)[None]
    mag = np.abs(exact)
    share = 2.0 ** -21 + 2.0 ** -30
    if x_dtype == "bfloat16":
        np.testing.assert_array_equal(kept, exact)
    assert (np.abs(kept - exact) <= share * mag).all()
    # rows: fp64 sums of K terms add at most K 2^-53 sum|x w| each
    err = np.abs(kept.sum(-1) - exact.sum(-1))
    assert (err <= (share + 2 * k * 2.0 ** -53) * mag.sum(-1)).all()
    assert share <= 2 * 9 * 2.0 ** -24 - 9 * 2.0 ** -24


@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_kernel_int4_nibble_decode_is_exact(j):
    """The kernel decodes the j-th nibble of a half word with one masked
    or, f = 2^23 + (q + 8) 16^j, and one subtraction, which gives q 16^j
    exactly; it then divides by 7 16^j with fl(1/7) 16^-j. Every step is
    the unscaled one times a power of two, so the weight is the same
    bits as fl(fl(q s) / 7): the decode over all 16 codes; the
    reciprocal's scaling; over every fp32 significand a (a' = a 16^j),
    the first product's bits, and the remainder of the first fma, exact
    in fp64, 16^j times the unscaled one and an fp32 (so the last fma
    sees e' r' = e r exactly, and rounds the same sum)."""
    scale = np.float32(16.0 ** j)
    off = np.float32(2.0 ** 23 + 8 * 16.0 ** j)
    u = np.arange(16, dtype=np.uint32)
    f = ((u << np.uint32(4 * j)) | np.uint32(0x4B000000)).view(np.float32)
    np.testing.assert_array_equal(
        (f - off).astype(np.float64),
        (u.astype(np.float64) - 8) * 16.0 ** j)
    r = np.float32(1.0) / np.float32(7.0)
    r_j = r * np.float32(16.0 ** -j)
    assert np.float64(r_j) * 16.0 ** j == np.float64(r)
    qm_j = np.float32(7.0) * scale
    a = _significands()
    a_j = a * scale
    y0 = a * r
    np.testing.assert_array_equal(a_j * r_j, y0)
    e = a.astype(np.float64) - y0.astype(np.float64) * 7.0
    e_j = a_j.astype(np.float64) - y0.astype(np.float64) \
        * np.float64(qm_j)
    np.testing.assert_array_equal(e_j, e * 16.0 ** j)
    np.testing.assert_array_equal(e_j.astype(np.float32).astype(np.float64),
                                  e_j)
