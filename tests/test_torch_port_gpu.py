"""The port's CUDA kernels and its serving path on a GPU.

Every test here needs a CUDA device (``cuda`` marker) and skips without
one. The file imports neither jax nor paddle_tpu, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_port_gpu.py

Kernels are held against their plain PyTorch versions on the same CUDA
inputs — the serving kernels (RMSNorm, paged-attention decode over the
fp32/bf16 and the int8 arenas; the RMSNorm forward at 1-64 rows, also
inside a CUDA graph, and at rows past its registers) and the training
kernels (flash attention forward/dq/dkv, RoPE, AdamW, and the RMSNorm
backward with and without a residual, long rows included), the
ERNIE-MoE kernels (softmax cross-entropy forward and backward, the MoE
row gather, AdamW over bf16 moments), and the training kernels at the
shapes of the mp and pp runs (one rank's heads; one microbatch, one
stage's stacks); the tiny Llama on the GPU against
the same model on the CPU, serving (both arenas) and training, and the
tiny ERNIE-MoE training step likewise; threefry on the card against the
CPU."""
import contextlib
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import ops
from paddle_tpu_torch.models import (LlamaForCausalLM,
                                     decode_step_logprobs,
                                     llama_tiny_config)
from paddle_tpu_torch.ops.fused import rms_norm, rms_norm_reference
from paddle_tpu_torch.ops.paged_attention import (
    paged_attention_decode, paged_attention_decode_int8, quantize_kv)
from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "a GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(dev, dtype, b=4, h=32, kvh=8, d=128, bs=16, mb=8):
    g = torch.Generator(device=dev).manual_seed(kvh)
    nb = 1 + b * mb
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    ka = torch.randn(nb, bs, kvh, d, generator=g, device=dev).to(dtype)
    va = torch.randn(nb, bs, kvh, d, generator=g, device=dev).to(dtype)
    lengths = torch.tensor([1, bs + 3, mb * bs, 5][:b], dtype=torch.int32)
    table = torch.zeros(b, mb, dtype=torch.int32)
    perm = (torch.randperm(nb - 1) + 1).tolist()
    for r in range(b - 1):          # the last row is dead: all trash
        n = -(-int(lengths[r]) // bs)
        table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return q, ka, va, table.to(dev), lengths.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_matches_plain(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(32, 4096, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    before = rms_norm.launches
    got = rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 \
        else (1e-6, 2.0 ** -7)
    torch.testing.assert_close(got.float(),
                               rms_norm_reference(x, w, 1e-5).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("kvh", [32, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(dev, kvh, dtype):
    q, ka, va, table, lengths = _paged_case(dev, dtype, kvh=kvh)
    scale = 1 / math.sqrt(128)
    before = paged_attention_decode.launches
    got = paged_attention_decode(q, ka, va, table, lengths, scale=scale)
    torch.cuda.synchronize()
    assert paged_attention_decode.launches == before + 1
    with ops.plain_versions():
        want = paged_attention_decode(q, ka, va, table, lengths,
                                      scale=scale)
    assert paged_attention_decode.launches == before + 1
    # fp32: online-softmax reassociation; bf16: the plain version rounds
    # the probabilities to bf16 before the PV product (the JAX order)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


def _walk_plan(q, int8, kvh, mb):
    """The (ce, nc) split of the standalone paged-decode launch for q on
    this card."""
    from paddle_tpu_torch.ops.paged_attention import (
        _resident_ctas, heads_per_item, walk_plan)
    b, h, d = q.shape
    g = h // kvh
    items = b * kvh * -(-g // heads_per_item(g))
    return walk_plan(items, mb, _resident_ctas(q, int8, g, d))


@pytest.mark.parametrize("arena", ["float32", "bfloat16", "int8"])
def test_paged_decode_split_walk_chunk_boundaries(dev, arena):
    """GQA (8 kv heads of 32) with lengths on the split walk's chunk
    boundaries: a chunk's last row, the next chunk's first, a whole
    table, one entry past a chunk, a length past the table and length
    1; the kernel against its plain version (tolerances of the main
    tests) and two launches bit-identical (fixed merge order)."""
    b, h, kvh, d, bs, mb = 8, 32, 8, 128, 16, 64
    dtype = torch.float32 if arena == "int8" else getattr(torch, arena)
    ce, nc = _walk_plan(torch.empty(b, h, d, dtype=dtype, device=dev),
                        arena == "int8", kvh, mb)
    assert nc > 1
    span = ce * bs
    lengths = [span, span + 1, mb * bs, 2 * span - 1, mb * bs + 40, 1,
               span - 1, bs * (ce + 1)]
    g = torch.Generator(device=dev).manual_seed(7)
    nb = 1 + b * mb
    table = torch.zeros(b, mb, dtype=torch.int32)
    perm = (torch.randperm(nb - 1, generator=torch.Generator()
                           .manual_seed(7)) + 1).tolist()
    for r, L in enumerate(lengths):
        n = min(-(-L // bs), mb)
        table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    table = table.to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = 1 / math.sqrt(d)
    if arena == "int8":
        q = torch.randn(b, h, d, generator=g, device=dev)
        kc, ks = quantize_kv(torch.randn(nb, bs, kvh, d, generator=g,
                                         device=dev))
        vc, vs = quantize_kv(torch.randn(nb, bs, kvh, d, generator=g,
                                         device=dev))
        fn, args, tol = paged_attention_decode_int8, \
            (q, kc, vc, ks, vs, table, lens), 1e-5
    else:
        q, ka, va = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, h, d), (nb, bs, kvh, d),
                                   (nb, bs, kvh, d)))
        fn, args = paged_attention_decode, (q, ka, va, table, lens)
        tol = 1e-5 if dtype == torch.float32 else 3e-2
    before = fn.launches
    got = fn(*args, scale=scale)
    again = fn(*args, scale=scale)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(got, again)
    with ops.plain_versions():
        want = fn(*args, scale=scale)
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_kernels_refuse_unsupported_inputs(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        rms_norm(x, torch.ones(64, device=dev, dtype=torch.float16), 1e-6)
    with pytest.raises(ValueError):
        rms_norm(torch.randn(4, 6, device=dev), torch.ones(6, device=dev),
                 1e-6)
    q, ka, va, table, lengths = _paged_case(dev, torch.float32)
    with pytest.raises(ValueError):
        paged_attention_decode(q.transpose(0, 1).contiguous()
                               .transpose(0, 1), ka, va, table, lengths,
                               scale=1.0)
    with pytest.raises(TypeError):
        paged_attention_decode(q, ka, va, table.long(), lengths, scale=1.0)
    with pytest.raises(ValueError):     # a row of 24 lanes: no power of 2
        paged_attention_decode(q[..., :96].contiguous(),
                               ka[..., :96].contiguous(),
                               va[..., :96].contiguous(), table, lengths,
                               scale=1.0)


def _int8_case(dev, b=4, h=32, kvh=8, d=128, bs=16, mb=8, full=False):
    """Quantized random arenas; lengths 1, a partial block, a full table
    and a dead row on the trash block (or every slot full)."""
    g = torch.Generator(device=dev).manual_seed(100 + kvh)
    nb = 1 + b * mb
    q = torch.randn(b, h, d, generator=g, device=dev)
    kc, ks = quantize_kv(torch.randn(nb, bs, kvh, d, generator=g,
                                     device=dev))
    vc, vs = quantize_kv(torch.randn(nb, bs, kvh, d, generator=g,
                                     device=dev))
    lengths = [mb * bs] * b if full else [1, bs + 3, mb * bs, 5][:b]
    table = torch.zeros(b, mb, dtype=torch.int32)
    perm = (torch.randperm(nb - 1) + 1).tolist()
    for r in range(b if full else b - 1):
        n = -(-lengths[r] // bs)
        table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return (q, kc, vc, ks, vs, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("full", [False, True], ids=["ragged", "full"])
@pytest.mark.parametrize("kvh", [32, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_int8_kernel_matches_plain(dev, kvh, dtype, full):
    """fp32 q: 1e-5 (the online softmax in another order; the JAX suite
    pins the same). bf16 q: both sides compute in fp32 and round the
    output once, so each element within 1e-5 plus one bf16 ulp of its
    magnitude (2^-7 relative)."""
    q, *rest = _int8_case(dev, kvh=kvh, full=full)
    q = q.to(dtype)
    before = paged_attention_decode_int8.launches
    got = paged_attention_decode_int8(q, *rest, scale=1 / math.sqrt(128))
    torch.cuda.synchronize()
    assert paged_attention_decode_int8.launches == before + 1
    with ops.plain_versions():
        want = paged_attention_decode_int8(q, *rest,
                                           scale=1 / math.sqrt(128))
    assert paged_attention_decode_int8.launches == before + 1
    assert got.dtype == dtype
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
    else:
        tol = 1e-5 + 2.0 ** -7 * torch.maximum(got.float().abs(),
                                               want.float().abs())
        assert bool((diff <= tol).all())


@pytest.mark.parametrize("h,kvh,d,bs", [(4, 4, 32, 8), (8, 1, 16, 4),
                                        (16, 2, 64, 16), (24, 4, 128, 16)],
                         ids=["tiny", "d16-g8", "d64-g8", "g6"])
@pytest.mark.parametrize("arena", ["float32", "bfloat16", "int8"])
def test_paged_decode_kernel_lane_layouts(dev, h, kvh, d, bs, arena):
    """The lane layouts beyond the serving shapes: a row of d / V lanes
    (V = 4 fp32, 8 bf16, 16 int8 elements per 16-byte load) from 1 to
    16 lanes, blocks narrower than one warp-wide load (rows past the
    block are not read), and query groups of 6 and 8 heads split over
    CTAs of up to 4. Tolerances as in the main-shape tests."""
    if arena == "int8":
        q, *rest = _int8_case(dev, h=h, kvh=kvh, d=d, bs=bs)
        fn = paged_attention_decode_int8
    else:
        dtype = getattr(torch, arena)
        q, *rest = _paged_case(dev, dtype, h=h, kvh=kvh, d=d, bs=bs)
        fn = paged_attention_decode
    got = fn(q, *rest, scale=1 / math.sqrt(d))
    with ops.plain_versions():
        want = fn(q, *rest, scale=1 / math.sqrt(d))
    tol = 3e-2 if arena == "bfloat16" else 1e-5
    assert float((got.float() - want.float()).abs().max()) <= tol


def test_int8_kernel_refuses_unsupported_inputs(dev):
    q, kc, vc, ks, vs, table, lengths = _int8_case(dev)
    scale = 1.0
    with pytest.raises(TypeError):           # fp16 q
        paged_attention_decode_int8(q.half(), kc, vc, ks, vs, table,
                                    lengths, scale=scale)
    with pytest.raises(TypeError):           # codes not int8
        paged_attention_decode_int8(q, kc.float(), vc.float(), ks, vs,
                                    table, lengths, scale=scale)
    with pytest.raises(TypeError):           # bf16 scales
        paged_attention_decode_int8(q, kc, vc, ks.bfloat16(), vs, table,
                                    lengths, scale=scale)
    with pytest.raises(TypeError):           # int64 table
        paged_attention_decode_int8(q, kc, vc, ks, vs, table.long(),
                                    lengths, scale=scale)
    with pytest.raises(ValueError):          # scales of another shape
        paged_attention_decode_int8(q, kc, vc, ks[:, :8], vs[:, :8], table,
                                    lengths, scale=scale)
    with pytest.raises(ValueError):          # non-contiguous q
        paged_attention_decode_int8(q.transpose(0, 1).contiguous()
                                    .transpose(0, 1), kc, vc, ks, vs,
                                    table, lengths, scale=scale)
    with pytest.raises(ValueError):          # misaligned code arena
        flat = torch.zeros(kc.numel() + 16, dtype=torch.int8, device=dev)
        off = flat[1:1 + kc.numel()].view(kc.shape)
        paged_attention_decode_int8(q, off, vc, ks, vs, table, lengths,
                                    scale=scale)
    with pytest.raises(ValueError):          # head_dim not a multiple of 16
        paged_attention_decode_int8(q[..., :120].contiguous(),
                                    kc[..., :120].contiguous(),
                                    vc[..., :120].contiguous(), ks, vs,
                                    table, lengths, scale=scale)


def test_threefry_on_cuda_matches_cpu(dev):
    from paddle_tpu_torch import random as prng
    keys = prng.split(prng.prng_key(2 ** 31 - 1), 32)
    for f in (lambda k: prng.split(k), lambda k: prng.random_bits(k, 4099),
              lambda k: prng.uniform(k, 4099)):
        torch.testing.assert_close(f(keys.to(dev)).cpu(), f(keys),
                                   rtol=0, atol=0)
    logits = torch.randn(32, 32000)
    torch.testing.assert_close(
        prng.categorical(keys.to(dev), logits.to(dev)).cpu(),
        prng.categorical(keys, logits), rtol=0, atol=0)


def _tiny_pair(dev):
    cfg = llama_tiny_config()
    cpu = LlamaForCausalLM(cfg, device="cpu", seed=3)
    gpu = LlamaForCausalLM(cfg, device=dev, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def test_decode_step_gpu_matches_cpu(dev):
    cpu, gpu = _tiny_pair(dev)
    out = []
    for m in (cpu, gpu):
        d = m.device
        cache = m.init_paged_kv_cache(8, 8)
        ids = torch.arange(1, 9, dtype=torch.int32, device=d)[None]
        table = torch.tensor([[3, 0, 0, 0]], dtype=torch.int32, device=d)
        decode_step_logprobs(m, ids, cache,
                             torch.tensor([0], dtype=torch.int32, device=d),
                             table, last_index=7)
        out.append(decode_step_logprobs(
            m, torch.tensor([[9]], dtype=torch.int32, device=d), cache,
            torch.tensor([8], dtype=torch.int32, device=d),
            torch.tensor([[3, 5, 0, 0]], dtype=torch.int32, device=d)))
    np.testing.assert_allclose(out[1].cpu().numpy(), out[0].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_server_on_gpu_goes_through_kernels(dev, kv_int8):
    """Greedy and one seeded sampled stream: the card's streams equal
    the CPU's (sampling draws the same threefry bits on both)."""
    cpu, gpu = _tiny_pair(dev)
    rs = np.random.RandomState(0)
    reqs = [(rs.randint(0, 512, (L,)).astype(np.int32), n)
            for L, n in ((5, 6), (9, 4), (12, 7), (5, 5), (9, 6))]
    results = []
    for m, device in ((cpu, "cpu"), (gpu, dev)):
        eng = PagedEngine(m, num_slots=2, max_len=64, decode_block=4,
                          block_size=8, prefill_chunk=8, kv_int8=kv_int8,
                          device=device)
        srv = Server(eng, Scheduler(prefill_token_budget=8))
        rids = [srv.submit(p, max_new_tokens=n, **(
            dict(temperature=0.8, top_k=20, seed=7) if i == 2 else {}))
            for i, (p, n) in enumerate(reqs)]
        ops.reset_launch_counts()
        res = srv.run_until_idle()
        results.append([res[r] for r in rids])
        eng.manager.assert_consistent()
    counts = ops.launch_counts()
    L = gpu.config.num_hidden_layers
    pa = "paged_attention_decode_int8" if kv_int8 \
        else "paged_attention_decode"
    other = "paged_attention_decode" if kv_int8 \
        else "paged_attention_decode_int8"
    assert counts[pa] == L * eng.steps > 0 and counts[other] == 0
    assert counts["rms_norm"] == \
        (2 * L + 1) * (eng.steps + eng.prefill_chunks)
    for a, b in zip(*results):
        np.testing.assert_array_equal(b, a)


# -- training-step kernels ---------------------------------------------------

FLASH_GPU_CASES = {
    # name: (b, sq, sk, h, hk, d, causal, window)
    "causal": (2, 256, 256, 8, 8, 128, True, None),
    "gqa_ragged": (2, 200, 200, 8, 2, 64, True, None),
    "window": (1, 256, 256, 4, 4, 128, True, 100),
    "cross": (2, 128, 192, 4, 4, 64, False, None),
    "ernie_d64": (2, 1024, 1024, 12, 12, 64, True, None),
    # the bf16 kernels' edges: a length that is not a multiple of their
    # 128-row tiles, head dims padded to 64 and 128, GQA with rep 4 and a
    # window across two 128-key tiles, a long causal row
    "ragged300": (2, 300, 300, 4, 4, 128, True, None),
    "d32": (2, 256, 256, 4, 4, 32, True, None),
    "d96": (2, 256, 256, 4, 4, 96, True, None),
    "gqa4_window": (1, 512, 512, 8, 2, 128, True, 200),
    "long_causal": (1, 4096, 4096, 4, 4, 128, True, None),
    # bench.py's headline configuration (tools/port_train_bench.py)
    "headline": (8, 2048, 2048, 16, 16, 128, True, None),
    # one rank of its tensor-parallel run at mp 2 (chip_smoke.py phase
    # 18): half the heads, the batch of 4
    "headline_mp2": (4, 2048, 2048, 8, 8, 128, True, None),
    # one microbatch of its pipeline-parallel run (chip_smoke.py phase
    # 19): a sequence a microbatch
    "headline_pp_microbatch": (1, 2048, 2048, 16, 16, 128, True, None),
    # the blocks of its sequence-parallel run (chip_smoke.py phase 20):
    # a rank's diagonal block (causal) and a past one (not), the prefix
    # rank 3 of a sep 4 group attends to (4096 queries, 12288 keys), and
    # Ulysses' whole sequence over half the heads; a non-causal block
    # whose key count is a multiple of neither tile
    "sep_diagonal": (1, 4096, 4096, 16, 16, 128, True, None),
    "sep_past_block": (1, 4096, 4096, 16, 16, 128, False, None),
    "sep_prefix": (1, 4096, 12288, 16, 16, 128, False, None),
    "sep_ulysses": (1, 8192, 8192, 8, 8, 128, True, None),
    "sep_ragged_block": (1, 300, 1000, 4, 2, 128, False, None),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(FLASH_GPU_CASES))
def test_flash_kernels_match_plain(dev, name, dtype, monkeypatch):
    """Forward (o, lse) and both backward kernels against their plain
    versions on the same inputs (the backward pair is fed the kernel's o
    and lse on both sides). fp32: o/lse 2e-5, grads 1e-4 (reassociated
    sums). bf16, per element: the kernels round the probabilities to
    bf16 before o = p·v and dv = pᵀ·do and ds before dq and dk, the
    plain forward rounds the normalised probabilities (the JAX order)
    and the plain backward only its outputs, so each element within
    half a bf16 ulp of each side plus 7 standard deviations of that
    operand rounding (``bf16_tolerance``); lse is fp32 on both sides
    (1e-4)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    b, sq, sk, h, hk, d, causal, window = FLASH_GPU_CASES[name]
    g = torch.Generator(device=dev).manual_seed(sq + h)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, k, v = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)
    do = rnd(b, sq, h, d)
    kw = dict(is_causal=causal, scale=1 / math.sqrt(d), window=window)
    ops.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = ((do * o).float().sum(-1).transpose(1, 2)
             - 0.1 * torch.ones(b, h, sq, device=dev)).contiguous()
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    assert ops.launch_counts()["flash_attention_bwd_dq"] == 1
    assert ops.launch_counts()["flash_attention_bwd_dkv"] == 1
    with ops.plain_versions():
        po, plse = fa.flash_attention_fwd(q, k, v, **kw)
        pq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        pk, pv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    assert ops.launch_counts()["flash_attention_fwd"] == 1
    fp32 = dtype == torch.float32
    assert float((lse - plse).abs().max()) <= (2e-5 if fp32 else 1e-4)
    pairs = ((o, po), (dq, pq), (dk, pk), (dv, pv))
    if fp32:
        for i, (got, want) in enumerate(pairs):
            err = float((got - want).abs().max())
            assert err <= (2e-5 if i == 0 else 1e-4), err
        return
    spread = fa.bf16_rounding_spread(q, k, v, do, lse, delta, **kw)
    for i, ((got, want), sp) in enumerate(zip(pairs, spread)):
        tol = fa.bf16_tolerance(got, want, sp, 2 if i == 0 else 1)
        diff = (got.float() - want.float()).abs()
        assert bool((diff <= tol).all()), float((diff / tol).max())


@pytest.mark.parametrize("name", ["gqa4_window", "ernie_d64", "d96"])
def test_flash_kernels_are_deterministic(dev, name):
    """Two calls of each bf16 kernel on the same inputs give bit-identical
    outputs: dk and dv are summed over the group in registers, with no
    atomics, so the order of every sum is fixed."""
    from paddle_tpu_torch.ops import flash_attention as fa
    b, sq, sk, h, hk, d, causal, window = FLASH_GPU_CASES[name]
    g = torch.Generator(device=dev).manual_seed(sq + d)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)

    q, k, v = rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d)
    do = rnd(b, sq, h, d)
    kw = dict(is_causal=causal, scale=1 / math.sqrt(d), window=window)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do * o).float().sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        runs.append((o, lse, dq, dk, dv))
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


def test_flash_block_gradients_on_gpu(dev):
    """The autograd Function on the card (kernels) against the same
    Function under plain_versions, with an lse cotangent."""
    from paddle_tpu_torch.ops.flash_attention import flash_block
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(2, 128, 4, 64, generator=g, device=dev)
               for _ in range(3))
    wo = torch.randn(2, 128, 4, 64, generator=g, device=dev)
    wl = torch.randn(2, 4, 128, generator=g, device=dev)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if plain:
            with ops.plain_versions():
                o, lse = flash_block(*leaves, is_causal=True)
        else:
            o, lse = flash_block(*leaves, is_causal=True)
        ((o * wo).sum() + (lse * wl).sum()).backward()
        grads.append([t.grad for t in leaves])
    for a, b_ in zip(*grads):
        assert float((a - b_).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_matches_plain(dev, dtype):
    """Equal heads (one launch) and GQA (two), forward and the sin-negated
    backward, with random tables (unequal halves). fp32 1e-6; bf16: the
    kernel rounds once from fp32 where the plain version rounds each
    product, within one bf16 ulp of the largest term."""
    from paddle_tpu_torch.ops.fused import _rope_pair
    g = torch.Generator(device=dev).manual_seed(6)
    s, d = 64, 128
    cos = torch.randn(s, d, generator=g, device=dev).to(dtype)
    sin = torch.randn(s, d, generator=g, device=dev).to(dtype)
    for hk, launches in ((8, 1), (2, 2)):
        q = torch.randn(2, s, 8, d, generator=g, device=dev).to(dtype)
        k = torch.randn(2, s, hk, d, generator=g, device=dev).to(dtype)
        for sign in (1.0, -1.0):
            ops.reset_launch_counts()
            got = _rope_pair(q, k, cos, sin, sign)
            torch.cuda.synchronize()
            assert ops.launch_counts()["rope"] == launches
            with ops.plain_versions():
                want = _rope_pair(q, k, cos, sin, sign)
            for a, b_ in zip(got, want):
                err = float((a.float() - b_.float()).abs().max())
                tol = 1e-5 if dtype == torch.float32 else \
                    2.0 ** -7 * 2 * float(q.float().abs().max()) \
                    * float(cos.float().abs().max())
                assert err <= tol, err


def test_rope_kernel_at_the_mp2_headline_shape(dev):
    """RoPE on one mp rank's q and k of the headline run at mp 2 (4,
    2048, 8, 128) bf16 with the model's tables: one launch, forward and
    backward, within one bf16 ulp of the largest term of the plain
    version."""
    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops.fused import _rope_pair
    from tools.port_train_bench import headline_big_config
    cos, sin = (t[:2048].bfloat16() for t in
                _rope_cache(headline_big_config(), dev))
    g = torch.Generator(device=dev).manual_seed(18)
    q, k = (torch.randn(4, 2048, 8, 128, generator=g, device=dev)
            .bfloat16() for _ in range(2))
    tol = 2.0 ** -7 * 2 * float(max(q.float().abs().max(),
                                    k.float().abs().max()))
    for sign in (1.0, -1.0):
        ops.reset_launch_counts()
        got = _rope_pair(q, k, cos, sin, sign)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rope"] == 1
        with ops.plain_versions():
            want = _rope_pair(q, k, cos, sin, sign)
        for a, b_ in zip(got, want):
            assert float((a.float() - b_.float()).abs().max()) <= tol


def test_rope_kernel_at_the_pp_microbatch_shape(dev):
    """RoPE on one microbatch of the headline run at pp 2 (1, 2048, 16,
    128) bf16 with the model's tables: one launch, forward and backward,
    within one bf16 ulp of the largest term of the plain version."""
    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops.fused import _rope_pair
    from tools.port_train_bench import headline_big_config
    cos, sin = (t[:2048].bfloat16() for t in
                _rope_cache(headline_big_config(), dev))
    g = torch.Generator(device=dev).manual_seed(19)
    q, k = (torch.randn(1, 2048, 16, 128, generator=g, device=dev)
            .bfloat16() for _ in range(2))
    tol = 2.0 ** -7 * 2 * float(max(q.float().abs().max(),
                                    k.float().abs().max()))
    for sign in (1.0, -1.0):
        ops.reset_launch_counts()
        got = _rope_pair(q, k, cos, sin, sign)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rope"] == 1
        with ops.plain_versions():
            want = _rope_pair(q, k, cos, sin, sign)
        for a, b_ in zip(got, want):
            assert float((a.float() - b_.float()).abs().max()) <= tol


@pytest.mark.parametrize("shape", [(8, 5632, 2048), (8, 2048, 5632)])
def test_adamw_bf16_moments_on_a_pp_stage_stack(dev, shape):
    """AdamW over bf16 p, g, m and v on one stage's MLP stacks of the
    headline at pp 2 (8 of its 16 layers): one launch, every element
    within one bf16 ulp of the plain version, as the whole stack's test
    holds them."""
    from paddle_tpu_torch.ops.fused import fused_adamw
    g = torch.Generator(device=dev).manual_seed(22)
    p = (0.02 * torch.randn(shape, generator=g, device=dev)).bfloat16()
    grad = torch.randn(shape, generator=g, device=dev).bfloat16()
    m = (0.1 * torch.randn(shape, generator=g, device=dev)).bfloat16()
    v = (0.01 * torch.rand(shape, generator=g, device=dev)).bfloat16()
    hp = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=2)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ops.reset_launch_counts()
    fused_adamw(kp, grad, km, kv, **hp)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adamw"] == 1
    with ops.plain_versions():
        fused_adamw(p, grad, m, v, **hp)
    for got, want in ((kp, p), (km, m), (kv, v)):
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2.0 ** -7,
            atol=2.0 ** -23 * float(want.float().abs().max()))


@pytest.mark.parametrize("pdtype,gdtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_adamw_kernel_matches_plain(dev, pdtype, gdtype):
    """In place, at a size with a tail (n % 8 != 0), step 7. m and v
    within two fp32 ulps of their largest entry: the kernel's contracted
    FMA rounds b1*m + (1-b1)*g once where the plain version rounds each
    op, which moves a cancelling sum by its terms' ulp. p to 1e-8 (fp32)
    or one bf16 ulp (plus one fp32 ulp of the largest entry, for p near
    0 whose fp32 value the FMA moves across a bf16 rounding boundary)."""
    from paddle_tpu_torch.ops.fused import fused_adamw
    g = torch.Generator(device=dev).manual_seed(7)
    n = 1_000_003
    p = (0.02 * torch.randn(n, generator=g, device=dev)).to(pdtype)
    grad = torch.randn(n, generator=g, device=dev).to(gdtype)
    m = 0.1 * torch.randn(n, generator=g, device=dev)
    v = 0.01 * torch.rand(n, generator=g, device=dev)
    hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=7)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ops.reset_launch_counts()
    fused_adamw(kp, grad, km, kv, **hp)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adamw"] == 1
    with ops.plain_versions():
        fused_adamw(p, grad, m, v, **hp)
    for got, want in ((km, m), (kv, v)):
        torch.testing.assert_close(
            got, want, rtol=0, atol=2.0 ** -22 * float(want.abs().max()))
    if pdtype == torch.float32:
        torch.testing.assert_close(kp, p, rtol=0, atol=1e-8)
    else:
        torch.testing.assert_close(
            kp.float(), p.float(), rtol=2.0 ** -8,
            atol=2.0 ** -23 * float(p.float().abs().max()))


def _bf16_ulp(t):
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _dw_flips(x, ct, eps):
    """Per column of a bf16 dw: what products cast(ct·n) whose n may
    round the other way in the kernel can move it (``chip_smoke.py``'s
    ``_dw_flips`` has the derivation). An element whose plain xf·r lies
    within |r_p - r64|/r64 + (d/2 + 7)·2^-24 of it from a bf16 rounding
    midpoint (d: the kernel's summation depth, a thread's values + 10)
    may flip; a flip moves its product by 1.01·2^-6·|ct·n| at most."""
    from paddle_tpu_torch.ops.fused import rms_norm_plan
    h = x.shape[-1]
    nvec = h * x.element_size() // 16
    vpt, threads = rms_norm_plan(nvec)
    per_thread = (vpt or -(-nvec // threads)) * 16 // x.element_size()
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    x64 = x.double()
    r64 = torch.rsqrt(torch.mean(x64 * x64, dim=-1, keepdim=True) + eps)
    delta = (r.double() - r64).abs() / r64 \
        + (per_thread / 2 + 12) * 2.0 ** -24
    m = xf * r
    mid = ((m.view(torch.int32) & -65536) | 0x8000).view(torch.float32)
    amb = (m.double() - mid.double()).abs() <= delta * m.double().abs()
    ctn = (ct.float() * m.to(x.dtype).float()).abs()
    return (1.01 * 2.0 ** -6 * ctn * amb).reshape(-1, h).sum(0)


def _assert_rms_grad_close(got, want, kind, part=None, terms=None,
                           flips=None):
    """A gradient of the RMSNorm backward kernel against the plain
    version's: fp32 1e-5 absolute + 1e-5 relative, and for dw also
    sqrt(rows) fp32 ulps of ``terms`` = (rows, sum over the rows of
    |grad * n|): both sides sum the same rows products in other orders,
    which moves a sum by about sqrt(rows) ulps of its terms' magnitude
    (beyond 1e-5 of |dw| from some 2000 rows on, where the terms cancel);
    bf16 dx (``kind`` "dx") within 1e-6 + 1.01 * 2^-6 relative (both
    sides round one fp32 value a few ulp apart: chip_smoke's
    RMS_BF16_TOL), dw within 2 bf16 ulps of the value (bf16-rounded
    products summed in fp32 in another order, rounded once) plus
    ``flips`` (:func:`_dw_flips`: products whose n rounds the other
    way); a residual d_s (``part``: the plain RMS part before the sum's
    cotangent was added) within the dx tolerance of the part plus one
    bf16 ulp of the result."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bound = 1e-5 + 1e-5 * want.float().abs()
        if terms is not None:
            rows, mag = terms
            bound = bound + math.sqrt(rows) * 2.0 ** -24 * mag
    elif kind == "dw":
        bound = 1e-6 + 2 * _bf16_ulp(want) + flips
    else:
        ref = want if part is None else part
        bound = 1e-6 + 1.01 * 2.0 ** -6 * ref.float().abs()
        if part is not None:
            bound = bound + _bf16_ulp(torch.maximum(got.float().abs(),
                                                    want.float().abs()))
    assert (err <= bound).all(), (kind, float((err / bound).max()))


def test_rms_norm_grad_kernel_path_matches_plain(dev):
    """The entry point's gradients, forward and backward kernels against
    the plain versions, at the stated tolerance
    (``_assert_rms_grad_close``)."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn(64, 4096, generator=g, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).bfloat16()
    ct = torch.randn(64, 4096, generator=g, device=dev).bfloat16()
    grads = []
    for plain in (False, True):
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        ops.reset_launch_counts()
        if plain:
            with ops.plain_versions():
                out = rms_norm(xl, wl, 1e-5)
                (out.float() * ct.float()).sum().backward()
        else:
            out = rms_norm(xl, wl, 1e-5)
            (out.float() * ct.float()).sum().backward()
        assert ops.launch_counts()["rms_norm_bwd"] == (0 if plain else 1)
        grads.append((xl.grad, wl.grad))
    _assert_rms_grad_close(grads[0][0], grads[1][0], "dx")
    _assert_rms_grad_close(grads[0][1], grads[1][1], "dw",
                           flips=_dw_flips(x, ct, 1e-5))


def test_train_step_on_gpu_goes_through_kernels(dev):
    """Three AdamW steps of the tiny Llama on the card and on the CPU
    from the same weights: losses within 1e-4 (cuBLAS and the kernels
    sum in other orders), and the per-step launch counts of the
    training path."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    cpu, gpu = _tiny_pair(dev)
    ids = np.random.RandomState(0).randint(0, 512, (2, 64)).astype(np.int32)
    batch = (ids, np.roll(ids, -1, 1).astype(np.int32))
    losses = []
    for m in (cpu, gpu):
        opt = AdamW(learning_rate=1e-4, parameters=m.parameters())
        step = TrainStep(m, lambda mm, b: mm(*b)[0], opt)
        ops.reset_launch_counts()
        losses.append([float(step(batch)) for _ in range(3)])
    counts = ops.launch_counts()
    L = gpu.config.num_hidden_layers
    n_params = len(list(gpu.parameters()))
    assert counts == {"rms_norm": 3 * (2 * L + 1),
                      "paged_attention_decode": 0,
                      "paged_attention_decode_int8": 0,
                      "flash_attention_fwd": 3 * L,
                      "flash_attention_bwd_dq": 3 * L,
                      "flash_attention_bwd_dkv": 3 * L,
                      "rope": 3 * 2 * L, "adamw": 3 * n_params,
                      "xent_fwd": 0, "xent_bwd": 0, "moe_gather": 0,
                      "rms_norm_residual": 0, "decode_layer": 0,
                      "decode_layer_int8": 0,
                      "rms_norm_bwd": 3 * (2 * L + 1),
                      "weight_only_gemm": 0}
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-4)


# (300, 11008) and (2, 131072): rows past the registers (the looping
# instance), the second one longer than any a thread could hold
RMS_BWD_SHAPES = [(8, 4096), (512, 4096), (2048, 4096), (37, 256),
                  (1, 64), (300, 11008), (2, 3, 1024), (2, 131072),
                  (16384, 2048)]      # the headline configuration's rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RMS_BWD_SHAPES)
def test_rms_norm_bwd_kernel_matches_plain(dev, shape, dtype):
    from paddle_tpu_torch.ops.fused import (rms_norm_backward_reference,
                                            rms_norm_bwd)
    g = torch.Generator(device=dev).manual_seed(shape[-1] + len(shape))
    x = torch.randn(*shape, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=dev)
         ).to(dtype)
    ct = torch.randn(*shape, generator=g, device=dev).to(dtype)
    ops.reset_launch_counts()
    dx, dw = rms_norm_bwd(x, w, ct, 1e-5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rms_norm_bwd"] == 1
    assert dx.shape == x.shape and dw.shape == w.shape
    want_dx, want_dw = rms_norm_backward_reference(x, w, ct, 1e-5)
    xf = x.double().reshape(-1, shape[-1])
    n = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)) \
        .to(dtype).double()
    mag = (ct.double().reshape(n.shape) * n).abs().sum(0).float()
    _assert_rms_grad_close(dx, want_dx, "dx")
    _assert_rms_grad_close(dw, want_dw, "dw", terms=(n.shape[0], mag),
                           flips=_dw_flips(x, ct, 1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_bwd_kernel_is_deterministic(dev, dtype):
    """No atomics: dx and dw bit-identical over two calls."""
    from paddle_tpu_torch.ops.fused import rms_norm_bwd
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(4096, 4096, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    ct = torch.randn(4096, 4096, generator=g, device=dev).to(dtype)
    a, b = rms_norm_bwd(x, w, ct, 1e-5), rms_norm_bwd(x, w, ct, 1e-5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("wrt", ["x", "w"])
def test_rms_norm_bwd_kernel_for_one_input(dev, wrt):
    """Only x (or only the weight) wants a gradient: one launch (the dw
    stage skipped for x alone), the other gradient None, the one asked
    for equal to the full backward's bits."""
    from paddle_tpu_torch.ops.fused import rms_norm_bwd
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(300, 1024, generator=g, device=dev)
    w = 1 + 0.1 * torch.randn(1024, generator=g, device=dev)
    ct = torch.randn(300, 1024, generator=g, device=dev)
    full = rms_norm_bwd(x, w, ct, 1e-5)
    (x if wrt == "x" else w).requires_grad_()
    ops.reset_launch_counts()
    rms_norm(x, w, 1e-5).backward(ct)
    assert ops.launch_counts()["rms_norm_bwd"] == 1
    if wrt == "x":
        assert w.grad is None and torch.equal(x.grad, full[0])
    else:
        assert x.grad is None and torch.equal(w.grad, full[1])


def test_rms_norm_bwd_refuses_unsupported_inputs(dev):
    from paddle_tpu_torch.ops.fused import rms_norm_bwd
    x = torch.randn(4, 64, device=dev)
    w = torch.ones(64, device=dev)
    with pytest.raises(TypeError):
        rms_norm_bwd(x.half(), w.half(), x.half(), 1e-5)
    with pytest.raises(ValueError):
        rms_norm_bwd(x, w, torch.randn(4, 32, device=dev), 1e-5)
    with pytest.raises(ValueError):
        rms_norm_bwd(x, w, x.bfloat16(), 1e-5)
    with pytest.raises(ValueError):
        rms_norm_bwd(x, w, x.cpu(), 1e-5)


def _assert_rms_forward(x, w, eps=1e-5):
    """The forward kernel, without and with a residual (x + x), against
    the plain versions: fp32 1e-5 absolute and relative, bf16 1e-6 +
    1.01 * 2^-6 relative (chip_smoke's RMS_BF16_TOL), the sum bit-equal;
    a second call bit-identical."""
    from paddle_tpu_torch.ops import fused
    want = rms_norm_reference(x, w, eps).float()
    atol, rtol = (1e-5, 1e-5) if x.dtype == torch.float32 \
        else (1e-6, 1.01 * 2.0 ** -6)
    got, again = rms_norm(x, w, eps), rms_norm(x, w, eps)
    out, s = fused.rms_norm_residual(x, x, w, eps)
    want_out, want_s = fused.rms_norm_residual_reference(x, x, w, eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)
    assert torch.equal(got, again) and torch.equal(s, want_s)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 8, 32, 64])
def test_rms_norm_few_row_forward_matches_plain(dev, rows, dtype):
    """The decode rows: one CTA a row, the row in registers."""
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, 4096, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    ops.reset_launch_counts()
    _assert_rms_forward(x, w)
    assert ops.launch_counts()["rms_norm"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [11008, 16384, 65536, 131072])
def test_rms_norm_long_row_forward_matches_plain(dev, h, dtype):
    """Rows past the registers (fp32 h > 4096, bf16 h > 8192): the
    looping instance, with any h."""
    g = torch.Generator(device=dev).manual_seed(h)
    x = torch.randn(5, h, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=g, device=dev)).to(dtype)
    _assert_rms_forward(x, w)


def test_rms_norm_forward_in_a_cuda_graph(dev):
    """The forward's launches captured in a CUDA graph, as the decode
    block's RMSNorms are, without and with a residual: replays equal the
    eager launches' bits, on new inputs copied into the captured buffers
    too."""
    from paddle_tpu_torch.ops import fused
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(8, 4096, generator=g, device=dev)
    w = 1 + 0.1 * torch.randn(4096, generator=g, device=dev)
    rms_norm(x, w, 1e-5)                     # build and warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    ops.reset_launch_counts()
    with torch.cuda.graph(graph):
        out = rms_norm(x, w, 1e-5)
        out_r, s = fused.rms_norm_residual(x, out, w, 1e-5)
    assert ops.launch_counts()["rms_norm"] == 1
    assert ops.launch_counts()["rms_norm_residual"] == 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        want = rms_norm(x, w, 1e-5)
        want_r, want_s = fused.rms_norm_residual(x, want, w, 1e-5)
        assert torch.equal(out, want) and torch.equal(out_r, want_r)
        assert torch.equal(s, want_s)
        x.copy_(torch.randn(8, 4096, generator=g, device=dev))


# -- ERNIE-MoE kernels ------------------------------------------------------

XENT_GPU_CASES = [(64, 30522), (33, 32000), (40, 1000), (17, 777),
                  (9, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v", XENT_GPU_CASES)
def test_xent_kernels_match_plain(dev, n, v, dtype):
    """Forward (nll, lse) within 1e-5 (fp32 sums of exps in another
    order) and the backward per element within 8 fp32 ulps (fp32 dx:
    the same operations, expf against torch's exp) or one bf16 ulp
    (bf16 dx: both round an fp32 value once). Widths whose rows start
    off a 16-byte boundary (30522, 777, 5), and the warp-per-row form
    (V < 1024)."""
    from paddle_tpu_torch.ops.xent import xent_bwd, xent_fwd
    g = torch.Generator(device=dev).manual_seed(n + v)
    x = (2 * torch.randn(n, v, generator=g, device=dev)).to(dtype)
    labels = torch.randint(0, v, (n,), generator=g, device=dev,
                           dtype=torch.int32)
    ga = torch.randn(n, generator=g, device=dev)
    gb = torch.randn(n, generator=g, device=dev)
    ops.reset_launch_counts()
    nll, lse = xent_fwd(x, labels)
    dx = xent_bwd(x, labels, lse, ga, gb)
    torch.cuda.synchronize()
    assert ops.launch_counts()["xent_fwd"] == 1
    assert ops.launch_counts()["xent_bwd"] == 1
    with ops.plain_versions():
        pnll, plse = xent_fwd(x, labels)
        pdx = xent_bwd(x, labels, lse, ga, gb)
    assert ops.launch_counts()["xent_fwd"] == 1
    torch.testing.assert_close(nll, pnll, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)
    assert dx.dtype == dtype
    rtol = 2.0 ** -20 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(dx.float(), pdx.float(), rtol=rtol,
                               atol=1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [768, 100, 3])
@pytest.mark.parametrize("m", [203, 8, 6])
def test_moe_gather_kernel_is_bit_equal_to_plain(dev, dtype, d, m):
    """Out-of-range indices (-1, T, far past T) give zero rows; a row
    of 100 fp32 / bf16 values is no multiple of 16 bytes (the
    element-wise copy); m against the kernel's eight rows per CTA: a
    ragged last CTA, one full CTA, one part-filled."""
    from paddle_tpu_torch.ops.moe_dispatch import (gather_rows_reference,
                                                   moe_gather)
    g = torch.Generator(device=dev).manual_seed(d + m)
    t = 50
    x = torch.randn(t, d, generator=g, device=dev).to(dtype)
    idx = torch.randint(-1, t + 2, (m,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[5] = 10 ** 6
    ops.reset_launch_counts()
    got = moe_gather(x, idx)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_gather"] == 1
    assert torch.equal(got, gather_rows_reference(x, idx))
    assert not got[5].any()


def test_gather_and_xent_never_fall_back(dev, monkeypatch):
    """On a CUDA tensor ``gather_rows`` launches the kernel whatever the
    JAX package's ``PT_MOE_GATHER`` says, and raises for a dtype the
    kernel does not take; ``cross_entropy`` launches the xent kernels
    without ``PT_FUSION_PASSES``."""
    from paddle_tpu_torch.nn.functional import cross_entropy
    from paddle_tpu_torch.ops.moe_dispatch import gather_rows, moe_gather
    monkeypatch.setenv("PT_MOE_GATHER", "jnp")
    monkeypatch.delenv("PT_FUSION_PASSES", raising=False)
    x = torch.randn(8, 16, device=dev)
    idx = torch.tensor([0, 9, 3], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    gather_rows(x, idx)
    assert ops.launch_counts()["moe_gather"] == 1
    with pytest.raises(TypeError):
        gather_rows(x.half(), idx)
    with pytest.raises(TypeError):
        moe_gather(x, idx.long())
    logits = x.requires_grad_()
    cross_entropy(logits, idx.new_tensor([1, 2, 3, 4, 5, 6, 7, 0])) \
        .backward()
    assert ops.launch_counts()["xent_fwd"] == 1
    assert ops.launch_counts()["xent_bwd"] == 1


def test_adamw_kernel_bf16_moments_match_plain(dev):
    """bf16 p, g, m and v (``multi_precision=False`` on a bf16 model),
    at a size with a tail, step 4: fp32 arithmetic on both sides, each
    output rounded once to bf16, so p, m and v within one bf16 ulp (the
    kernel's contracted FMA can move an fp32 result across a rounding
    boundary), plus one fp32 ulp of the largest entry near 0."""
    from paddle_tpu_torch.ops.fused import fused_adamw
    g = torch.Generator(device=dev).manual_seed(9)
    n = 1_000_003
    p = (0.02 * torch.randn(n, generator=g, device=dev)).bfloat16()
    grad = torch.randn(n, generator=g, device=dev).bfloat16()
    m = (0.1 * torch.randn(n, generator=g, device=dev)).bfloat16()
    v = (0.01 * torch.rand(n, generator=g, device=dev)).bfloat16()
    hp = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=4)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ops.reset_launch_counts()
    fused_adamw(kp, grad, km, kv, **hp)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adamw"] == 1
    with ops.plain_versions():
        fused_adamw(p, grad, m, v, **hp)
    for got, want in ((kp, p), (km, m), (kv, v)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2.0 ** -7,
            atol=2.0 ** -23 * float(want.float().abs().max()))


def test_ernie_train_step_on_gpu_goes_through_kernels(dev, monkeypatch):
    """Three fp32 AdamW steps of the tiny ERNIE-MoE on the card and on
    the CPU from the same weights, with no environment knob set: losses
    within 1e-4, and the per-step launch counts (5 gathers per MoE
    layer, one xent forward and backward, flash per layer, AdamW per
    tensor)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (ErnieMoEForCausalLM,
                                         ernie_moe_tiny_config)
    from paddle_tpu_torch.optimizer import AdamW
    monkeypatch.delenv("PT_FUSION_PASSES", raising=False)
    cfg = ernie_moe_tiny_config(num_hidden_layers=4)
    cpu = ErnieMoEForCausalLM(cfg, device="cpu", seed=0)
    gpu = ErnieMoEForCausalLM(cfg, device=dev, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    ids = np.random.RandomState(0).randint(0, 512, (2, 64)).astype(np.int32)
    batch = (ids, np.roll(ids, -1, 1).astype(np.int32))
    losses = []
    for m in (cpu, gpu):
        opt = AdamW(learning_rate=1e-4, parameters=m.parameters())
        step = TrainStep(m, lambda mm, b: mm(*b)[0], opt)
        ops.reset_launch_counts()
        losses.append([float(step(batch)) for _ in range(3)])
    counts = ops.launch_counts()
    L = cfg.num_hidden_layers
    n_params = len(list(gpu.parameters()))
    assert counts == {"rms_norm": 0, "paged_attention_decode": 0,
                      "paged_attention_decode_int8": 0,
                      "flash_attention_fwd": 3 * L,
                      "flash_attention_bwd_dq": 3 * L,
                      "flash_attention_bwd_dkv": 3 * L,
                      "rope": 0, "adamw": 3 * n_params,
                      "xent_fwd": 3, "xent_bwd": 3,
                      "moe_gather": 3 * 5 * (L // cfg.moe_every),
                      "rms_norm_residual": 0, "decode_layer": 0,
                      "decode_layer_int8": 0, "rms_norm_bwd": 0,
                      "weight_only_gemm": 0}
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-4)


@pytest.mark.parametrize("gate", ["gshard", "switch", "naive"])
def test_moe_layer_gates_on_gpu_match_cpu(dev, gate):
    """``MoELayer`` with each gate, fp32, capacity factor 0.75 (drops):
    output, aux loss and gradients on the card (the gather kernel)
    within 1e-4 of the same layer on the CPU (cuBLAS and the CPU sum in
    other orders; the routes agree)."""
    from paddle_tpu_torch.incubate.distributed.models import MoELayer
    torch.manual_seed(0)
    kw = dict(d_model=128, num_expert=4, d_hidden=64, top_k=2,
              capacity_factor=0.75, gate=gate)
    cpu = MoELayer(**kw, device="cpu")
    gpu = MoELayer(**kw, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 16, 128)
    results = []
    for layer, d in ((cpu, "cpu"), (gpu, dev)):
        xl = x.to(d).detach().requires_grad_()
        ops.reset_launch_counts()
        out = layer(xl)
        loss = (out * out).sum() + (layer.l_aux if layer.l_aux is not None
                                    else 0.0)
        loss.backward()
        results.append([out.detach().cpu(), xl.grad.cpu()]
                       + [p.grad.cpu() for p in layer.parameters()])
    assert ops.launch_counts()["moe_gather"] == 5
    for a, b_ in zip(*results):
        torch.testing.assert_close(b_, a, rtol=1e-4, atol=1e-4)


# -- the decode-layer megakernel and the residual RMSNorm --------------------

def _megakernel_tol(d, ff):
    """Absolute tolerance on a decode layer's output for unit-scale
    inputs and weights scaled by 1/sqrt(fan-in) (every intermediate is
    then O(1)): the five products sum up to K = max(d, ff) fp32 terms in
    another order than cuBLAS, each reassociation moving a sum by about
    u * sqrt(K) of its terms' scale (u = 2^-24), and the attention, both
    RMSNorms and the residuals add a few ulp; 8 u sqrt(K) per product
    covers the tail over every output."""
    return 5 * 8 * 2.0 ** -24 * math.sqrt(max(d, ff))


def _megakernel_case(dev, mode, S, d=256, h=4, kvh=2, dh=64, ff=688,
                     bs=16, mb=8):
    """A decode layer's inputs at S slots: weights (out, in) scaled by
    1/sqrt(fan-in); write positions cycling through length 1, a length
    on a block boundary, a partial block, and a position past the table
    (routed to the trash block; its read covers the whole table)."""
    from paddle_tpu_torch.ops.decode_layer import WEIGHT_NAMES
    g = torch.Generator(device=dev).manual_seed(S)
    nb = 1 + S * mb

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, generator=g, device=dev)

    x = rnd(S, 1, d)
    shapes = {"ln1": (d,), "wq": (h * dh, d), "wk": (kvh * dh, d),
              "wv": (kvh * dh, d), "wo": (d, h * dh), "ln2": (d,),
              "wg": (ff, d), "wu": (ff, d), "wd": (d, ff)}
    wts = [1 + rnd(*shapes[n], s=0.1) if n.startswith("ln")
           else rnd(*shapes[n], s=shapes[n][1] ** -0.5)
           for n in WEIGHT_NAMES]
    cos = torch.cos(rnd(2 * mb * bs, dh))
    sin = torch.sin(rnd(2 * mb * bs, dh))
    pattern = [0, bs - 1, 2 * bs + 5, mb * bs + 3, 3 * bs, bs]
    pos = [pattern[i % len(pattern)] for i in range(S)]
    table = torch.zeros(S, mb, dtype=torch.int32)
    perm = (torch.randperm(nb - 1, generator=torch.Generator()
                           .manual_seed(S)) + 1).tolist()
    for r, p in enumerate(pos):
        n = min(-(-(p + 1) // bs), mb)
        table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    if mode == "paged_int8":
        kc, ks = quantize_kv(rnd(nb, bs, kvh, dh))
        vc, vs = quantize_kv(rnd(nb, bs, kvh, dh))
        cache = [kc, vc, ks, vs]
    else:
        cache = [rnd(nb, bs, kvh, dh), rnd(nb, bs, kvh, dh)]
    return (x, cos, sin, 1e-5, 1e-6,
            torch.tensor(pos, dtype=torch.int32, device=dev),
            table.to(dev)), cache, wts


@pytest.mark.parametrize("S", [1, 3, 8, 32])
@pytest.mark.parametrize("mode", ["paged", "paged_int8"])
def test_decode_layer_kernel_matches_plain(dev, mode, S):
    from paddle_tpu_torch.ops.decode_layer import decode_layer
    fixed, cache, wts = _megakernel_case(dev, mode, S)
    c_kern = [c.clone() for c in cache]
    c_plain = [c.clone() for c in cache]
    ops.reset_launch_counts()
    got = decode_layer(mode, *fixed, *c_kern, *wts)[0]
    torch.cuda.synchronize()
    name = "decode_layer_int8" if mode == "paged_int8" else "decode_layer"
    other = "decode_layer" if mode == "paged_int8" else "decode_layer_int8"
    assert ops.launch_counts()[name] == 1
    assert ops.launch_counts()[other] == 0
    with ops.plain_versions():
        want = decode_layer(mode, *fixed, *c_plain, *wts)[0]
    assert ops.launch_counts()[name] == 1
    assert got.shape == want.shape == fixed[0].shape
    err = float((got - want).abs().max())
    assert err <= _megakernel_tol(256, 688), err
    # the prologue writes the same k and v as the plain version (the
    # same torch ops); block 0 is the trash block
    for a, b in zip(c_kern, c_plain):
        torch.testing.assert_close(a[1:], b[1:], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["paged", "paged_int8"])
def test_decode_layer_kernel_at_7b_width(dev, mode):
    """One Llama-2-7B-width layer (d 4096, 32 heads of 128, ff 11008) at
    32 slots: the split-K plan's full slices and the tensor-core
    products at the serving width, within the same tolerance rule, and
    two launches bit-identical."""
    from paddle_tpu_torch.ops.decode_layer import decode_layer
    d, ff = 4096, 11008
    fixed, cache, wts = _megakernel_case(dev, mode, 32, d=d, h=32, kvh=32,
                                         dh=128, ff=ff, mb=4)
    c_kern = [c.clone() for c in cache]
    c_plain = [c.clone() for c in cache]
    got = decode_layer(mode, *fixed, *c_kern, *wts)[0]
    again = decode_layer(mode, *fixed, *c_kern, *wts)[0]
    with ops.plain_versions():
        want = decode_layer(mode, *fixed, *c_plain, *wts)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    err = float((got - want).abs().max())
    assert err <= _megakernel_tol(d, ff), err


@pytest.mark.parametrize("mode", ["paged", "paged_int8"])
def test_decode_layer_kernel_is_deterministic(dev, mode):
    """Two launches on the same inputs give the same bits: the split-K
    sums and the table-walk merges run in fixed orders, with no float
    atomics."""
    from paddle_tpu_torch.ops.decode_layer import (DecodeLayerScratch,
                                                   decode_layer)
    for S in (3, 32):
        fixed, cache, wts = _megakernel_case(dev, mode, S)
        scratch = DecodeLayerScratch()
        outs = [decode_layer(mode, *fixed, *cache, *wts,
                             scratch=scratch)[0] for _ in range(3)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert torch.equal(outs[0], outs[2])


def test_decode_layer_refuses_and_never_falls_back(dev):
    """On a CUDA tensor the wrapper launches or raises: a shape, dtype
    or layout the kernel does not take is an error, never the plain
    version."""
    from paddle_tpu_torch.ops.decode_layer import decode_layer
    ops.reset_launch_counts()
    fixed, cache, wts = _megakernel_case(dev, "paged", 3)
    with pytest.raises(ValueError, match="float32"):
        decode_layer("paged", fixed[0].to(torch.bfloat16), *fixed[1:],
                     *cache, *wts)
    with pytest.raises(ValueError, match="contiguous"):
        decode_layer("paged", *fixed, *cache, wts[0], wts[1].t().contiguous()
                     .t(), *wts[2:])
    with pytest.raises(TypeError, match="int32"):
        decode_layer("paged", *fixed[:5], fixed[5].long(), fixed[6], *cache,
                     *wts)
    big, cache, wts = _megakernel_case(dev, "paged", 33)
    with pytest.raises(ValueError, match="33 slots"):
        decode_layer("paged", *big, *cache, *wts)
    assert ops.launch_counts()["decode_layer"] == 0


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_megakernel_engine_matches_unfused_on_gpu(dev, kv_int8):
    """The tiny engine's greedy streams through the megakernel equal the
    unfused kernels' on the card; every decode step launches it once per
    layer and no paged-decode kernel."""
    _, gpu = _tiny_pair(dev)
    rs = np.random.RandomState(1)
    reqs = [(rs.randint(0, 512, (L,)).astype(np.int32), n)
            for L, n in ((5, 6), (9, 4), (12, 7), (5, 5), (9, 6))]
    results, counts = [], []
    for mk in (False, True):
        eng = PagedEngine(gpu, num_slots=2, max_len=64, decode_block=4,
                          block_size=8, prefill_chunk=8, kv_int8=kv_int8,
                          megakernel=mk, device=dev)
        srv = Server(eng, Scheduler(prefill_token_budget=8))
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        ops.reset_launch_counts()
        res = srv.run_until_idle()
        counts.append(ops.launch_counts())
        results.append([res[r] for r in rids])
        eng.manager.assert_consistent()
    L = gpu.config.num_hidden_layers
    name = "decode_layer_int8" if kv_int8 else "decode_layer"
    got = counts[1]
    assert got[name] == L * eng.steps > 0
    assert got["paged_attention_decode"] == 0
    assert got["paged_attention_decode_int8"] == 0
    assert got["rms_norm"] == (2 * L + 1) * eng.prefill_chunks + eng.steps
    assert eng.megakernel_rewrites() == eng.megakernel_kernel_calls() == L
    assert counts[0]["decode_layer"] == counts[0]["decode_layer_int8"] == 0
    for a, b in zip(*results):
        np.testing.assert_array_equal(b, a)


def test_megakernel_engine_reports_an_unviable_shape(dev):
    """33 slots are more than the kernel takes: every layer still goes
    through the fused route (rewrites == L) but runs the unfused
    kernels, and megakernel_kernel_calls() says so."""
    _, gpu = _tiny_pair(dev)
    eng = PagedEngine(gpu, num_slots=33, max_len=32, decode_block=2,
                      block_size=8, prefill_chunk=8, megakernel=True,
                      device=dev)
    srv = Server(eng, Scheduler(prefill_token_budget=64))
    srv.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    ops.reset_launch_counts()
    srv.run_until_idle()
    L = gpu.config.num_hidden_layers
    assert eng.megakernel_rewrites() == L
    assert eng.megakernel_kernel_calls() == 0
    assert ops.launch_counts()["decode_layer"] == 0
    assert ops.launch_counts()["paged_attention_decode"] == L * eng.steps


@pytest.mark.parametrize("rows", [8, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_residual_kernel_matches_plain(dev, dtype, rows):
    from paddle_tpu_torch.ops.fused import (rms_norm_residual,
                                            rms_norm_residual_reference)
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, 4096, generator=g, device=dev).to(dtype)
    r = torch.randn(rows, 4096, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    ops.reset_launch_counts()
    out, s = rms_norm_residual(x, r, w, 1e-5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rms_norm_residual"] == 1
    want_out, want_s = rms_norm_residual_reference(x, r, w, 1e-5)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 \
        else (1e-6, 1.01 * 2.0 ** -6)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=rtol)
    # the gradient: the forward and backward kernels against the plain
    # versions of both
    xs, rs_, ws = (t.float().requires_grad_() for t in (x, r, w))
    o, s2 = rms_norm_residual(xs, rs_, ws, 1e-5)
    (o.square().sum() + s2.sum()).backward()
    assert ops.launch_counts()["rms_norm_residual"] == 2
    assert ops.launch_counts()["rms_norm_bwd"] == 1
    xp, rp, wp = (t.float().requires_grad_() for t in (x, r, w))
    with ops.plain_versions():
        o, s2 = rms_norm_residual(xp, rp, wp, 1e-5)
        (o.square().sum() + s2.sum()).backward()
    for a, b in ((xs, xp), (rs_, rp), (ws, wp)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_residual_backward_matches_plain(dev, dtype):
    """The residual entry's backward (the backward kernel through s = x +
    r, the sum's cotangent added in the kernel) against the plain
    versions, in the input dtype: d_x and d_r equal each other, d_s
    within the RMS part's tolerance plus one bf16 ulp of the sum."""
    from paddle_tpu_torch.ops.fused import (rms_norm_backward_reference,
                                            rms_norm_residual)
    g = torch.Generator(device=dev).manual_seed(12)
    x, r, ct, g_sum = (torch.randn(512, 4096, generator=g, device=dev)
                       .to(dtype) for _ in range(4))
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=dev)).to(dtype)
    grads = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (x, r, w)]
        ops.reset_launch_counts()
        with ops.plain_versions() if plain else contextlib.nullcontext():
            out, total = rms_norm_residual(*leaves, 1e-5)
            torch.autograd.backward((out, total), (ct, g_sum))
        assert ops.launch_counts()["rms_norm_bwd"] == (0 if plain else 1)
        grads.append([t.grad for t in leaves])
    (dx, dr, dw), (px, pr, pw) = grads
    assert torch.equal(dx, dr) and torch.equal(px, pr)
    part, _ = rms_norm_backward_reference(x + r, w, ct, 1e-5)
    _assert_rms_grad_close(dx, px, "dx", part=part)
    _assert_rms_grad_close(dw, pw, "dw", flips=_dw_flips(x + r, ct, 1e-5))


# -- the paged engine's programs as CUDA graphs -------------------------------

def _graph_reqs(seed):
    """Five ragged requests, one sampled (its own seed)."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 512, (L,)).astype(np.int32),
             dict(max_new_tokens=n, **(dict(temperature=0.8, top_k=20,
                                            top_p=0.95, seed=7)
                                       if i == 2 else {})))
            for i, (L, n) in enumerate(((5, 9), (9, 14), (12, 16), (5, 5),
                                        (19, 12)))]


@pytest.mark.parametrize("megakernel", [False, True], ids=["unfused", "mega"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_replayed_block_matches_uncaptured_block(dev, kv_int8, megakernel):
    """One replay of the captured decode block against the same Python
    block run eagerly on clones of the state and the arena: the same
    tokens, live masks and state, and the same arena bytes."""
    from paddle_tpu_torch.ops.decode_layer import FusedDecode
    from paddle_tpu_torch.serving import run_decode_block
    _, gpu = _tiny_pair(dev)
    eng = PagedEngine(gpu, num_slots=3, max_len=64, decode_block=4,
                      block_size=8, prefill_chunk=8, kv_int8=kv_int8,
                      megakernel=megakernel, device=dev)
    srv = Server(eng, Scheduler(prefill_token_budget=8))
    for p, kw in _graph_reqs(2):
        srv.submit(p, **kw)
    srv.run_until_idle(max_ticks=4)
    live = eng._state["live"]
    assert int(live.sum()) == 2 and (eng._state["temp"][live] > 0).any()
    state = {k: v.clone() for k, v in eng._state.items()}
    cache = [tuple(t.clone() for t in layer) for layer in eng.backend.cache]
    fused = FusedDecode() if megakernel else None
    out = torch.zeros_like(eng.backend._block_out)

    def step(tok, pos, table):
        return decode_step_logprobs(gpu, tok, cache, pos, table,
                                    fused_decode=fused)

    run_decode_block(step, state, out)
    got = eng.backend.decode_block()
    torch.cuda.synchronize()
    assert torch.equal(got, out), (got, out)
    for k in state:
        assert torch.equal(eng._state[k], state[k]), (k, eng._state[k],
                                                      state[k])
    for i, (a, b) in enumerate(zip(eng.backend.cache, cache)):
        for j, (x, y) in enumerate(zip(a, b)):
            assert torch.equal(x, y), (i, j, float((x.float() - y.float())
                                                   .abs().max()))


@pytest.mark.parametrize("megakernel", [False, True], ids=["unfused", "mega"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_one_capture_per_program_over_a_ragged_stream(dev, kv_int8,
                                                      megakernel):
    """Each program is captured once, when the engine is built, and
    replayed over a ragged stream; replays add the captured launches, so
    the exact counts hold; the streams equal the CPU engine's."""
    cpu, gpu = _tiny_pair(dev)
    reqs = _graph_reqs(3)
    results = []
    for m, device in ((cpu, "cpu"), (gpu, dev)):
        eng = PagedEngine(m, num_slots=2, max_len=64, decode_block=4,
                          block_size=8, prefill_chunk=8, kv_int8=kv_int8,
                          megakernel=megakernel, device=device)
        want = 0 if device == "cpu" else 1
        assert eng.decode_compile_count() == want
        assert eng.prefill_compile_count() == want
        srv = Server(eng, Scheduler(prefill_token_budget=8))
        rids = [srv.submit(p, **kw) for p, kw in reqs]
        ops.reset_launch_counts()
        res = srv.run_until_idle()
        results.append([res[r] for r in rids])
        assert eng.decode_compile_count() == want
        assert eng.prefill_compile_count() == want
        eng.manager.assert_consistent()
    assert eng.backend.decode_program.graph_bytes > 0
    counts = ops.launch_counts()
    L = gpu.config.num_hidden_layers
    kernel = ("decode_layer" if megakernel else "paged_attention_decode") \
        + ("_int8" if kv_int8 else "")
    assert counts[kernel] == L * eng.steps > 0
    assert counts["rms_norm"] == (2 * L + 1) * eng.prefill_chunks \
        + (1 if megakernel else 2 * L + 1) * eng.steps
    decode = {"decode_layer", "decode_layer_int8", "paged_attention_decode",
              "paged_attention_decode_int8"}
    assert all(counts[k] == 0 for k in decode - {kernel})
    if megakernel:
        assert eng.megakernel_rewrites() == eng.megakernel_kernel_calls() \
            == L
    for a, b in zip(*results):
        np.testing.assert_array_equal(b, a)


def test_a_graph_holds_the_ticket_buffers_it_launches_on(dev):
    """The paged kernels' shared tickets that a captured block launches
    on belong to its program: after the module's cache lets go of them
    and their old memory is asked for again (filled with -1, which would
    break every split merge), the replayed stream still equals the CPU
    engine's."""
    from paddle_tpu_torch.ops import paged_attention as pa
    cpu, gpu = _tiny_pair(dev)
    reqs = _graph_reqs(4)
    results = []
    for m, device in ((cpu, "cpu"), (gpu, dev)):
        eng = PagedEngine(m, num_slots=2, max_len=64, decode_block=4,
                          block_size=8, prefill_chunk=8, device=device)
        if device != "cpu":
            held = eng.backend.decode_program._held
            assert pa._tickets and all(
                any(t is h for h in held) for t in pa._tickets.values())
            sizes = [t.numel() for t in pa._tickets.values()]
            pa._tickets.clear()
            torch.cuda.empty_cache()
            reuse = [torch.full((n,), -1, dtype=torch.int32, device=dev)
                     for n in sizes]
        srv = Server(eng, Scheduler(prefill_token_budget=8))
        rids = [srv.submit(p, **kw) for p, kw in reqs]
        res = srv.run_until_idle()
        results.append([res[r] for r in rids])
    del reuse
    for a, b in zip(*results):
        np.testing.assert_array_equal(b, a)


def test_a_capture_that_fails_raises(dev):
    """A program that copies from pageable host memory cannot be
    captured: the capture raises, and nothing runs it eagerly."""
    from paddle_tpu_torch.serving import CapturedProgram
    dst = torch.zeros(4, device=dev)
    prog = CapturedProgram(lambda: dst.copy_(torch.arange(4.0)), dev)
    with pytest.raises(RuntimeError):
        prog.capture()
    assert prog.captures == 0 and prog.graph is None


def test_megakernel_scratch_is_never_made_in_a_capture(dev):
    """A scratch made during a capture would live in the graph's pool:
    a fresh DecodeLayerScratch under capture raises instead."""
    from paddle_tpu_torch.ops.decode_layer import (DecodeLayerScratch,
                                                   decode_layer)
    fixed, cache, wts = _megakernel_case(dev, "paged", 3)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        with torch.inference_mode(), torch.cuda.graph(graph):
            decode_layer("paged", *fixed, *cache, *wts,
                         scratch=DecodeLayerScratch())


# -- RoPE's serving route, generate() and the dense engine (slice 10) --------

def test_rope_device_start_matches_plain(dev):
    """generate()'s decode shape (4, 1, 32, 128) fp32 over the whole
    (4096, 128) Llama-2-7B tables with the start position on the device:
    against the plain version (1e-5), and bit for bit the route of the
    sliced tables; starts past the table clamp as
    ``dynamic_slice_in_dim`` clamps. GQA takes two launches."""
    from paddle_tpu_torch.models.llama import _rope_cache, llama_7b_config
    from paddle_tpu_torch.ops.fused import _rope_pair
    cos, sin = _rope_cache(llama_7b_config(), dev)
    g = torch.Generator(device=dev).manual_seed(11)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    for hk, launches in ((32, 1), (8, 2)):
        q = torch.randn(4, 1, 32, 128, generator=g, device=dev)
        k = torch.randn(4, 1, hk, 128, generator=g, device=dev)
        for p in (0, 1, 191, 4095, 4096, 10 ** 6):
            start.fill_(p)
            ops.reset_launch_counts()
            got = _rope_pair(q, k, cos, sin, 1.0, start)
            assert ops.launch_counts()["rope"] == launches
            with ops.plain_versions():
                want = _rope_pair(q, k, cos, sin, 1.0, start)
            r = min(p, 4095)
            sliced = _rope_pair(q, k, cos[r:r + 1].contiguous(),
                                sin[r:r + 1].contiguous(), 1.0)
            for a, w, c in zip(got, want, sliced):
                assert float((a - w).abs().max()) <= 1e-5
                assert torch.equal(a, c)
    # a prefill block (s = 5) from a device start
    q = torch.randn(2, 5, 32, 128, generator=g, device=dev)
    start.fill_(40)
    got = _rope_pair(q, q, cos, sin, 1.0, start)
    sliced = _rope_pair(q, q, cos[40:45].contiguous(),
                        sin[40:45].contiguous(), 1.0)
    assert all(torch.equal(a, c) for a, c in zip(got, sliced))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_training_route_is_unchanged(dev, dtype):
    """The training route passes a null start: its table row is row %
    s, as before the serving route existed, so its output is the device
    start 0's over the same (s, d) tables bit for bit, and two launches
    agree bit for bit."""
    from paddle_tpu_torch.ops.fused import _rope_pair, fused_rope
    g = torch.Generator(device=dev).manual_seed(12)
    s, d = 256, 128
    cos = torch.randn(s, d, generator=g, device=dev).to(dtype)
    sin = torch.randn(s, d, generator=g, device=dev).to(dtype)
    q = torch.randn(4, s, 32, d, generator=g, device=dev).to(dtype)
    k = torch.randn(4, s, 32, d, generator=g, device=dev).to(dtype)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for sign in (1.0, -1.0):
        a = _rope_pair(q, k, cos, sin, sign)
        b = _rope_pair(q, k, cos, sin, sign)
        c = _rope_pair(q, k, cos, sin, sign, zero)
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(a, b, c))
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="inference"):
        fused_rope(qg, k, cos, sin, start=zero)


def _eager_generate(m, prompts, new, sample_kwargs, seed):
    """generate()'s loop without a captured step: the prefill and each
    decode step as eager calls, positions as host integers (the sliced
    tables' RoPE route), keys split on the same schedule."""
    from paddle_tpu_torch import random as prng
    from paddle_tpu_torch.models import decode_step
    ids = torch.from_numpy(prompts).to(m.device)
    b, s = ids.shape
    cache = m.init_kv_cache(b, s + new)
    key, sub = prng.split(prng.prng_key(seed)).to(m.device)
    tok = decode_step(m, ids, cache, 0, key=sub, sample_kwargs=sample_kwargs)
    out = [tok]
    for i in range(1, new):
        key, sub = prng.split(key)
        tok = decode_step(m, tok[:, None], cache, s + i - 1, key=sub,
                          sample_kwargs=sample_kwargs)
        out.append(tok)
    return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


@pytest.mark.parametrize("sample", [
    dict(temperature=0.0, top_k=0, top_p=1.0),
    dict(temperature=0.8, top_k=20, top_p=0.9)], ids=["greedy", "sampled"])
def test_replayed_generate_step_matches_eager(dev, sample):
    """Each token of generate() is one replay of its captured step: the
    same tokens as the eager loop, the step captured once and reused by
    a second call, RoPE L launches a step plus L for the prefill."""
    _, gpu = _tiny_pair(dev)
    L = gpu.config.num_hidden_layers
    prompts = np.random.RandomState(4).randint(0, 512, (3, 9)) \
        .astype(np.int32)
    new = 12
    kw = dict(do_sample=sample["temperature"] > 0, seed=5,
              **{k: v for k, v in sample.items() if k != "temperature"})
    if kw["do_sample"]:
        kw["temperature"] = sample["temperature"]
    gpu.release_decode_programs()
    ops.reset_launch_counts()
    got = gpu.generate(prompts, max_new_tokens=new, **kw)
    counts = ops.launch_counts()
    assert counts["rope"] == L * new
    assert counts["rms_norm"] == (2 * L + 1) * new
    want = _eager_generate(gpu, prompts, new, sample, 5)
    assert torch.equal(got, want)
    again = gpu.generate(prompts, max_new_tokens=new, use_scan_decode=False,
                         **kw)
    assert torch.equal(again, got)
    (step,) = gpu.__dict__["_decode_fn_cache"].values()
    assert step.program.captures == 1 and step.program.graph is not None
    gpu.release_decode_programs()


def test_generate_on_gpu_matches_cpu(dev):
    """Greedy, ragged and beam generate() on the card give the CPU's
    tokens on the tiny model."""
    cpu, gpu = _tiny_pair(dev)
    prompts = np.random.RandomState(5).randint(0, 512, (3, 8)) \
        .astype(np.int32)
    am = np.ones((3, 8), np.int32)
    am[0, :3] = 0
    for kw in (dict(), dict(attention_mask=am), dict(num_beams=3)):
        a = cpu.generate(prompts, max_new_tokens=8, **kw)
        b = gpu.generate(prompts, max_new_tokens=8, **kw)
        np.testing.assert_array_equal(b.cpu().numpy(), a.numpy())
    gpu.release_decode_programs()


def test_dense_engine_on_gpu(dev):
    """The dense engine on the card: its decode block captured once, one
    prefill program per bucket admitted, RMSNorm launched 2L + 1 a step
    and a prefill and nothing else, the CPU engine's streams (greedy and
    sampled), and the paged engine's greedy streams."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    cpu, gpu = _tiny_pair(dev)
    L = gpu.config.num_hidden_layers
    reqs = _graph_reqs(3)
    kw = dict(num_slots=2, max_len=64, decode_block=4,
              prompt_buckets=(8, 16, 32))
    results = []
    for m, device in ((cpu, "cpu"), (gpu, dev)):
        eng = ContinuousBatchingEngine(m, device=device, **kw)
        srv = Server(eng)
        rids = [srv.submit(p, **r) for p, r in reqs]
        ops.reset_launch_counts()
        res = srv.run_until_idle()
        results.append([res[r] for r in rids])
    counts = ops.launch_counts()
    assert eng.decode_compile_count() == 1
    assert eng.prefill_compile_count() == 3           # buckets 8, 16, 32
    want = {k: 0 for k in counts}
    want["rms_norm"] = (2 * L + 1) * (eng.steps + eng.prefills)
    assert counts == want
    for a, b in zip(*results):
        np.testing.assert_array_equal(b, a)
    paged = PagedEngine(gpu, num_slots=2, max_len=64, decode_block=4,
                        block_size=8, prefill_chunk=8, device=dev)
    srv = Server(paged)
    rids = [srv.submit(p, **r) for p, r in reqs]
    res = srv.run_until_idle()
    for i, (r, (_, rkw)) in enumerate(zip(rids, reqs)):
        if "temperature" not in rkw:
            np.testing.assert_array_equal(res[r], results[1][i])


def test_dense_prefills_share_one_pool(dev):
    """Without buckets the dense engine captures one prefill per prompt
    length, all into one memory pool: the captures after the longest
    reserve less than it did, and the programs, replayed in another
    order than they were captured, give the CPU engine's streams."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    cpu, gpu = _tiny_pair(dev)
    rs = np.random.RandomState(9)
    reqs = [(rs.randint(0, 512, (n,)).astype(np.int32),
             dict(max_new_tokens=6))
            for n in (24, 16, 8, 20, 12, 24, 8, 16)]
    results = []
    for m, device in ((cpu, "cpu"), (gpu, dev)):
        eng = ContinuousBatchingEngine(m, num_slots=2, max_len=64,
                                       decode_block=4, device=device)
        srv = Server(eng)
        rids = [srv.submit(p, **r) for p, r in reqs]
        res = srv.run_until_idle()
        results.append([res[r] for r in rids])
    progs = eng.backend.prefill_programs()
    assert eng.prefill_compile_count() == len(progs) == 5
    first = progs[24].graph_bytes
    assert first > 0
    assert sum(p.graph_bytes for n, p in progs.items() if n != 24) < first
    for a, b in zip(*results):
        np.testing.assert_array_equal(b, a)


def test_dense_megakernel_launches_nothing(dev):
    """megakernel=True on the dense engine: every layer is rewritten and
    none launches the megakernel, as in JAX (the kernel takes the paged
    modes only); the streams are the unfused engine's."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    _, gpu = _tiny_pair(dev)
    L = gpu.config.num_hidden_layers
    reqs = _graph_reqs(4)
    outs = []
    for mk in (False, True):
        eng = ContinuousBatchingEngine(gpu, num_slots=2, max_len=64,
                                       decode_block=4, megakernel=mk,
                                       device=dev)
        srv = Server(eng)
        rids = [srv.submit(p, **r) for p, r in reqs]
        ops.reset_launch_counts()
        res = srv.run_until_idle()
        outs.append([res[r] for r in rids])
    assert eng.megakernel_rewrites() == L
    assert eng.megakernel_kernel_calls() == 0
    counts = ops.launch_counts()
    assert counts["decode_layer"] == counts["paged_attention_decode"] == 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(b, a)


# -- bench.py's headline configuration (tools/port_train_bench.py) ----------

def test_headline_rms_norm_forward_matches_plain(dev):
    """The headline step's norm rows: 8 x 2048 tokens of hidden 2048,
    bf16."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(16384, 2048, generator=g, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(2048, generator=g, device=dev)).bfloat16()
    _assert_rms_forward(x, w)


def test_headline_rope_matches_plain(dev):
    """q and k (8, 2048, 16, 128) bf16 with the model's own tables (one
    launch for both), forward and the sin-negated backward, within one
    bf16 ulp of the largest term (as ``test_rope_kernel_matches_plain``)."""
    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops.fused import _rope_pair
    from tools.port_train_bench import headline_big_config
    cfg = headline_big_config()
    cos, sin = (t.bfloat16() for t in _rope_cache(cfg, dev))
    g = torch.Generator(device=dev).manual_seed(12)
    q, k = (torch.randn(8, 2048, 16, 128, generator=g, device=dev)
            .bfloat16() for _ in range(2))
    for sign in (1.0, -1.0):
        ops.reset_launch_counts()
        got = _rope_pair(q, k, cos, sin, sign)
        torch.cuda.synchronize()
        assert ops.launch_counts()["rope"] == 1
        with ops.plain_versions():
            want = _rope_pair(q, k, cos, sin, sign)
        tol = 2.0 ** -7 * 2 * float(q.float().abs().max())
        for a, b_ in zip(got, want):
            assert float((a.float() - b_.float()).abs().max()) <= tol


def test_headline_adamw_bf16_moments_match_plain(dev):
    """The largest stack of the headline step, (16, 5632, 2048) =
    184.5M elements of bf16 p, g, m and v (369 MB each): every group of
    8 (the kernel's grid strides over 23M of them, with 64-bit offsets)
    within one bf16 ulp, as ``test_adamw_kernel_bf16_moments_match_plain``
    holds them, the last row included."""
    from paddle_tpu_torch.ops.fused import fused_adamw
    g = torch.Generator(device=dev).manual_seed(13)
    shape = (16, 5632, 2048)
    p = (0.02 * torch.randn(shape, generator=g, device=dev)).bfloat16()
    grad = torch.randn(shape, generator=g, device=dev).bfloat16()
    m = (0.1 * torch.randn(shape, generator=g, device=dev)).bfloat16()
    v = (0.01 * torch.rand(shape, generator=g, device=dev)).bfloat16()
    hp = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=3)
    kp, km, kv = p.clone(), m.clone(), v.clone()
    ops.reset_launch_counts()
    fused_adamw(kp, grad, km, kv, **hp)
    torch.cuda.synchronize()
    assert ops.launch_counts()["adamw"] == 1
    assert not torch.equal(km[-1, -1], m[-1, -1])      # the tail was updated
    with ops.plain_versions():
        fused_adamw(p, grad, m, v, **hp)
    for got, want in ((kp, p), (km, m), (kv, v)):
        torch.testing.assert_close(
            got.float(), want.float(), rtol=2.0 ** -7,
            atol=2.0 ** -23 * float(want.float().abs().max()))


@pytest.mark.parametrize("granularity", ["none", "full", "selective"])
def test_stacked_train_step_on_gpu_matches_plain(dev, granularity):
    """The tiny stacked Llama on the card: one forward and backward with
    the kernels against the same model under ``ops.plain_versions()``
    (loss 1e-5, every gradient 1e-4: fp32, sums in other orders), then
    two AdamW steps with exact launches. Recompute repeats the layer's
    forward kernels: RMSNorm 2L more, RoPE and the flash forward L
    more, per step."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    rc = granularity != "none"
    cfg = llama_tiny_config(scan_layers=True, recompute=rc,
                            recompute_granularity=granularity if rc
                            else "full")
    m = LlamaForCausalLM(cfg, device=dev, seed=0)
    ids = np.random.RandomState(0).randint(0, 512, (2, 64)).astype(np.int32)
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in (ids, np.roll(ids, -1, 1).astype(np.int32)))
    out = []
    for plain in (False, True):
        m.zero_grad(set_to_none=True)
        with ops.plain_versions() if plain else contextlib.nullcontext():
            loss = m(*batch)[0]
            loss.backward()
        out.append((float(loss), {n: p.grad.clone()
                                  for n, p in m.named_parameters()}))
    assert abs(out[0][0] - out[1][0]) <= 1e-5
    for n, g in out[0][1].items():
        assert float((g - out[1][1][n]).abs().max()) <= 1e-4, n
    m.zero_grad(set_to_none=True)
    # the step is captured as a CUDA graph: an eager graph over the
    # parameters (built on the default stream) may not stay alive
    del loss
    opt = AdamW(learning_rate=1e-4, parameters=m.parameters())
    step = TrainStep(m, lambda mm, b: mm(*b)[0], opt)
    ops.reset_launch_counts()
    losses = [float(step(batch)) for _ in range(2)]
    L, extra = cfg.num_hidden_layers, int(rc)
    want = {k: 0 for k in ops.launch_counts()}
    want.update({"rms_norm": 2 * (2 * L + 1 + extra * 2 * L),
                 "rms_norm_bwd": 2 * (2 * L + 1),
                 "rope": 2 * (2 * L + extra * L),
                 "flash_attention_fwd": 2 * (L + extra * L),
                 "flash_attention_bwd_dq": 2 * L,
                 "flash_attention_bwd_dkv": 2 * L,
                 "adamw": 2 * 12})
    assert ops.launch_counts() == want
    assert all(math.isfinite(x) for x in losses) and losses[1] < losses[0]


# -- the training harness: TrainStep / EvalStep as CUDA graphs, AdamW over
# device scalars, device_prefetch ----------------------------------------

def _harness_model(dev, kind):
    """A tiny model of ``kind`` on the card from seed 0 and its loss."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import (ErnieMoEForCausalLM,
                                         ernie_moe_tiny_config)
    if kind == "ernie":
        m = ErnieMoEForCausalLM(ernie_moe_tiny_config(num_hidden_layers=4),
                                device=dev, seed=0)
        amp.decorate(m, level="O2", dtype="bfloat16")

        def loss_fn(mm, b):
            with amp.auto_cast(dtype="bfloat16", level="O2"):
                return mm(*b)[0]
        return m, loss_fn
    if kind == "llama":
        cfg = llama_tiny_config()
    else:
        cfg = llama_tiny_config(scan_layers=True, recompute=True,
                                recompute_granularity=kind)
    return LlamaForCausalLM(cfg, device=dev, seed=0), \
        (lambda mm, b: mm(*b)[0])


def _harness_batches(dev, n, s=64):
    rs = np.random.RandomState(0)
    out = []
    for _ in range(n):
        ids = rs.randint(0, 512, (2, s)).astype(np.int32)
        out.append(tuple(torch.from_numpy(a).to(dev) for a in
                         (ids, np.roll(ids, -1, 1).astype(np.int32))))
    return out


def _eager_steps(m, loss_fn, opt, batches):
    """The hand-written eager loop a captured step must equal."""
    losses = []
    for b in batches:
        opt.clear_grad()
        loss = loss_fn(m, b)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach().clone())
    return losses


@pytest.mark.parametrize("kind", ["llama", "full", "selective", "ernie"])
def test_captured_train_step_equals_eager_loop(dev, kind):
    """Four steps on four batches of one signature through
    ``TrainStep`` (a warm-up step, a capture, three replays) against
    the eager loop on a second model from the same seed: losses, every
    parameter, every optimizer state and the step count bit-equal; one
    capture; the launches of four eager steps, exactly."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    batches = _harness_batches(dev, 4)
    ref, loss_fn = _harness_model(dev, kind)
    ropt = AdamW(learning_rate=1e-3, parameters=ref.parameters(),
                 multi_precision=kind == "ernie")
    ops.reset_launch_counts()
    want = _eager_steps(ref, loss_fn, ropt, batches)
    eager_counts = ops.launch_counts()
    m, _ = _harness_model(dev, kind)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters(),
                multi_precision=kind == "ernie")
    step = TrainStep(m, loss_fn, opt)
    ops.reset_launch_counts()
    got = [step(b) for b in batches]
    torch.cuda.synchronize()
    assert step.captures == 1
    assert ops.launch_counts() == eager_counts
    for a, b in zip(got, want):
        assert torch.equal(a, b), (float(a), float(b))
    for (n, p), q in zip(m.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n
        for k, v in opt._slots[id(p)].items():
            assert torch.equal(v, ropt._slots[id(q)][k]), (n, k)
    assert int(opt._step_tensor) == int(ropt._step_tensor) == 4
    assert opt.state_dict()["@step"] == 4


def test_run_steps_replays_with_one_lr_read(dev):
    """``run_steps`` replays n times after one lr write: a scheduler
    step between calls reaches the replay (the graph reads the lr
    tensor), and the result equals the eager loop with the lr changed
    at the same points; a second batch shape is a second capture."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as tlr
    batch = _harness_batches(dev, 1)[0]
    models = []
    for captured in (False, True):
        m, loss_fn = _harness_model(dev, "llama")
        sched = tlr.StepDecay(learning_rate=1e-3, step_size=1, gamma=0.5)
        opt = AdamW(learning_rate=sched, parameters=m.parameters())
        if captured:
            step = TrainStep(m, loss_fn, opt)
            step.run_steps(batch, 3)
            sched.step()
            last = step.run_steps(batch, 2)
            assert float(opt._lr_tensor) == np.float32(5e-4)
        else:
            _eager_steps(m, loss_fn, opt, [batch] * 3)
            sched.step()
            last = _eager_steps(m, loss_fn, opt, [batch] * 2)[-1]
        models.append((m, last))
    (ref, want), (m, got) = models
    assert torch.equal(got, want)
    for p, q in zip(m.parameters(), ref.parameters()):
        assert torch.equal(p, q)
    assert step.captures == 1
    step(_harness_batches(dev, 1, s=32)[0])
    assert step.captures == 2


def test_capture_failure_raises_with_cause(dev):
    """A ``loss_fn`` that reads the loss on the host cannot be captured:
    the call raises and names the cause (no eager fallback)."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    m, _ = _harness_model(dev, "llama")

    def reads_host(mm, b):
        loss = mm(*b)[0]
        if loss.item() > 1e9:
            raise AssertionError
        return loss

    step = TrainStep(m, reads_host, AdamW(parameters=m.parameters()))
    with pytest.raises(RuntimeError, match="(?s)CUDA graph failed.*host"):
        step(_harness_batches(dev, 1)[0])


def test_set_state_dict_after_capture_then_step(dev):
    """A state loaded after the capture (``set_state_dict`` copies into
    the tensors the graph reads), then a replayed step, equals the same
    load and step in the eager loop."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    b0, b1, b2 = _harness_batches(dev, 3)
    saved_m, loss_fn = _harness_model(dev, "llama")
    sopt = AdamW(learning_rate=1e-3, parameters=saved_m.parameters())
    _eager_steps(saved_m, loss_fn, sopt, [b2, b1])
    sd, params = sopt.state_dict(), saved_m.state_dict()
    out = []
    for captured in (False, True):
        m, _ = _harness_model(dev, "llama")
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        step = TrainStep(m, loss_fn, opt) if captured else None
        for b in (b0, b1):
            step(b) if captured else _eager_steps(m, loss_fn, opt, [b])
        m.load_state_dict(params)
        opt.set_state_dict(sd)
        loss = step(b2) if captured else \
            _eager_steps(m, loss_fn, opt, [b2])[0]
        out.append((m, opt, loss))
    (rm, ropt, rl), (m, opt, loss) = out
    assert torch.equal(loss, rl)
    assert int(opt._step_tensor) == 3 == opt._step_count
    for p, q in zip(m.parameters(), rm.parameters()):
        assert torch.equal(p, q)
        for k, v in opt._slots[id(p)].items():
            assert torch.equal(v, ropt._slots[id(q)][k])


def test_eval_step_captured_equals_eager(dev):
    """``EvalStep`` on the card: one graph per batch signature, outputs
    copied out of static buffers, equal to the eager forward under
    ``no_grad``; training mode restored."""
    from paddle_tpu_torch.jit import EvalStep
    m, _ = _harness_model(dev, "llama")
    ev = EvalStep(m, lambda mm, b: mm(b[0]))
    b0, b1 = _harness_batches(dev, 2)
    outs = [ev(b0), ev(b1)]
    assert ev.captures == 1 and m.training
    with torch.no_grad():
        m.eval()
        want = [m(b0[0]), m(b1[0])]
        m.train()
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    assert outs[0].data_ptr() != outs[1].data_ptr()


@pytest.mark.parametrize("step", [1, 2, 7, 1000])
def test_adamw_kernel_reads_device_scalars(dev, step):
    """The kernel with the lr and step in device memory against the
    plain version over the same tensors (the tolerances of
    ``test_adamw_kernel_matches_plain``); writing a new lr and step into
    the same tensors changes the next launch's update."""
    from paddle_tpu_torch.ops.fused import fused_adamw
    g = torch.Generator(device=dev).manual_seed(step)
    n = 1_000_003
    p = 0.02 * torch.randn(n, generator=g, device=dev)
    grad = torch.randn(n, generator=g, device=dev).bfloat16()
    m = 0.1 * torch.randn(n, generator=g, device=dev)
    v = 0.01 * torch.rand(n, generator=g, device=dev)
    lr = torch.full((1,), 1e-3, device=dev)
    st = torch.full((1,), step, dtype=torch.int32, device=dev)
    hp = (0.9, 0.999, 1e-8, 0.01)
    kp, km, kv, p0 = p.clone(), m.clone(), v.clone(), p.clone()
    fused_adamw(kp, grad, km, kv, lr, *hp, st)
    with ops.plain_versions():
        fused_adamw(p, grad, m, v, lr, *hp, st)
    for got, want in ((km, m), (kv, v)):
        torch.testing.assert_close(
            got, want, rtol=0, atol=2.0 ** -22 * float(want.abs().max()))
    # p: one ulp of its largest entry, and two of the largest update
    # (the contracted FMAs move m and v by their last bits, which the
    # update carries; at step 1000 the update is near lr a step)
    torch.testing.assert_close(
        kp, p, rtol=0, atol=2.0 ** -23 * float(p.abs().max())
        + 2.0 ** -22 * float((p - p0).abs().max()))
    before = kp.clone()
    lr.fill_(0.0)
    st.fill_(step + 1)
    fused_adamw(kp, grad, km, kv, lr, *hp, st)
    assert torch.equal(kp, before)      # lr 0: p stays, read on the device


def test_device_prefetch_pinned_copies(dev):
    """``device_prefetch`` over CPU batches: order kept, every leaf on
    the card and equal to its host batch, at most ``size`` in flight,
    and the copies staged in pinned memory."""
    from paddle_tpu_torch import io
    staged = []
    real = io._transfer

    def counting(batch, device, stream):
        out = real(batch, device, stream)
        staged.extend(out[2])
        return out

    io._transfer = counting
    try:
        host = [(torch.full((4, 8), i, dtype=torch.int32),
                 {"y": np.full((3,), i, np.float32)}) for i in range(6)]
        got = list(io.device_prefetch(iter(host), size=2))
    finally:
        io._transfer = real
    assert len(got) == 6 and len(staged) == 12
    assert all(t.is_pinned() for t in staged)
    for i, (a, b) in enumerate(got):
        assert a.device.type == "cuda" and b["y"].device.type == "cuda"
        assert int(a[0, 0]) == i and float(b["y"][0]) == i


def test_capture_after_an_eager_moe_backward(dev):
    """An eager forward and backward of the MoE model on the default
    stream leaves ``MoELayer.l_aux`` holding its autograd graph (and the
    parameters' gradient accumulators on that stream); the captured step
    still captures, and equals the eager loop from the same point."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    b0, b1, b2 = _harness_batches(dev, 3)
    out = []
    for captured in (False, True):
        m, loss_fn = _harness_model(dev, "ernie")
        loss_fn(m, b0).backward()          # eager, on the default stream
        m.zero_grad(set_to_none=True)
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        if captured:
            step = TrainStep(m, loss_fn, opt)
            losses = [step(b) for b in (b1, b2)]
            assert step.captures == 1
        else:
            losses = _eager_steps(m, loss_fn, opt, [b1, b2])
        out.append((m, losses))
    (ref, want), (m, got) = out
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for p, q in zip(m.parameters(), ref.parameters()):
        assert torch.equal(p, q)


# -- serving resilience on the card --------------------------------------------

def _resilience_engine(gpu, dev, kind):
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    if kind == "dense":
        return ContinuousBatchingEngine(gpu, num_slots=2, max_len=64,
                                        decode_block=4,
                                        prompt_buckets=(8, 16, 32),
                                        device=dev)
    return PagedEngine(gpu, num_slots=2, max_len=64, decode_block=4,
                       block_size=8, prefill_chunk=8, device=dev,
                       kv_int8=kind == "int8", megakernel=kind == "mega")


@pytest.mark.parametrize("kind", ["fp32", "int8", "mega", "dense"])
def test_poison_quarantines_only_its_slot_on_gpu(dev, kind):
    """The NaN the poison writes into the static pool reaches the
    sentinel through the card's kernels (RMSNorm, the paged decode
    kernels, the megakernel) inside the captured block: the victim alone
    ends "poisoned", every other stream equals the clean run, nothing
    leaks and nothing is recaptured."""
    from paddle_tpu_torch.serving import RequestFailure
    from paddle_tpu_torch.utils import faults
    _, gpu = _tiny_pair(dev)
    eng = _resilience_engine(gpu, dev, kind)
    reqs = _graph_reqs(4)
    runs = []
    for spec in (None, "serving.poison:at=3"):
        eng.reset()
        srv = Server(eng)
        rids = [srv.submit(p, **r) for p, r in reqs]
        with faults.injected(spec or ""):
            res = srv.run_until_idle()
        runs.append([res[r] for r in rids])
    clean, got = runs
    fails = [i for i, v in enumerate(got) if isinstance(v, RequestFailure)]
    assert len(fails) == 1 and got[fails[0]].reason == "poisoned"
    for i, (v, w) in enumerate(zip(got, clean)):
        if i not in fails:
            np.testing.assert_array_equal(v, w)
    assert eng.decode_compile_count() == 1
    if kind != "dense":
        eng.manager.assert_consistent()
        assert not eng.manager._ref


@pytest.mark.parametrize("kind", ["fp32", "dense"])
def test_restore_copies_into_the_captured_graphs(dev, kind, tmp_path):
    """Kill mid-stream, snapshot, restore into a freshly built engine on
    the card: the state lands IN the tensors its graphs captured (their
    addresses unchanged), so the replayed blocks finish every stream as
    the uninterrupted run did, with one capture per program."""
    _, gpu = _tiny_pair(dev)
    reqs = _graph_reqs(5)
    eng = _resilience_engine(gpu, dev, kind)
    srv = Server(eng, Scheduler(prefill_token_budget=8))
    rids = [srv.submit(p, **r) for p, r in reqs]
    want = srv.run_until_idle()
    eng.reset()
    srv = Server(eng, Scheduler(prefill_token_budget=8))
    for p, r in reqs:
        srv.submit(p, **r)
    for _ in range(40):              # kill with a stream decoding and
        srv.run_until_idle(max_ticks=1)   # another one waiting
        if eng.has_decoding() and (getattr(eng, "_jobs", None)
                                   or srv.scheduler.pending()):
            break
    assert eng.has_decoding()
    path = str(tmp_path / "snap.npz")
    srv.snapshot(path)
    fresh = _resilience_engine(gpu, dev, kind)
    ptrs = [t.data_ptr() for t in fresh.backend.caches()] + \
        [t.data_ptr() for t in fresh._state.values()]
    srv2 = Server.restore(path, fresh, Scheduler(prefill_token_budget=8))
    assert ptrs == [t.data_ptr() for t in fresh.backend.caches()] + \
        [t.data_ptr() for t in fresh._state.values()]
    got = srv2.run_until_idle()
    for r in rids:
        np.testing.assert_array_equal(got[r], want[r])
    assert fresh.decode_compile_count() == 1


# ---------------------------------------------------------------------------
# the weight-only product (csrc/weight_only_gemm.cu)
# ---------------------------------------------------------------------------

def _wo_tolerance(x, codes, scales, bits, k):
    """Per element: the kernel and the plain version compute the same
    weights (the same product and true division) and sum the same K
    terms in other orders; any order lies within K u sum|x w| of the
    exact sum (u = 2^-24), so the two within twice that. bf16 outputs
    add half an ulp of each side."""
    from paddle_tpu_torch.nn.quant import dequantize_array
    w = dequantize_array(codes, scales, bits, in_features=k)
    mag = torch.nn.functional.linear(x.float().abs(), w.abs())
    tol = 2 * k * 2.0 ** -24 * mag
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * mag
    return tol


_WO_CASES = [
    (8, -1, 256), (8, 64, 256), (4, -1, 256), (4, 128, 512), (8, 8, 96),
    (4, -1, 129), (8, -1, 130), (8, -1, 1040), (4, 32, 1056)]


@pytest.mark.parametrize("bits,group,k", _WO_CASES)
@pytest.mark.parametrize("m", [1, 5, 8, 37, 40, 41, 64, 65, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_only_kernel_matches_plain(dev, bits, group, k, m, dtype):
    """Every route of the kernel (16-byte and byte code loads, per-channel
    and grouped scales, a group narrower than a lane's slice, odd K
    with int4's pad nibble, K not a multiple of the 64/128-k chunk, K
    split over a cluster of 1-8 CTAs; the 8-row tile and the 64-row one,
    full and ragged, more row tiles past 64 rows; n = 72, not a multiple
    of the 64-channel tile) against ``dequantize_array`` + ``F.linear``
    on the same inputs."""
    from paddle_tpu_torch.nn.quant import quantize_array
    from paddle_tpu_torch.ops.weight_only import (
        weight_only_matmul, weight_only_matmul_reference)
    g = torch.Generator(device=dev).manual_seed(m * 1000 + k + bits)
    n = 72
    w = torch.randn(n, k, generator=g, device=dev)
    codes, scales = quantize_array(w, bits, group)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    before = weight_only_matmul.launches
    got = weight_only_matmul(x, codes, scales, bits, k)
    torch.cuda.synchronize()
    assert weight_only_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    want = weight_only_matmul_reference(x, codes, scales, bits, k)
    tol = _wo_tolerance(x, codes, scales, bits, k)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("bits,group", [(8, -1), (4, -1), (8, 32),
                                        (4, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_only_kernel_dequantizes_exactly(dev, bits, group, dtype):
    """One-hot activations make every output one weight times 1 plus
    zeros: the weights the kernel computes (the magic-number decode, the
    product with the scale, the fma-corrected division) equal
    ``dequantize_array``'s bit for bit, over channels whose scales span
    six decades (bf16 outputs: the weights rounded to bf16)."""
    from paddle_tpu_torch.nn.quant import dequantize_array, quantize_array
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul
    g = torch.Generator(device=dev).manual_seed(bits + group)
    k, n = 96, 80
    mag = 10.0 ** (6 * torch.rand(n, 1, generator=g, device=dev) - 3)
    w = torch.randn(n, k, generator=g, device=dev) * mag
    codes, scales = quantize_array(w, bits, group)
    x = torch.eye(k, device=dev).to(dtype)
    got = weight_only_matmul(x, codes, scales, bits, k)
    want = dequantize_array(codes, scales, bits, in_features=k).t()
    assert torch.equal(got, want.to(dtype))


@pytest.mark.parametrize("bits,group,k,m", [
    (8, -1, 4096, 8), (4, 128, 4096, 8), (8, -1, 1040, 40),
    (4, 32, 1056, 65), (8, 8, 96, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_only_kernel_is_deterministic(dev, bits, group, k, m, dtype):
    """Two calls on the same inputs give the same bits: the K split over
    a cluster's CTAs is reduced in a fixed rank order, with no atomics
    (captured steps are held bit-equal to eager ones)."""
    from paddle_tpu_torch.nn.quant import quantize_array
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul
    g = torch.Generator(device=dev).manual_seed(k + m)
    n = 200
    codes, scales = quantize_array(
        torch.randn(n, k, generator=g, device=dev), bits, group)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    a = weight_only_matmul(x, codes, scales, bits, k)
    b = weight_only_matmul(x, codes, scales, bits, k)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_weight_only_kernel_refuses(dev):
    from paddle_tpu_torch.nn.quant import quantize_array
    from paddle_tpu_torch.ops.weight_only import weight_only_matmul
    w = torch.randn(32, 64, device=dev)
    codes, scales = quantize_array(w, 8)
    x = torch.randn(2, 64, device=dev)
    with pytest.raises(TypeError):
        weight_only_matmul(x.half(), codes, scales, 8, 64)
    with pytest.raises(ValueError):
        weight_only_matmul(x[:, :32], codes, scales, 8, 64)
    with pytest.raises(ValueError):
        weight_only_matmul(x, codes.cpu(), scales, 8, 64)


# ---------------------------------------------------------------------------
# the decode features on the card: weight-only quant, spec, preemption
# ---------------------------------------------------------------------------

def _feature_engine(gpu, dev, kind, **kw):
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    if kind == "dense":
        return ContinuousBatchingEngine(gpu, num_slots=2, max_len=64,
                                        decode_block=4,
                                        prompt_buckets=(8, 16, 32),
                                        device=dev, **kw)
    return ContinuousBatchingEngine(gpu, num_slots=2, max_len=64,
                                    decode_block=4, paged=True, block_size=8,
                                    prefill_chunk=8, device=dev, **kw)


def _serve_rows(eng, reqs, scheduler=None):
    eng.reset()
    srv = Server(eng, scheduler or Scheduler(prefill_token_budget=8))
    rids = [srv.submit(p, **r) for p, r in reqs]
    res = srv.run_until_idle()
    return [res[r] for r in rids]


def _greedy(reqs):
    return [(p, {k: v for k, v in r.items() if k == "max_new_tokens"})
            for p, r in reqs]


@pytest.mark.parametrize("quant", ["int8", "int4g32"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_quantized_engine_on_gpu(dev, kind, quant):
    """Every product of the quantized engine's captured programs is one
    weight-only kernel launch: 7L + 1 per decode step, per dense prefill
    and per paged chunk (the head runs over every position); no fp32
    weight product; one capture per program; greedy streams equal the
    same quantized engine's on the CPU (the kernel and the plain version
    use the same weights and differ in summation order and in the three
    low-order products the kernel's bf16 split drops, under 8.02 u |x w|
    each: both inside the summation-order bound)."""
    from paddle_tpu_torch.serving import QuantConfig
    cpu, gpu = _tiny_pair(dev)
    q = "int8" if quant == "int8" else QuantConfig("int4", group_size=32)
    reqs = _greedy(_graph_reqs(21))
    want = _serve_rows(_feature_engine(cpu, "cpu", kind, quant=q), reqs)
    eng = _feature_engine(gpu, dev, kind, quant=q)
    eng.reset()
    srv = Server(eng, Scheduler(prefill_token_budget=8))
    rids = [srv.submit(p, **r) for p, r in reqs]
    ops.reset_launch_counts()
    res = srv.run_until_idle()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    L = gpu.config.num_hidden_layers
    prefills = eng.prefill_chunks if kind == "paged" else eng.prefills
    assert counts["weight_only_gemm"] == (7 * L + 1) * (eng.steps + prefills)
    for r, w in zip(rids, want):
        np.testing.assert_array_equal(res[r], w)
    assert eng.decode_compile_count() == 1
    assert eng.weight_error_bound() > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_engine_on_gpu(dev, kind):
    """The verify step is ONE captured program (no plain decode block is
    captured): greedy and sampled streams equal the plain engine's on
    the card, drafts are accepted on a repetitive prompt, and the
    verify step's s = k + 1 read never takes the s = 1 decode kernel."""
    from paddle_tpu_torch.serving import SpecConfig
    _, gpu = _tiny_pair(dev)
    reqs = _graph_reqs(22) + [(np.full((16,), 7, np.int32),
                               dict(max_new_tokens=24))]
    want = _serve_rows(_feature_engine(gpu, dev, kind), reqs)
    eng = _feature_engine(gpu, dev, kind, spec=SpecConfig(k=4))
    ops.reset_launch_counts()
    got = _serve_rows(eng, reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.decode_compile_count() == 1 and eng.draft_accepted > 0
    L = gpu.config.num_hidden_layers
    prefills = eng.prefill_chunks if kind == "paged" else eng.prefills
    assert counts["paged_attention_decode"] == 0
    assert counts["rms_norm"] == (2 * L + 1) * (eng.verify_steps + prefills)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_preempting_engine_on_gpu(dev, kind):
    """Preemption on the card: the resume re-prefills through the
    engine's captured programs (no new capture), greedy and seeded
    sampled victims finish as the unpreempted run, nothing leaks."""
    from paddle_tpu_torch.serving import Frontend
    _, gpu = _tiny_pair(dev)
    rs = np.random.RandomState(23)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32) for n in (5, 9, 12)]
    kws = [dict(max_new_tokens=20, temperature=0.9, top_k=40, seed=11),
           dict(max_new_tokens=20), dict(max_new_tokens=4)]
    eng = _feature_engine(gpu, dev, kind)
    want = _serve_rows(eng, list(zip(prompts, kws)))
    eng.reset()
    fe = Frontend(eng, preemption=True)
    low = [fe.submit(p, priority=0, **kw) for p, kw in zip(prompts[:2],
                                                           kws[:2])]
    for _ in range(3):
        fe.pump()
    hi = fe.submit(prompts[2], priority=5, **kws[2])
    res = fe.run_until_idle()
    assert fe.stats()["preemptions"] >= 1 and fe.stats()["resumes"] >= 1
    for r, w in zip(low + [hi], want):
        np.testing.assert_array_equal(res[r], w)
    assert eng.decode_compile_count() == 1
    if kind == "paged":
        assert eng.prefill_compile_count() == 1 and not eng.manager._ref


def _tp2(dev):
    from paddle_tpu_torch.distributed.mesh import build_device_mesh
    from paddle_tpu_torch.serving.tp import TPConfig
    return TPConfig(mesh=build_device_mesh({"mp": 2}, devices=[dev, dev]))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
def test_tp2_paged_engine_on_one_card(dev, kv_int8):
    """A ``tp=2`` paged engine on a mesh whose two devices are this card:
    each program is still one capture; each shard launches its own
    RMSNorms and its own paged decode at half the kv heads (exact
    counts); greedy streams equal the unsharded engine's on the card;
    each shard's arena is half of it."""
    _, gpu = _tiny_pair(dev)
    reqs = _greedy(_graph_reqs(3))
    kw = dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
              prefill_chunk=8, kv_int8=kv_int8, device=dev)
    ref = PagedEngine(gpu, **kw)
    want = _serve_rows(ref, reqs)
    eng = PagedEngine(gpu, tp=_tp2(dev), **kw)
    assert eng.tp_degree() == 2
    assert (eng.decode_compile_count(), eng.prefill_compile_count()) == \
        (1, 1)
    ops.reset_launch_counts()
    got = _serve_rows(eng, reqs)
    counts = ops.launch_counts()
    assert (eng.decode_compile_count(), eng.prefill_compile_count()) == \
        (1, 1)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    L = gpu.config.num_hidden_layers
    kernel = "paged_attention_decode" + ("_int8" if kv_int8 else "")
    assert counts[kernel] == 2 * L * eng.steps > 0
    assert counts["rms_norm"] == 2 * (2 * L + 1) * (eng.steps
                                                    + eng.prefill_chunks)
    assert counts["rope"] == 0
    full = sum(t.numel() * t.element_size() for t in ref.backend.caches())
    assert eng.backend.shard_kv_bytes() == [full // 2, full // 2]
    eng.manager.assert_consistent()


def test_tp2_dense_and_quant_on_one_card(dev):
    """The dense engine and ``quant="int8"`` under exact ``tp=2`` on one
    card: one decode capture, streams equal the unsharded engines', the
    weight-only kernel launched at the shard shapes by every shard."""
    _, gpu = _tiny_pair(dev)
    reqs = _greedy(_graph_reqs(4))
    L = gpu.config.num_hidden_layers
    for kind, kw in (("dense", {}), ("paged", dict(quant="int8"))):
        want = _serve_rows(_feature_engine(gpu, dev, kind, **kw), reqs)
        eng = _feature_engine(gpu, dev, kind, tp=_tp2(dev), **kw)
        ops.reset_launch_counts()
        got = _serve_rows(eng, reqs)
        counts = ops.launch_counts()
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        assert eng.decode_compile_count() == 1
        per = eng.steps + (eng.prefill_chunks if kind == "paged"
                           else eng.prefills)
        assert counts["rms_norm"] == 2 * (2 * L + 1) * per
        if kw:
            assert counts["weight_only_gemm"] == 2 * (7 * L + 1) * per


def test_tp2_psum_int8_gate_on_one_card(dev):
    """psum mode with the int8 hop on one card: greedy streams run to
    their length, the runtime bound is positive and the decode block
    stays one capture after the probe; a budget under it is refused."""
    import dataclasses
    from paddle_tpu_torch.serving.tp import TPConfig
    _, gpu = _tiny_pair(dev)
    mesh = _tp2(dev).mesh
    eng = _feature_engine(gpu, dev, "paged",
                          tp=TPConfig(mode="psum", int8=True, mesh=mesh))
    reqs = _greedy(_graph_reqs(5))
    got = _serve_rows(eng, reqs)
    assert [len(g) for g in got] == [len(p) + r["max_new_tokens"]
                                     for p, r in reqs]
    bound = eng.tp_int8_error_bound()
    assert 0 < bound < 1 and eng.decode_compile_count() == 1
    b = eng.backend
    b.tp = dataclasses.replace(b.tp, int8_max_error=bound / 2)
    b._int8_gate_pending = True
    with pytest.raises(RuntimeError, match="error bound"):
        _serve_rows(eng, reqs)
    assert b._int8_gate_pending


def test_dp2_on_one_card_keeps_ranks_bit_identical(dev, tmp_path):
    """Two ranks of ``tools/port_dp_worker.py`` share the card (gloo,
    CUDA tensors staged through the host): the tiny Llama in fp32 from
    seed 0, 3 steps with the bucketed sync; after every step both ranks'
    parameters hash alike, step 1's synced gradient is the mean of the
    two halves' bit for bit, and each rank launched the training
    kernels."""
    import json
    import os
    from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = LaunchConfig(
        os.path.join(repo, "tools", "port_dp_worker.py"),
        ["--out", str(tmp_path), "--config", "tiny", "--batch", "2",
         "--seq", "64", "--steps", "3", "--reference"],
        nproc_per_node=2, log_dir=str(tmp_path / "log"),
        envs={"PYTHONPATH": repo + os.pathsep
              + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:]
            for p in (tmp_path / "log").iterdir()}
    assert rc == 0, logs
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in (0, 1)]
    runs = [r["runs"]["bucketed"] for r in recs]
    assert runs[0]["digests"] == runs[1]["digests"]
    assert runs[0]["reference"]["halves_mean_unequal"] == []
    for r, run in zip(recs, runs):
        assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert r["store_native"]
        assert run["launches"]["flash_attention_fwd"] > 0
        assert run["launches"]["adamw"] == 3 * run["param_tensors"]
        assert run["step_s"][0]["bytes"] == 4 * run["params"]


def test_nccl_one_rank_group(dev, monkeypatch):
    """A rank with a card of its own gets an nccl group: all_reduce,
    broadcast and all_gather of a bucket on the card equal their input,
    and every call takes the nccl route."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.launch_utils import free_ports
    for k, v in {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
                 "PADDLE_LOCAL_RANK": "0", "PADDLE_LOCAL_SIZE": "1",
                 "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(free_ports(1)[0])}.items():
        monkeypatch.setenv(k, v)
    env = dist.init_parallel_env()
    try:
        assert env.backend == "nccl" and dist.get_backend() == "NCCL"
        C.reset_counters()
        x = torch.randn(1 << 20, device=dev)
        y, z, outs = x.clone(), x.clone(), []
        dist.all_reduce(y)
        dist.broadcast(z, src=0)
        dist.all_gather(outs, x)
        assert torch.equal(y, x) and torch.equal(z, x)
        assert len(outs) == 1 and torch.equal(outs[0], x)
        assert C.route_counts() == {"all_reduce": {"nccl": 1},
                                    "broadcast": {"nccl": 1},
                                    "all_gather": {"nccl": 1}}
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_on_a_non_leading_region(dev, dtype):
    """The group-sharded step's AdamW input: a region along dim 1 of a
    (4, 384, 96) parameter (what the sharding rule picks), copied to be
    contiguous, updated by the kernel in place against its plain version
    on the same region, at steps 1 and 2."""
    from paddle_tpu_torch.distributed.sharding import region, sharded_dim
    from paddle_tpu_torch.ops.fused import adamw_reference, fused_adamw
    g = torch.Generator(device=dev).manual_seed(20)
    shape = (4, 384, 96)
    d = sharded_dim(shape, 2)
    assert d == 1
    a, b = region(shape, d, 2, 1)[d]
    full = torch.randn(shape, generator=g, device=dev).to(dtype)
    p = full.narrow(d, a, b - a).contiguous()
    assert not full.narrow(d, a, b - a).is_contiguous()
    grad = torch.randn(p.shape, generator=g, device=dev).to(dtype)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    pr, mr, vr = p.clone(), m.clone(), v.clone()
    lr = torch.full((1,), 1e-3, device=dev)
    for step in (1, 2):
        st = torch.full((1,), step, dtype=torch.int32, device=dev)
        before = fused_adamw.launches
        fused_adamw(p, grad, m, v, lr, 0.9, 0.999, 1e-8, 0.01, st)
        assert fused_adamw.launches == before + 1
        with ops.plain_versions():
            pr, mr, vr = adamw_reference(pr, grad, mr, vr, lr, st, 0.9,
                                         0.999, 1e-8, 0.01)
    torch.cuda.synchronize()
    tol = {} if dtype == torch.float32 else {"atol": 1e-2, "rtol": 2 ** -7}
    for got, want in ((p, pr), (m, mr), (v, vr)):
        torch.testing.assert_close(got.float(), want.float(), **tol)


def test_captured_bucketer_equals_eager(dev):
    """``BucketedGradSync`` over a 2-way ("dp",) mesh of one card,
    captured as a CUDA graph and replayed, against the eager hook and
    the plain mean (bit for bit), over buckets smaller than a tensor."""
    from paddle_tpu_torch.distributed.collectives import BucketedGradSync
    from paddle_tpu_torch.distributed.mesh import build_device_mesh
    from paddle_tpu_torch.graphs import CapturedProgram
    mesh = build_device_mesh({"dp": 2}, devices=[dev, dev])
    g = torch.Generator(device=dev).manual_seed(3)
    shapes = {"w1": (64, 32), "b1": (32,), "w2": (32, 300), "e": (0, 4)}
    grads = [{k: torch.randn(s, generator=g, device=dev)
              for k, s in shapes.items()} for _ in range(2)]
    hook = BucketedGradSync(axes=("dp",), mesh=mesh, bucket_bytes=4096,
                            compress=None)
    eager = hook(grads)
    outs = [{k: torch.empty(s, device=dev) for k, s in shapes.items()}
            for _ in range(2)]

    def run():
        res = hook(grads)
        for s in range(2):
            for k in shapes:
                outs[s][k].copy_(res[s][k])
    prog = CapturedProgram(run, dev, name="the bucketed sync")
    prog.capture()
    assert prog.captures == 1
    for o in outs:
        for t in o.values():
            t.fill_(float("nan"))
    prog()
    torch.cuda.synchronize()
    for s in range(2):
        for k in shapes:
            want = (grads[0][k] + grads[1][k]) / 2
            assert torch.equal(eager[s][k], want), k
            assert torch.equal(outs[s][k], want), k


_RING_WORKER = r'''
import json, os, sys
import torch
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import ops
from paddle_tpu_torch.distributed import communication as C
from paddle_tpu_torch.distributed import context_parallel as cp
from paddle_tpu_torch.distributed import fleet

out = sys.argv[1]
env = dist.init_parallel_env()
rank = dist.get_rank()
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": 1, "sep_degree": 2}
fleet.init(is_collective=True, strategy=st)
g = fleet.get_hybrid_communicate_group().get_sep_parallel_group()
rec = {"backend": env.backend}
for dtype in (torch.float32, torch.bfloat16):
    gen = torch.Generator(device="cuda").manual_seed(3)
    full = [torch.randn(1, 1024, 8, 128, generator=gen, device="cuda")
            for _ in range(4)]
    q, k, v, do = (t[:, rank * 512:(rank + 1) * 512].to(dtype).contiguous()
                   for t in full)
    runs = []
    for plain in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.reset_launch_counts()
        if plain:
            with ops.plain_versions():
                o = cp.ring_attention_spmd(*leaves, group=g)
                (o.float() * do.float()).sum().backward()
        else:
            o = cp.ring_attention_spmd(*leaves, group=g)
            (o.float() * do.float()).sum().backward()
        torch.cuda.synchronize()
        if not plain:
            rec[str(dtype)] = {"launches": ops.launch_counts()}
        runs.append([o.detach()] + [t.grad for t in leaves])
    errs = []
    for a, b in zip(*runs):
        a, b = a.float(), b.float()
        errs.append([float((a - b).abs().max()),
                     float((a - b).norm() / b.norm())])
    rec[str(dtype)]["errs"] = errs
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(rec, f)
C.barrier()
C.destroy_process_group()
'''


def test_sep2_ring_step_on_one_card(dev, tmp_path):
    """Two ranks of a sep 2 group share the card (gloo, CUDA tensors
    staged through the host): one ring attention step, forward and
    backward, on the kernels and again on their plain versions, each
    rank its 512 of 1024 tokens. fp32: 2e-5 for the output, 1e-4 for the
    gradients (the flash tests' bounds); bf16: a relative norm of 2^-7
    (each side rounds the blocks' outputs and the products once).
    Rank 0 launches its diagonal block's kernels only, rank 1 the past
    block's too."""
    import json
    import os
    from paddle_tpu_torch.distributed.launch import LaunchConfig, launch_pod
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "ring.py"
    script.write_text(_RING_WORKER)
    cfg = LaunchConfig(str(script), [str(tmp_path)], nproc_per_node=2,
                       log_dir=str(tmp_path / "log"),
                       envs={"PYTHONPATH": repo + os.pathsep
                             + os.environ.get("PYTHONPATH", "")})
    rc = launch_pod(cfg)
    logs = {p.name: p.read_text()[-3000:]
            for p in (tmp_path / "log").iterdir()}
    assert rc == 0, logs
    for r in (0, 1):
        rec = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rec["backend"] == "gloo"
        for dtype, (atol_o, atol_g) in (("torch.float32", (2e-5, 1e-4)),
                                        ("torch.bfloat16", (None, None))):
            got = rec[dtype]
            assert got["launches"]["flash_attention_fwd"] == r + 1
            assert got["launches"]["flash_attention_bwd_dq"] == r + 1
            for i, (err, relnorm) in enumerate(got["errs"]):
                if atol_o is None:
                    assert relnorm <= 2.0 ** -7, (dtype, r, i, relnorm)
                else:
                    assert err <= (atol_o if i == 0 else atol_g), \
                        (dtype, r, i, err)
