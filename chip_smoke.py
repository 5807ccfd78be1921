#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py                 # needs one GPU

Phases, each of which raises on failure (nothing is caught):

1. Card, torch and CUDA versions; build every kernel from ``csrc/`` with
   ``nvcc`` (one process per source, all started together), printing the
   build seconds and the ptxas register/shared-memory report; the bf16
   flash kernels' SASS must hold wgmma (``HGMMA``) and TMA (``UTMALDG``)
   instructions, the decode-layer megakernel's TF32 wgmma.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: max abs error within the stated tolerance,
   two calls bit-identical where the kernel promises it, and kernel /
   plain / library times beside the bound (the least time the card could
   take for the same work). The decode-layer megakernel at the
   megakernel phase's shapes (one Llama-2-7B layer; fp32 arena at 8
   slots, int8 arena at 32), also timed beside the unfused layer, alone
   against its own bound, and per phase (its %globaltimer stamps);
   the residual RMSNorm at (8, 4096) fp32 and (8192, 4096) bf16, then
   its entry point ``fused_rms_norm(residual=)`` driven along a
   four-block residual stream, forward and backward. The RMSNorm
   forward at 1-512 rows, the backward kernel at (8192, 4096) bf16 and
   (512, 4096), (8, 4096) fp32, and both at rows past the registers
   (h = 16384 and 65536, the looping instances). RoPE also on its
   serving route (``generate()``'s decode shape (4, 1, 32, 128) fp32, the
   start position read on the device). The training kernels also at
   phase 9's shapes (``check_headline_kernels``): flash (8, 2048, 16,
   128) bf16 causal, RMSNorm forward and backward on (16384, 2048) bf16,
   RoPE on q and k (8, 2048, 16, 128) bf16, AdamW over bf16 moments on
   the largest stack (16, 5632, 2048); their rows go into the kernels
   line under ``headline``. AdamW at each of its three shapes reads its
   lr and step from device memory, as the optimizer passes them, and is
   held against its plain version at steps 1, 2 and 1000.
3. The serving path: ``Server`` over ``PagedEngine`` over Llama-2-7B's
   published shape at full depth, fp32 (random weights from a seeded
   generator, created on the card), 12 requests with a shared prefix and
   one sampled stream (threefry, as ``jax.random``). The engine captures
   its decode block and its prefill chunk as one CUDA graph each when it
   is built and replays them: both compile counts must be 1 after the
   stream, and the capture seconds and each graph pool's bytes are
   printed. Outputs, block accounting, exact launch counts (each replay
   adds the launches its graph captured), one decode step's log-probs
   with the kernels against the plain versions, and one profiled
   (replayed) decode block with RMSNorm's kernel time inside it; the
   kernels the profiler saw the device run in one replay must be, kernel
   by kernel, the launches the graph captured.
4. The int8 serving path on the same model: ``PagedEngine(num_slots=32,
   max_len=2048, kv_int8=True)``, whose 4097-block int8 arena (17.72 GB)
   fits beside the fp32 weights where an fp32 arena (68.7 GB) would
   not; 32 requests of 256-1744 prompt tokens, four sharing a prefix,
   two sampled. Outputs, block accounting, exact launch counts, the
   error bound, both compile counts 1, one decode step with all 32 slots
   at lengths over 1024 (kernels against plain versions), one profiled
   decode block, and how far the greedy streams agree with an fp32
   arena's (reported, not gated: quantized logits may diverge within
   the bound).
5. Megakernel decode serving on the same model: the engines of
   phases 3 and 4 with ``megakernel=True`` (phase 4's engines freed
   first) serve the same requests; exact launch counts (the megakernel
   once per layer and decode step, the paged-decode kernels never),
   ``megakernel_kernel_calls() == 32``, both compile counts 1, greedy
   streams token-identical to the unfused engine's of phases 3 and 4,
   one decode step's log-probs three ways (megakernel, unfused kernels,
   plain versions), one profiled decode block, and decode step ms,
   decode tokens/s and the idle share beside the unfused engine's.
6. Dense serving and ``generate()`` on the same model (phase 5's engines
   freed): ``ContinuousBatchingEngine(num_slots=8, max_len=1024,
   decode_block=8, prompt_buckets=(64, 128, 256, 512))`` serves phase
   3's 12 requests (its decode block one CUDA graph, one prefill graph
   per bucket used, launches exact: RMSNorm only), greedy streams
   token-identical to phase 3's paged engine, one decode step's
   log-probs kernels against plain versions, one profiled block, decode
   step ms, tokens/s and TTFT beside phase 3's; then ``generate()`` on 4
   prompts of 128 tokens, 64 new (one captured step replayed per token;
   RoPE L launches a step through its device start position, plus L for
   the prefill), tokens equal to the dense engine's, and a ragged, a
   sampled and a 4-beam run at 8 new tokens.
7. The training path: Llama-2-7B's width at 8 layers, ``amp.decorate``
   O2 bf16, ``AdamW(lr=1e-4, weight_decay=0.01)`` with fp32 masters,
   ``TrainStep`` on a 4 x 2048 batch from ``np.random.RandomState(0)``
   (labels rolled by one, as bench.py). On the card the step is one
   CUDA graph: the first call runs a step (the warm-up) and captures the
   next, each later call replays it. First a hand-written eager loop
   (forward, backward, ``opt.step()``, ``clear_grad``) runs 3 steps on a
   model from seed 0, its states kept on the host. Then, on a second
   model from seed 0: at batch 1, one forward and backward with the
   kernels against the plain versions on the initial weights (loss and
   every parameter's gradient); then 3 captured steps held against the
   eager loop (losses, every parameter, moment and fp32 master, the
   step count: bit-equal; one capture), 5 timed replays, exact launch
   counts per step over all 8, finite losses; last, one profiled
   replayed step and its idle share.
8. The ERNIE-MoE training path (``bench_workloads.py`` ``ernie_moe``):
   ``ernie_moe_base_config(expert_parallel=False)`` at full size, O2
   bf16, ``AdamW(multi_precision=False)`` (bf16 moments), the forward
   under ``auto_cast``, a 16 x 1024 batch: kernels vs plain versions at
   batch 4 (loss and every gradient; the bf16 kernel run also with its
   expert choices pinned to the plain run's), then the captured step:
   its first 3 steps held against the eager loop on a second model from
   seed 0 (bit-equal, one capture), 10 steps in all with exact launch
   counts per step (MoE gather 30, xent 1 + 1, flash 12 each, AdamW
   154), and one profiled replayed step, its idle share beside the
   eager step's.
9. bench.py's headline training configuration (phase 8's model freed),
   through ``tools/port_train_bench.py`` so that both time one program:
   ``headline_big_config("full")`` (~0.95B: hidden 2048, ff 5632, 16
   layers, the stacked trunk with per-layer recompute) built in bf16 on
   the card, ``AdamW(multi_precision=False)`` (bf16 moments). First, at
   batch 1 x 2048, one forward and backward with the kernels against the
   plain versions (loss and every parameter's gradient, the stacks per
   layer; the rule of phase 7). Then the bench's stages: "full"
   recompute at batch 8 x 2048 and "selective" at 4 x 2048, each 2
   warm-up calls (a step and the capture, a replay) and 8 timed steps in
   one ``run_steps`` (8 replays, no host read between them) with exact
   launch counts per step (the recompute repeats the layer's forward
   kernels: RMSNorm 4L+1, RoPE 3L, flash forward 2L, dq and dkv L each,
   the RMSNorm backward 2L+1, AdamW 12), the 10 steps held against the
   eager loop on a second model (bit-equal; its states on the host),
   finite losses and parameters, step ms, tokens/s, MFU, peak memory,
   the graph pool's MiB and one profiled replayed step's idle share;
   then a scheduler's lr change between two ``run_steps`` calls must
   reach the replay (one lr read a call; lr 0 leaves the parameters
   bit-equal) and a second batch shape must be a second capture; then
   the bench's JSON line and the phase's seconds.
10. The ``io`` harness on phase 7's configuration: 16 sequences of 2048
   tokens from ``RandomState(0)`` through ``io.DataLoader(batch_size=4,
   num_workers=2)`` (forked workers over the native shared-memory ring,
   ``csrc/shm_ring.cc`` built with ``g++``) and ``io.device_prefetch
   (size=2)`` (pinned staging, copies on a copy stream) into the
   captured step: the 8 losses bit-equal to the same batches fed
   directly to a second model's captured step, over 2 epochs, exact
   launch counts; then a third epoch times its steps 2-4 (host clock,
   unprofiled, the batch's fetch included) against steps of the same
   graph fed a batch already on the card: the idle the loader adds must
   stay within 2 points. The profiled idle shares of a loader-fed step
   in each of the first two epochs are printed beside phase 7's (in the
   first its pinned staging block is new: the capture emptied the host
   allocator's cache).

Launch counters are zeroed just before each path and read just after.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a GPU the script
exits 1 before printing any result."""
from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores


def _time_ms(fn, iters: int = 50, stream=None) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured into a
    CUDA graph, replayed between CUDA events (so host launch overhead is
    not in the figure), after a warm-up replay. ``stream``: the stream
    to warm up and capture on (an autograd backward runs on the stream
    of its forward, so a captured backward needs its forward's stream)."""
    import torch
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _time_eager(fn, iters: int = 10) -> float:
    """Device time of one call of ``fn`` for work too large or too
    autograd-bound to capture: ``iters`` eager calls between CUDA
    events after one warm-up call (each call runs for milliseconds, so
    the host stays ahead of the device)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int = 20) -> float:
    """Host time to issue one call of ``fn``: ``iters`` calls after a
    warm-up call and a sync, timed on the host's clock without waiting
    for the device (whose queue holds them all). Where it is about the
    eager device time of the same calls, the host paces them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return 1e3 * host


def _bound_ms(nbytes: float, flops: float = 0.0,
              peak: float = BF16_FLOPS):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the type's peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), \
        "operations" if t_ops > t_bytes else "bytes"


def _kernel_name(mangled: str) -> str:
    """``flash_dkv_sm90<128>`` from its Itanium-mangled symbol: the last
    <length><name> component, with a leading int template argument."""
    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = mangled
    while rest[:1].isdigit():
        digits = re.match(r"\d+", rest).group()
        n = int(digits)
        name, rest = rest[len(digits):len(digits) + n], rest[len(digits) + n:]
    arg = re.match(r"ILi(\d+)E", rest)
    return f"{name}<{arg.group(1)}>" if arg else name


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# RMSNorm in bf16, (atol, rtol): both sides round x·rsqrt to bf16 and
# then the product with the weight. rsqrtf and the reduction order differ
# from torch's by a few fp32 ulp, which can flip the first rounding by
# one bf16 ulp of the normalised value (2^-7 of it at most), carried
# through the weight; then each side rounds its product (2^-8 each).
RMS_BF16_TOL = (1e-6, 1.01 * 2.0 ** -6)


def check_flash_sass():
    """The bf16 flash kernels as built: every instance of the forward, dq
    and dkv (head dims 64 and 128) issues wgmma (``HGMMA``) and TMA loads
    (``UTMALDG``), counted in the SASS that ``cuobjdump`` prints of the
    library."""
    import os
    import re
    from paddle_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           str(build.lib_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"flash_(fwd|dq|dkv)_sm90ILi(\d+)",
                      part.split("\n", 1)[0])
        if m:
            found[f"{m.group(1)}<{m.group(2)}>"] = (part.count("HGMMA"),
                                                    part.count("UTMALDG"))
    print("flash bf16 kernels in SASS (HGMMA, UTMALDG instructions): "
          + ", ".join(f"{k} {h}/{u}" for k, (h, u) in sorted(found.items())))
    if len(found) != 6 or not all(h and u for h, u in found.values()):
        raise AssertionError(f"flash bf16 kernels without wgmma or TMA: "
                             f"{found}")


def check_megakernel_sass():
    """The decode-layer megakernel as built: both instances (fp32 and
    int8 arenas) run their products on the tensor cores as TF32 wgmma
    (``HGMMA`` instructions with ``TF32`` operands in the SASS that
    ``cuobjdump`` prints of the library), for each of the four slot
    widths (N = 8, 16, 24, 32)."""
    import os
    from paddle_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           str(build.lib_path("decode_layer"))],
                          capture_output=True, text=True, check=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        head = part.split("\n", 1)[0]
        if "decode_layer_kernel" in head:
            kv = "int8" if "Int8KV" in head else "fp32"
            shapes = set(re.findall(r"HGMMA\.64x(\d+)x8\.F32\.TF32", part))
            found[kv] = sorted(int(n) for n in shapes)
    print("decode_layer megakernel in SASS (HGMMA TF32 shapes 64xNx8): "
          + ", ".join(f"{k} N={v}" for k, v in sorted(found.items())))
    if found != {"fp32": [8, 16, 24, 32], "int8": [8, 16, 24, 32]}:
        raise AssertionError(f"megakernel without TF32 wgmma products: "
                             f"{found}")


def check_rms_norm(torch, results, main_shape):
    """The RMSNorm forward against its plain version at the decode rows
    (1-64) and 512, fp32 and bf16, and at every other row count phase 6
    launches in fp32, h = 4096, timed beside its bound, the
    plain version and ``F.rms_norm``; then at rows past the registers
    (h = 16384 and 65536: the looping instance), with and without a
    residual."""
    from paddle_tpu_torch.ops import fused
    from paddle_tpu_torch.ops.fused import rms_norm, rms_norm_reference
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    h, eps = 4096, 1e-5
    # fp32: rsqrtf and the reduction order differ from torch's by a few ulp
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: RMS_BF16_TOL}
    # fp32 rows: every row count phase 6 gives the kernel (generate()'s
    # 1, 4 and 16 beam rows a decode step, the engine's 8; the prefills'
    # 64-512 bucket rows and the unpadded 88-token prompt)
    sweep = {torch.float32: (1, 4, 8, 16, 32, 64, 88, 128, 256, 512),
             torch.bfloat16: (1, 8, 32, 64, 512)}
    for dtype in (torch.float32, torch.bfloat16):
        for rows in sweep[dtype]:
            x = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
            w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
                 ).to(dtype)
            got, want = rms_norm(x, w, eps), rms_norm_reference(x, w, eps)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            atol, rtol = tol[dtype]
            if not torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol):
                raise AssertionError(
                    f"rms_norm {dtype} rows={rows}: max abs err {err}")
            ms = _time_ms(lambda: rms_norm(x, w, eps))
            plain_ms = _time_ms(lambda: rms_norm_reference(x, w, eps))
            lib_ms = _time_ms(lambda: F.rms_norm(x, (h,), w, eps))
            nbytes = 2 * rows * h * x.element_size() + h * w.element_size()
            bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            plan = fused.rms_norm_plan(h * x.element_size() // 16)
            print(f"rms_norm {str(dtype)[6:]:8s} rows={rows:4d} h={h}: "
                  f"max_abs_err={err:.3e} kernel_ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
                  f"bound_ms={bound_ms:.6f} (bytes) plan (vectors a "
                  f"thread, threads)={plan}")
            if (dtype, rows) == main_shape:
                results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by="bytes",
                               library_ms=lib_ms)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, hl in ((64, 16384), (3, 65536)):
            x = torch.randn(rows, hl, generator=gen, device="cuda").to(dtype)
            r = torch.randn(rows, hl, generator=gen, device="cuda").to(dtype)
            w = (1 + 0.1 * torch.randn(hl, generator=gen, device="cuda")
                 ).to(dtype)
            got, want = rms_norm(x, w, eps), rms_norm_reference(x, w, eps)
            out, total = fused.rms_norm_residual(x, r, w, eps)
            want_out, want_total = fused.rms_norm_residual_reference(
                x, r, w, eps)
            torch.cuda.synchronize()
            atol, rtol = tol[dtype]
            ok = all(torch.allclose(a.float(), b.float(), atol=atol,
                                    rtol=rtol)
                     for a, b in ((got, want), (out, want_out)))
            if not (ok and torch.equal(total, want_total)):
                raise AssertionError(
                    f"rms_norm {dtype} ({rows}, {hl}): max abs err "
                    f"{_max_err(got, want)}, residual {_max_err(out, want_out)}"
                    f", sum equal {torch.equal(total, want_total)}")
            ms = _time_ms(lambda: rms_norm(x, w, eps))
            nbytes = 2 * rows * hl * x.element_size() + hl * w.element_size()
            print(f"rms_norm {str(dtype)[6:]:8s} rows={rows:4d} h={hl}: "
                  f"max_abs_err={_max_err(got, want):.3e} (residual "
                  f"{_max_err(out, want_out):.3e}, sum bit-equal) kernel_ms="
                  f"{ms:.5f} bound_ms={1e3 * nbytes / HBM_BYTES_PER_S:.6f} "
                  f"(bytes) plan={fused.rms_norm_plan(hl * x.element_size() // 16)}")


def check_paged_attention(torch, results, main_kvh):
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode, paged_attention_reference)
    gen = torch.Generator(device="cuda").manual_seed(2)
    S, h, d, bs, mb = 8, 32, 128, 16, 64
    nb = 1 + S * mb
    # ragged: length 1, partial last blocks, a full table; the last row
    # is dead (table all trash block 0) as the engine leaves it
    lengths_h = [1, 17, 100, mb * bs, 513, 250, 33, 41]
    rs = torch.Generator().manual_seed(3)
    perm = (torch.randperm(nb - 1, generator=rs) + 1).tolist()
    table_h = torch.zeros(S, mb, dtype=torch.int32)
    for r, L in enumerate(lengths_h[:-1]):
        n = -(-L // bs)
        table_h[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    table = table_h.cuda()
    lengths = torch.tensor(lengths_h, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)
    # fp32: the online softmax reassociates the sums (the JAX suite pins
    # the same 1e-5); bf16: the plain version casts the probabilities to
    # bf16 before the PV product (the JAX order), the kernel keeps fp32
    tol = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
    for dtype in (torch.float32, torch.bfloat16):
        for kvh in (32, 8):
            q = torch.randn(S, h, d, generator=gen, device="cuda").to(dtype)
            ka = torch.randn(nb, bs, kvh, d, generator=gen,
                             device="cuda").to(dtype)
            va = torch.randn(nb, bs, kvh, d, generator=gen,
                             device="cuda").to(dtype)

            def kern():
                return paged_attention_decode(q, ka, va, table, lengths,
                                              scale=scale)

            def plain():
                return paged_attention_reference(
                    q[:, None], ka, va, table, lengths, scale=scale)[:, 0]

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = _max_err(got, want)
            if not torch.equal(kern(), got):
                raise AssertionError(f"paged_attention_decode {dtype} "
                                     f"kvh={kvh}: two calls differ")
            if not (err <= tol[dtype]):
                raise AssertionError(f"paged_attention_decode {dtype} "
                                     f"kvh={kvh}: max abs err {err}")
            ms, plain_ms = _time_ms(kern), _time_ms(plain)
            elt = ka.element_size()
            kv_bytes = sum(-(-L // bs) * bs for L in lengths_h) \
                * kvh * d * elt * 2
            nbytes = kv_bytes + 2 * S * h * d * elt
            bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            print(f"paged_attention_decode {str(dtype)[6:]:8s} S={S} h={h} "
                  f"kvh={kvh} d={d} bs={bs} mb={mb}: max_abs_err={err:.3e} "
                  f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
                  f"library_ms=none bound_ms={bound_ms:.6f} (bytes)")
            if (dtype, kvh) == (torch.float32, main_kvh):
                results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by="bytes",
                               library_ms=None)


def check_paged_attention_int8(torch, results):
    """The int8 paged-decode kernel against its plain version (the
    per-block loop of the JAX ``_int8_decode_fallback``): the main shape
    of the int8 serving path (32 slots, h = kvh = 32, d 128, block 16,
    every slot at length 2048: 128 table entries), GQA kvh = 8, bf16 q,
    and a ragged case (lengths 1 and 17, trash entries, a dead row).
    fp32 q: 1e-5 absolute (the JAX suite's pin; the online softmax sums
    in another order). bf16 q: both sides compute in fp32 and round the
    output once, so each element within 1e-5 plus one bf16 ulp of its
    magnitude (2^-7 relative). No single PyTorch call computes this
    function (library: none)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.paged_attention import (
        paged_attention_decode_int8, quantize_kv)
    gen = torch.Generator(device="cuda").manual_seed(9)
    d, bs, mb = 128, 16, 128
    cases = [("main", 32, 32, [mb * bs] * 32, torch.float32),
             ("gqa", 32, 8, [mb * bs] * 32, torch.float32),
             ("bf16", 32, 32, [mb * bs] * 32, torch.bfloat16),
             ("ragged", 8, 32, [1, 17, 1, 17, 300, 2048, 17, 5],
              torch.float32)]
    for name, S, kvh, lengths_h, dtype in cases:
        h = 32
        nb = 1 + S * mb
        q = torch.randn(S, h, d, generator=gen, device="cuda").to(dtype)
        kc, ks = quantize_kv(torch.randn(nb, bs, kvh, d, generator=gen,
                                         device="cuda"))
        vc, vs = quantize_kv(torch.randn(nb, bs, kvh, d, generator=gen,
                                         device="cuda"))
        table = torch.zeros(S, mb, dtype=torch.int32)
        perm = (torch.randperm(nb - 1, generator=torch.Generator()
                               .manual_seed(10)) + 1).tolist()
        live = S - 1 if name == "ragged" else S    # ragged: last row dead
        for r in range(live):
            n = -(-lengths_h[r] // bs)
            table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
            perm = perm[n:]
        table = table.cuda()
        lengths = torch.tensor(lengths_h, dtype=torch.int32, device="cuda")
        args = (q, kc, vc, ks, vs, table, lengths)
        scale = 1.0 / math.sqrt(d)

        def kern():
            return paged_attention_decode_int8(*args, scale=scale)

        def plain():
            with ops.plain_versions():
                return paged_attention_decode_int8(*args, scale=scale)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        if not torch.equal(kern(), got):
            raise AssertionError(f"paged_attention_decode_int8 {name}: two "
                                 f"calls differ")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if dtype == torch.float32:
            ok, tol_text = err <= 1e-5, "tol 1e-5"
        else:
            tol = 1e-5 + 2.0 ** -7 * torch.maximum(got.float().abs(),
                                                   want.float().abs())
            share = float((diff / tol).max())
            ok = share <= 1.0
            tol_text = (f"per-element tol 1e-5 + 2^-7 |o|, largest share "
                        f"{share:.3f}")
        if not ok or got.dtype != dtype:
            raise AssertionError(f"paged_attention_decode_int8 {name}: max "
                                 f"abs err {err} ({tol_text})")
        ms = _time_ms(kern, iters=20)
        plain_ms = _time_eager(plain, iters=3)
        # bytes: the codes and scales of the blocks each slot reads, q, out
        rows = sum(-(-L // bs) * bs for L in lengths_h)
        nbytes = rows * kvh * (d + 4) * 2 + 2 * S * h * d * q.element_size()
        bms, by = _bound_ms(nbytes)
        print(f"paged_attention_decode_int8 {name} S={S} h={h} kvh={kvh} "
              f"d={d} bs={bs} mb={mb} q {str(dtype)[6:]}: max_abs_err="
              f"{err:.3e} ({tol_text}) kernel_ms={ms:.5f} plain_ms="
              f"{plain_ms:.4f} library_ms=none bound_ms={bms:.6f} ({by}, "
              f"{nbytes / 1e6:.1f} MB)")
        if name == "main":
            results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, library_ms=None)
        del args, q, kc, vc, ks, vs, got, want
        torch.cuda.empty_cache()


def check_flash(torch, results):
    """The three flash kernels against their plain versions, at the
    Llama training path's shape (4, 2048, 32, 128) bf16 causal, a GQA
    kvh=8 case, an fp32 case at seq 512, the ERNIE-MoE path's shape
    (16, 1024, 12, 64) bf16 causal and the headline training path's
    (8, 2048, 16, 128) bf16 causal. The backward pair gets the kernel's
    o and lse and the same delta on both sides.

    Tolerances. fp32: o and lse 2e-5, gradients 1e-4 absolute (the same
    fp32 sums in another order). bf16, per element: the kernels round
    the probabilities p to bf16 before o = p·v and dv = pᵀ·do, and ds
    before dq = ds·k and dk = dsᵀ·q, with fp32 sums; the plain forward
    rounds the normalised p (the JAX order), the plain backward nothing
    but its outputs. So |kernel - plain| <= half a bf16 ulp of each
    side plus 7 standard deviations of those operands' rounding
    (``bf16_tolerance``; a kv or q tile left out moves an element by
    several times that); lse is fp32 on both sides (1e-4).

    Beside each time: the achieved TFLOP/s, the share of the bound
    (bound / kernel) and the ratio to the library call; the main shape's
    times go into the kernels line, the ERNIE and headline shapes' into
    ``results["ernie"]`` and ``results["headline"]``."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(4)
    # the plain version's bf16 products sum in fp32 throughout
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cases = [("main", 4, 2048, 32, 32, 128, torch.bfloat16),
             ("gqa", 4, 2048, 32, 8, 128, torch.bfloat16),
             ("fp32", 4, 512, 32, 32, 128, torch.float32),
             ("ernie", 16, 1024, 12, 12, 64, torch.bfloat16),
             ("headline", 8, 2048, 16, 16, 128, torch.bfloat16)]
    for name, b, s, h, hk, d, dtype in cases:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(
                dtype)

        q, k, v, do = rnd(b, s, h, d), rnd(b, s, hk, d), rnd(b, s, hk, d), \
            rnd(b, s, h, d)
        kw = dict(is_causal=True, scale=1 / math.sqrt(d), window=None)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        delta = (do * o).float().sum(-1).transpose(1, 2).contiguous()
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        ref = fa.flash_attention_reference(q, k, v, **{
            x: kw[x] for x in ("is_causal", "scale", "window")})
        rdq, rdk, rdv = fa.flash_attention_bwd_reference(
            q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        fp32 = dtype == torch.float32
        errs = {"o": _max_err(o, ref[0]), "lse": _max_err(lse, ref[1])}
        outs = (("o", o, ref[0]), ("dq", dq, rdq), ("dk", dk, rdk),
                ("dv", dv, rdv))
        if fp32:
            tols = {"o": 2e-5, "lse": 2e-5, "dq": 1e-4, "dk": 1e-4,
                    "dv": 1e-4}
            for gname, got, want in outs[1:]:
                errs[gname] = _max_err(got, want)
            bad = {x: e for x, e in errs.items() if not (e <= tols[x])}
            tol_text = " ".join(f"{x}={e:.3e}(tol {tols[x]:.1e})"
                                for x, e in errs.items())
        else:
            spread = fa.bf16_rounding_spread(q, k, v, do, lse, delta, **kw)
            bad, ratios = {}, {}
            if not errs["lse"] <= 1e-4:
                bad["lse"] = errs["lse"]
            for (gname, got, want), sp in zip(outs, spread):
                tol = fa.bf16_tolerance(got, want, sp, 2 if gname == "o"
                                        else 1)
                diff = (got.float() - want.float()).abs()
                errs[gname] = float(diff.max())
                # the largest share of its own tolerance any element uses
                ratios[gname] = float((diff / tol).max())
                if not ratios[gname] <= 1.0:
                    bad[gname] = ratios[gname]
                del tol, diff
            del spread
            tol_text = f"lse={errs['lse']:.3e}(tol 1e-4) " + " ".join(
                f"{x}={errs[x]:.3e}(largest share of its per-element "
                f"tol {ratios[x]:.3f})" for x in ratios)
        if bad:
            raise AssertionError(f"flash {name}: over tolerance {bad}; "
                                 f"{tol_text}")
        del ref, rdq, rdk, rdv
        torch.cuda.empty_cache()
        pairs = b * h * s * (s + 1) // 2       # causal (query, key) pairs
        peak = FP32_FLOPS if fp32 else BF16_FLOPS
        elt = q.element_size()
        io = b * s * (h + 2 * hk) * d * elt
        ms_f = _time_eager(lambda: fa.flash_attention_fwd(q, k, v, **kw))
        ms_dq = _time_eager(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw))
        ms_dkv = _time_eager(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw))
        plain_f = _time_eager(lambda: fa.flash_attention_reference(
            q, k, v, True, kw["scale"]), iters=3)
        plain_b = _time_eager(lambda: fa.flash_attention_bwd_reference(
            q, k, v, do, lse, delta, **kw), iters=3)
        # the library yardstick (never called by the port): PyTorch's
        # fused attention in its (b, h, s, d) layout, forward alone and
        # its backward (one call computing dq, dk and dv)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        gqa = dict(enable_gqa=True) if hk != h else {}
        lib_f = _time_eager(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, **gqa))
        lo = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            **gqa)
        dot = do.transpose(1, 2).contiguous()
        lib_b = _time_eager(lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dot, retain_graph=True))
        del lo, qt, kt, vt
        flops = {"fwd": 4 * d * pairs, "dq": 6 * d * pairs,
                 "dkv": 8 * d * pairs}
        bounds = {
            "fwd": _bound_ms(io + b * s * h * (d * elt + 4), flops["fwd"],
                             peak),
            "dq": _bound_ms(io + b * s * h * (2 * d * elt + 8),
                            flops["dq"], peak),
            "dkv": _bound_ms(io + b * s * h * (d * elt + 8)
                             + 2 * b * s * hk * d * elt, flops["dkv"],
                             peak)}
        print(f"flash {name} b={b} s={s} h={h} kvh={hk} d={d} "
              f"{str(dtype)[6:]} causal: max_abs_err {tol_text}")
        for kname, ms, plain, lib in (("fwd", ms_f, plain_f, lib_f),
                                      ("dq", ms_dq, plain_b, lib_b),
                                      ("dkv", ms_dkv, plain_b, lib_b)):
            bms, by = bounds[kname]
            print(f"  flash_{kname}: kernel_ms={ms:.4f} plain_ms={plain:.4f}"
                  f" library_ms={lib:.4f} bound_ms={bms:.4f} ({by}) "
                  f"tflops={flops[kname] / ms / 1e9:.1f} "
                  f"bound_share={bms / ms:.3f} vs_library={ms / lib:.2f}x")
            err = errs["o"] if kname == "fwd" else \
                errs["dq"] if kname == "dq" else max(errs["dk"], errs["dv"])
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, library_ms=lib)
            if name == "main":
                results[kname] = row
            elif name in ("ernie", "headline"):
                results.setdefault(name, {})[kname] = row
        print(f"  dq + dkv: kernel_ms={ms_dq + ms_dkv:.4f} "
              f"vs_library={(ms_dq + ms_dkv) / lib_b:.2f}x; plain_ms of dq "
              f"and dkv: the whole plain backward; library_ms of dq and "
              f"dkv: the library's whole backward")
        del q, k, v, do, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced


def check_rope(torch, results):
    """RoPE on the training path's q and k (4, 2048, 32, 128) bf16 with
    the model's tables: one launch for both; then the backward (sin
    negated). bf16: the kernel rounds once from fp32, the plain version
    (the JAX order) rounds each product, so one bf16 ulp of the largest
    term (|x|max * 2^-7, the tables being in [-1, 1])."""
    from paddle_tpu_torch.models.llama import _rope_cache, llama_7b_config
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import _rope_pair
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s, h, d = 4, 2048, 32, 128
    cos, sin = _rope_cache(llama_7b_config(), "cuda")
    cos, sin = cos[:s].bfloat16(), sin[:s].bfloat16()
    q = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    k = torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
    tol = 2.0 ** -7 * 2 * float(max(q.float().abs().max(),
                                    k.float().abs().max()))
    for sign in (1.0, -1.0):
        got = _rope_pair(q, k, cos, sin, sign)
        with plain_versions():
            want = _rope_pair(q, k, cos, sin, sign)
        torch.cuda.synchronize()
        err = max(_max_err(a, w) for a, w in zip(got, want))
        if not err <= tol:
            raise AssertionError(f"rope sign={sign}: max abs err {err} > "
                                 f"{tol}")
    ms = _time_ms(lambda: _rope_pair(q, k, cos, sin, 1.0))

    def plain():
        with plain_versions():
            return _rope_pair(q, k, cos, sin, 1.0)

    plain_ms = _time_ms(plain)
    nbytes = 4 * q.numel() * 2 + 2 * s * d * 2
    bms, by = _bound_ms(nbytes)
    print(f"rope (4, 2048, 32, 128) bf16, q and k in one launch: "
          f"max_abs_err={err:.3e} (tol {tol:.3e}) kernel_ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms=none bound_ms={bms:.5f} "
          f"({by})")
    results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=None)
    check_rope_serving(torch, cos_full=_rope_cache(llama_7b_config(),
                                                   "cuda"))


def check_rope_serving(torch, cos_full):
    """RoPE's serving route at ``generate()``'s decode shape on Llama-2-7B
    (q and k (4, 1, 32, 128) fp32, one launch for both): the whole
    (4096, 128) tables and the start position read on the device, at
    starts 0, 191, 4095 and 5000 (clamped to 4095, as
    ``dynamic_slice_in_dim`` clamps it), against the plain version
    (fp32, 1e-5) and bit for bit against the route of sliced tables; then
    timed inside a CUDA graph with its bound (bytes: q, k, their outputs
    and one table row each). Then every other RoPE launch of phase 6
    against the plain version (fp32, 1e-5): ``generate()``'s prefills
    over sliced tables ((4, 128) prompts; the unpadded (1, 88) prompt),
    the 4-beam decode (16 rows, s = 1, sliced tables at an int
    position) and the batch-1 decode with a device start."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import _rope_pair
    cos, sin = cos_full
    gen = torch.Generator(device="cuda").manual_seed(6)
    b, h, d = 4, 32, 128
    q = torch.randn(b, 1, h, d, generator=gen, device="cuda")
    k = torch.randn(b, 1, h, d, generator=gen, device="cuda")
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = 0.0
    for p in (0, 191, 4095, 5000):
        start.fill_(p)
        ops.reset_launch_counts()
        got = _rope_pair(q, k, cos, sin, 1.0, start)
        if ops.launch_counts()["rope"] != 1:
            raise AssertionError("rope's serving route: not one launch")
        with plain_versions():
            want = _rope_pair(q, k, cos, sin, 1.0, start)
        r = min(p, cos.shape[0] - 1)
        sliced = _rope_pair(q, k, cos[r:r + 1].contiguous(),
                            sin[r:r + 1].contiguous(), 1.0)
        torch.cuda.synchronize()
        err = max([err] + [_max_err(a, w) for a, w in zip(got, want)])
        if not all(torch.equal(a, c) for a, c in zip(got, sliced)):
            raise AssertionError(f"rope start {p}: the device start differs "
                                 "from the sliced tables")
    if not err <= 1e-5:
        raise AssertionError(f"rope serving route: max abs err {err} > 1e-5")
    start.fill_(191)
    ms = _time_ms(lambda: _rope_pair(q, k, cos, sin, 1.0, start))

    def plain():
        with plain_versions():
            return _rope_pair(q, k, cos, sin, 1.0, start)

    plain_ms = _time_ms(plain)
    bms, by = _bound_ms(4 * q.numel() * 4 + 2 * d * 4)
    print(f"rope serving route (4, 1, 32, 128) fp32, device start over the "
          f"(4096, 128) tables: max_abs_err={err:.3e} (tol 1e-5), equal "
          f"to the sliced tables' route; kernel_ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms=none bound_ms={bms:.6f} "
          f"({by})")
    for b, s, p, dev_start in ((4, 128, 0, False), (1, 88, 0, False),
                               (16, 1, 130, False), (1, 1, 90, True)):
        q = torch.randn(b, s, h, d, generator=gen, device="cuda")
        k = torch.randn(b, s, h, d, generator=gen, device="cuda")
        if dev_start:
            start.fill_(p)
            args = (cos, sin, 1.0, start)
        else:
            args = (cos[p:p + s], sin[p:p + s], 1.0)
        got = _rope_pair(q, k, *args)
        with plain_versions():
            want = _rope_pair(q, k, *args)
        torch.cuda.synchronize()
        err = max(_max_err(a, w) for a, w in zip(got, want))
        if not err <= 1e-5:
            raise AssertionError(f"rope ({b}, {s}, 32, 128) fp32 at {p}: "
                                 f"max abs err {err} > 1e-5")
        print(f"rope ({b}, {s}, 32, 128) fp32 at position {p}, "
              f"{'device start' if dev_start else 'sliced tables'}: "
              f"max_abs_err={err:.3e} (tol 1e-5)")


ADAMW_STEPS = (1, 2, 1000)


def _adamw_hp(torch):
    """AdamW's hyper-parameters with the lr (1e-4) and the step in
    device tensors, as the optimizer passes them and the kernel reads
    them."""
    return dict(lr=torch.full((1,), 1e-4, device="cuda"), beta1=0.9,
                beta2=0.999, eps=1e-8, weight_decay=0.01,
                step=torch.zeros(1, dtype=torch.int32, device="cuda"))


def _adamw_steps(torch, p, g, m, v, hp, errors):
    """The kernel against the plain version from the same (p, m, v) at
    each step of ``ADAMW_STEPS`` (written into the device step tensor):
    ``errors(got, want)`` of each, and the kernel's outputs at the last
    step."""
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import fused_adamw
    out = {}
    for t in ADAMW_STEPS:
        hp["step"].fill_(t)
        got = [x.clone() for x in (p, m, v)]
        fused_adamw(got[0], g, got[1], got[2], **hp)
        want = [x.clone() for x in (p, m, v)]
        with plain_versions():
            fused_adamw(want[0], g, want[1], want[2], **hp)
        torch.cuda.synchronize()
        out[t] = errors(got, want)
        del want
    return out, got


def check_adamw(torch, results):
    """AdamW on a gate_proj-sized (11008 x 4096 = 45.1M) fp32 master with
    a bf16 gradient, in place, the lr and the step read from device
    memory, at steps 1, 2 and 1000. The kernel and the plain version
    (the same fp32 arithmetic, op by op, and the same fp32 bias
    corrections) agree to the last bits: m and v 1e-6 relative, the
    master one ulp of its largest entry (a contracted FMA moves the last
    bit)."""
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import fused_adamw
    gen = torch.Generator(device="cuda").manual_seed(6)
    n = 11008 * 4096
    p = 0.02 * torch.randn(n, generator=gen, device="cuda")
    g = (1e-3 * torch.randn(n, generator=gen, device="cuda")).bfloat16()
    m = 1e-4 * torch.randn(n, generator=gen, device="cuda")
    v = 1e-8 * torch.rand(n, generator=gen, device="cuda")
    hp = _adamw_hp(torch)
    ptol = 2.0 ** -23 * float(p.abs().max())     # one ulp of the largest

    def errors(got, want):
        return (_max_err(got[0], want[0]),
                _max_err(got[1], want[1]) / float(want[1].abs().max()),
                _max_err(got[2], want[2]) / float(want[2].abs().max()))

    by_step, (kp, km, kv) = _adamw_steps(torch, p, g, m, v, hp, errors)
    bad = {t: e for t, e in by_step.items()
           if not (e[0] <= ptol and e[1] <= 1e-6 and e[2] <= 1e-6)}
    if bad:
        raise AssertionError(f"adamw: errors (p abs, m rel, v rel) by "
                             f"step {by_step}")
    errs = max(by_step.values())
    ms = _time_eager(lambda: fused_adamw(kp, g, km, kv, **hp), iters=20)

    def plain():
        with plain_versions():
            fused_adamw(p, g, m, v, **hp)

    plain_ms = _time_eager(plain, iters=5)
    # the library yardstick: PyTorch's fused AdamW on the one tensor
    # (it takes the gradient in the parameter's dtype)
    gf = g.float()
    steps = [torch.tensor(2.0, device="cuda")]
    lib_ms = _time_eager(lambda: torch._fused_adamw_(
        [kp], [gf], [km], [kv], [], steps, lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False), iters=20)
    bms, by = _bound_ms(n * (4 + 2 + 4 + 4 + 4 + 4 + 4))
    print(f"adamw n={n} fp32 master, bf16 grad, lr and step on the device, "
          f"steps {ADAMW_STEPS}: max_abs_err p="
          f"{max(e[0] for e in by_step.values()):.3e} (tol {ptol:.1e}), rel "
          f"m={max(e[1] for e in by_step.values()):.3e} "
          f"v={max(e[2] for e in by_step.values()):.3e} (tol 1e-6) "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} (torch._fused_adamw_, fp32 grad) "
          f"bound_ms={bms:.4f} ({by})")
    results.update(max_abs_err=max(e[0] for e in by_step.values()), ms=ms,
                   plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, library_ms=lib_ms)


def _bf16_ulp(t):
    """One bf16 ulp (8 significant bits) of each value of ``t``."""
    import torch
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _dw_flips(torch, x, ct, eps):
    """What a bf16 dw column of the backward kernel may differ from the
    plain version's by beside its final rounding: the products cast(ct·n)
    whose n may round the other way on the two sides, summed per column.

    n = cast(xf·r) to bf16 on both sides, but the two r differ: each side
    sums the row's h squares in fp32 in its own order. The plain side's r
    is recomputed here bit for bit (its own operations), beside r in
    fp64. The kernel's sum of squares is a thread's ``d - 10`` values in
    sequence, then two 5-level butterflies: depth d, so within d·2^-24 of
    the exact sum (positive terms), and its r within (d/2)·2^-24 of r64,
    plus 2^-24 for the division and the add and 4·2^-24 for rsqrtf (2
    ulps). Each side then rounds xf·r (2^-24 of it each). So an element
    whose plain xf·r lies within |r_p - r64|/r64 + (d/2 + 7)·2^-24 of it
    from a bf16 rounding midpoint may round the other way in the
    kernel. Such an n moves by one bf16 ulp, its product's exact value
    by |ct|·ulp(n) <= 2^-7·|ct·n|, and each side rounds the product
    (2^-8 of it at most each): at most 1.01·2^-6·|ct·n| a flip."""
    from paddle_tpu_torch.ops import fused
    h = x.shape[-1]
    vpt, threads = fused.rms_norm_plan(h * x.element_size() // 16)
    per_thread = (vpt or -(-(h * x.element_size() // 16) // threads)) \
        * 16 // x.element_size()
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    x64 = x.double()
    r64 = torch.rsqrt(torch.mean(x64 * x64, dim=-1, keepdim=True) + eps)
    delta = (r.double() - r64).abs() / r64 \
        + (per_thread / 2 + 5 + 7) * 2.0 ** -24
    m = xf * r
    mid = ((m.view(torch.int32) & -65536) | 0x8000).view(torch.float32)
    amb = (m.double() - mid.double()).abs() <= delta * m.double().abs()
    n = m.to(x.dtype).float()
    ctn = (ct.float() * n).abs()
    return (1.01 * 2.0 ** -6 * ctn * amb).reshape(-1, h).sum(0)


def _rms_bwd_tol(torch, want, kind, x=None, ct=None, eps=None):
    """The tolerance of a gradient of the backward kernel against the
    plain version's: fp32 1e-5 absolute + 1e-5 relative; bf16 dx
    ``RMS_BF16_TOL`` (both sides round one fp32 value a few ulp apart);
    bf16 dw (``kind`` "dw", with the inputs ``x``, ``ct``, ``eps``) from
    its rounding sites: both sides sum the same bf16-rounded products in
    fp32 in other orders (a few fp32 ulps of the sum) and round once to
    bf16, which two roundings a few fp32 ulps apart can leave 2 bf16 ulps
    apart at most, plus what products whose n rounds the other way can
    move the sum (``_dw_flips``), + 1e-6."""
    if want.dtype == torch.float32:
        return 1e-5 + 1e-5 * want.float().abs()
    if kind == "dx":
        return RMS_BF16_TOL[0] + RMS_BF16_TOL[1] * want.float().abs()
    return 1e-6 + 2 * _bf16_ulp(want) + _dw_flips(torch, x, ct, eps)


def _rms_bwd_close(got, want, bound):
    """(ok, max abs err, largest share of ``bound``)."""
    err = (got.float() - want.float()).abs()
    share = float((err / bound).max())
    return share <= 1.0, float(err.max()), share


def check_rms_norm_backward(torch, results):
    """RMSNorm on the training path's (8192, 4096) bf16 rows. The
    forward kernel against its plain version at ``RMS_BF16_TOL``, timed
    beside the plain version and ``F.rms_norm``. Then the backward
    kernel (``ops.fused.rms_norm_bwd``) against
    ``rms_norm_backward_reference`` at (8192, 4096) bf16, (512, 4096),
    (8, 4096) fp32 and rows past the registers ((64, 16384), (3, 65536),
    both dtypes), within ``_rms_bwd_tol``; two calls bit-identical.
    Timed alone (a CUDA graph) beside its bound (x and the cotangent read
    once, dx written once, w, dw), the plain version and ``F.rms_norm``'s
    autograd backward (captured in a CUDA graph too, on its forward's
    stream; both also eager); forward + backward through the entry point
    beside ``F.rms_norm`` forward + backward, eager, with the host's
    time to issue each. Last the residual entry's backward at the main
    shape."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused, plain_versions
    from paddle_tpu_torch.ops.fused import (
        rms_norm, rms_norm_backward_reference, rms_norm_bwd,
        rms_norm_reference, rms_norm_residual)
    gen = torch.Generator(device="cuda").manual_seed(7)
    eps = 1e-5
    x = torch.randn(8192, 4096, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(4096, generator=gen, device="cuda")).bfloat16()
    ct = torch.randn(8192, 4096, generator=gen, device="cuda").bfloat16()

    y, want = rms_norm(x, w, eps), rms_norm_reference(x, w, eps)
    torch.cuda.synchronize()
    err = _max_err(y, want)
    atol, rtol = RMS_BF16_TOL
    rel = float(((y.float() - want.float()).abs()
                 / want.float().abs().clamp_min(atol)).max())
    if not torch.allclose(y.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"rms_norm (8192, 4096) bf16 forward: max "
                             f"abs err {err}, max relative err {rel}")
    ms = _time_ms(lambda: rms_norm(x, w, eps), iters=20)
    plain_ms = _time_ms(lambda: rms_norm_reference(x, w, eps), iters=20)
    lib_ms = _time_ms(lambda: F.rms_norm(x, (4096,), w, eps), iters=20)
    bms, by = _bound_ms(2 * x.numel() * 2 + 4096 * 2)
    print(f"rms_norm forward (8192, 4096) bf16: max_abs_err={err:.3e} "
          f"max_rel_err={rel:.3e} (tol {atol:g} + {rtol:.4e} relative) "
          f"kernel_ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={lib_ms:.5f} bound_ms={bms:.5f} "
          f"({by})")
    del y, want

    cases = [(x, w, ct)]
    for dtype, rows, h in ((torch.float32, 512, 4096),
                           (torch.float32, 8, 4096),
                           (torch.float32, 64, 16384),
                           (torch.bfloat16, 64, 16384),
                           (torch.float32, 3, 65536),
                           (torch.bfloat16, 3, 65536)):
        cases.append(tuple(t.to(dtype) for t in (
            torch.randn(rows, h, generator=gen, device="cuda"),
            1 + 0.1 * torch.randn(h, generator=gen, device="cuda"),
            torch.randn(rows, h, generator=gen, device="cuda"))))
    for xc, wc, cc in cases:
        dx, dw = rms_norm_bwd(xc, wc, cc, eps)
        dx2, dw2 = rms_norm_bwd(xc, wc, cc, eps)
        pdx, pdw = rms_norm_backward_reference(xc, wc, cc, eps)
        torch.cuda.synchronize()
        okx, ex, sx = _rms_bwd_close(dx, pdx, _rms_bwd_tol(torch, pdx, "dx"))
        okw, ew, sw = _rms_bwd_close(
            dw, pdw, _rms_bwd_tol(torch, pdw, "dw", xc, cc, eps))
        same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
        plan = fused.rms_norm_plan(xc.shape[-1] * xc.element_size() // 16)
        label = f"rms_norm_bwd {tuple(xc.shape)} {str(xc.dtype)[6:]}"
        print(f"{label} plan {plan}: max_abs_err dx={ex:.3e} dw={ew:.3e} "
              f"(|dw| up to {float(pdw.float().abs().max()):.1f}); largest "
              f"share of the tolerance dx {sx:.3f} dw {sw:.3f}; two calls "
              f"bit-identical {same}")
        if not (okx and okw and same):
            raise AssertionError(f"{label}: against the plain version "
                                 f"dx ok {okx}, dw ok {okw}; two calls "
                                 f"bit-identical {same}")
        if xc is x:
            main_err = max(ex, ew)
        del dx, dw, dx2, dw2, pdx, pdw
    del cases

    ms = _time_ms(lambda: rms_norm_bwd(x, w, ct, eps), iters=20)
    eager_ms = _time_eager(lambda: rms_norm_bwd(x, w, ct, eps), iters=20)
    plain_ms = _time_ms(lambda: rms_norm_backward_reference(x, w, ct, eps),
                        iters=20)
    # F.rms_norm's backward: its forward recorded on the stream the
    # backward is captured on
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    with torch.cuda.stream(side):
        ylib = F.rms_norm(xl, (4096,), wl, eps)
    lib_bwd = lambda: torch.autograd.grad(ylib, (xl, wl), ct,  # noqa: E731
                                          retain_graph=True)
    lib_ms = _time_ms(lib_bwd, iters=20, stream=side)
    torch.cuda.synchronize()
    lib_eager_ms = _time_eager(lib_bwd, iters=20)
    del ylib
    bms, by = _bound_ms(3 * x.numel() * 2 + 2 * 4096 * 2)
    print(f"rms_norm_bwd (8192, 4096) bf16 plan "
          f"{fused._bwd_plan(x, True)}: kernel_ms={ms:.5f} (eager "
          f"{eager_ms:.5f}) plain_ms={plain_ms:.5f} library_ms="
          f"{lib_ms:.5f} (F.rms_norm's autograd backward in a CUDA graph; "
          f"eager {lib_eager_ms:.5f}) bound_ms={bms:.5f} ({by}; x, grad "
          f"in, dx out, w, dw)")
    results.update(max_abs_err=main_err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, library_ms=lib_ms)

    def run():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        rms_norm(xr, wr, eps).backward(ct)
        return xr.grad, wr.grad

    def lib():
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        F.rms_norm(xr, (4096,), wr, eps).backward(ct)

    def plain():
        with plain_versions():
            return run()

    got, want = run(), plain()
    torch.cuda.synchronize()
    okx, ex, _ = _rms_bwd_close(got[0], want[0],
                                _rms_bwd_tol(torch, want[0], "dx"))
    okw, ew, _ = _rms_bwd_close(got[1], want[1], _rms_bwd_tol(
        torch, want[1], "dw", x, ct, eps))
    if not (okx and okw):
        raise AssertionError(f"rms_norm forward+backward: kernel path vs "
                             f"plain path dx err {ex}, dw err {ew}")
    del got, want
    ms, plain_ms, lib_ms = _time_eager(run), _time_eager(plain), \
        _time_eager(lib)
    host = {name: _host_ms(fn) for name, fn in (
        ("entry fwd+bwd", run), ("F.rms_norm fwd+bwd", lib),
        ("entry forward", lambda: rms_norm(x, w, eps)),
        ("rms_norm_bwd", lambda: rms_norm_bwd(x, w, ct, eps)),
        ("F.rms_norm forward", lambda: F.rms_norm(x, (4096,), w, eps)),
        ("clones of x and w", lambda: (x.clone().requires_grad_(),
                                       w.clone().requires_grad_())))}
    bms, by = _bound_ms(2 * x.numel() * 2 + 4096 * 2)
    bbms, _ = _bound_ms(3 * x.numel() * 2 + 2 * 4096 * 2)
    print(f"rms_norm forward+backward (8192, 4096) bf16 through the entry "
          f"point (eager, clones of x and w included): kernel path "
          f"ms={ms:.4f} plain path ms={plain_ms:.4f} F.rms_norm fwd+bwd "
          f"ms={lib_ms:.4f} bound_ms={bms + bbms:.4f} (bytes; two "
          f"launches, each reads x); host ms to issue one call: "
          + "; ".join(f"{k} {v:.4f}" for k, v in host.items()))

    r = torch.randn(8192, 4096, generator=gen, device="cuda").bfloat16()
    g_sum = torch.randn(8192, 4096, generator=gen, device="cuda").bfloat16()

    def residual():
        xr, rr, wr = (t.clone().requires_grad_() for t in (x, r, w))
        out, total = rms_norm_residual(xr, rr, wr, eps)
        torch.autograd.backward((out, total), (ct, g_sum))
        return xr.grad, rr.grad, wr.grad

    got = residual()
    with plain_versions():
        want = residual()
    # d_s rounds twice: the RMS part (within RMS_BF16_TOL of the plain
    # one's) and then its sum with g_sum (one bf16 ulp of the result)
    s = x + r
    part, _ = rms_norm_backward_reference(s, w, ct, eps)
    torch.cuda.synchronize()
    err = (got[0].float() - want[0].float()).abs()
    bound = RMS_BF16_TOL[0] + RMS_BF16_TOL[1] * part.float().abs() \
        + _bf16_ulp(torch.maximum(got[0].float().abs(),
                                  want[0].float().abs()))
    share = float((err / bound).max())
    okw, ew, sw = _rms_bwd_close(got[2], want[2], _rms_bwd_tol(
        torch, want[2], "dw", s, ct, eps))
    if not (share <= 1 and okw and torch.equal(got[0], got[1])):
        raise AssertionError(f"rms_norm_residual backward: d_s share "
                             f"{share}, dw ok {okw} (share {sw})")
    del got, want, part
    ms = _time_ms(lambda: rms_norm_bwd(s, w, ct, eps, grad_sum=g_sum),
                  iters=20)
    with plain_versions():
        plain_ms = _time_ms(lambda: rms_norm_bwd(s, w, ct, eps,
                                                 grad_sum=g_sum), iters=20)
    bms, by = _bound_ms(4 * x.numel() * 2 + 2 * 4096 * 2)
    print(f"rms_norm_residual backward (8192, 4096) bf16: kernel path vs "
          f"plain path max_abs_err d_s={float(err.max()):.3e} (largest "
          f"share of its tolerance {share:.3f}) dw={ew:.3e} ({sw:.3f} of "
          f"its tolerance); the backward kernel through s with g_sum added "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms=none "
          f"bound_ms={bms:.5f} ({by}; s, grad, g_sum in, d_s out, w, dw)")


def check_xent(torch, res_fwd, res_bwd):
    """The softmax cross-entropy kernels against their plain versions
    (the JAX scan route) on the same inputs: ERNIE-MoE's loss rows
    (16384, 30522) fp32 (the main shape: the logits after the black
    cast) and Llama-2's vocab (8192, 32000) in fp32 and bf16. Logits
    2·N(0, 1), random labels, random per-row cotangents.

    Tolerances: nll and lse 1e-5 absolute (fp32 sums of 30522 exps in
    another order; lse ~ 12, whose ulp is 1e-6). dx per element within
    8 fp32 ulps of the plain value (the same fp32 operations; expf
    against torch's exp) or, in bf16, one bf16 ulp (2^-7 of the value:
    both round an fp32 value once). Library: ``F.cross_entropy(...,
    reduction="none")`` forward, and its backward (the gradient of that
    call's output) for ``xent_bwd``."""
    import torch.nn.functional as F
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.xent import xent_bwd, xent_fwd
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [("ernie", 16384, 30522, torch.float32),
             ("llama", 8192, 32000, torch.float32),
             ("llama_bf16", 8192, 32000, torch.bfloat16)]
    for name, n, v, dtype in cases:
        x = (2 * torch.randn(n, v, generator=gen, device="cuda")).to(dtype)
        labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                               dtype=torch.int32)
        ga = torch.randn(n, generator=gen, device="cuda")
        gb = torch.randn(n, generator=gen, device="cuda")
        nll, lse = xent_fwd(x, labels)
        dx = xent_bwd(x, labels, lse, ga, gb)
        with ops.plain_versions():
            pnll, plse = xent_fwd(x, labels)
            pdx = xent_bwd(x, labels, lse, ga, gb)
        torch.cuda.synchronize()
        err_f = max(_max_err(nll, pnll), _max_err(lse, plse))
        diff = (dx.float() - pdx.float()).abs()
        err_b = float(diff.max())
        rtol = 2.0 ** -20 if dtype == torch.float32 else 2.0 ** -7
        share = float((diff / (rtol * pdx.float().abs() + 1e-30)).max())
        del diff, pdx, pnll, plse
        if not (err_f <= 1e-5 and share <= 1.0 and dx.dtype == dtype):
            raise AssertionError(f"xent {name}: forward max abs err {err_f} "
                                 f"(tol 1e-5), backward largest share of "
                                 f"its per-element tol {share}")
        ms_f = _time_ms(lambda: xent_fwd(x, labels), iters=20)
        ms_b = _time_ms(lambda: xent_bwd(x, labels, lse, ga, gb), iters=20)

        def plain_f():
            with ops.plain_versions():
                return xent_fwd(x, labels)

        def plain_b():
            with ops.plain_versions():
                return xent_bwd(x, labels, lse, ga, gb)

        pf_ms, pb_ms = _time_eager(plain_f, 3), _time_eager(plain_b, 3)
        lab64 = labels.long()
        lib_f = _time_eager(lambda: F.cross_entropy(x, lab64,
                                                    reduction="none"), 10)
        xr = x.detach().requires_grad_()
        lo = F.cross_entropy(xr, lab64, reduction="none")
        lib_b = _time_eager(lambda: torch.autograd.grad(
            lo, xr, ga, retain_graph=True), 10)
        del xr, lo
        elt = x.element_size()
        bf = _bound_ms(n * v * elt + 12 * n)
        bb = _bound_ms(2 * n * v * elt + 16 * n)
        print(f"xent {name} ({n}, {v}) {str(dtype)[6:]}: fwd max_abs_err="
              f"{err_f:.3e} (tol 1e-5) kernel_ms={ms_f:.5f} plain_ms="
              f"{pf_ms:.4f} library_ms={lib_f:.5f} bound_ms={bf[0]:.5f} "
              f"({bf[1]}); bwd max_abs_err={err_b:.3e} (largest share of "
              f"its per-element tol {share:.3f}) kernel_ms={ms_b:.5f} "
              f"plain_ms={pb_ms:.4f} library_ms={lib_b:.5f} bound_ms="
              f"{bb[0]:.5f} ({bb[1]})")
        if name == "ernie":
            res_fwd.update(max_abs_err=err_f, ms=ms_f, plain_ms=pf_ms,
                           bound_ms=bf[0], bound_by=bf[1], library_ms=lib_f)
            res_bwd.update(max_abs_err=err_b, ms=ms_b, plain_ms=pb_ms,
                           bound_ms=bb[0], bound_by=bb[1], library_ms=lib_b)
        del x, labels, ga, gb, nll, lse, dx
        torch.cuda.empty_cache()
    print("  (xent library: F.cross_entropy(reduction='none') and the "
          "gradient of its output; plain: the JAX scan route's order)")


def check_moe_gather(torch, results):
    """The MoE row gather against its plain version at the dispatch
    shape of the ERNIE-MoE phase: 40960 rows of a (16384, 768) source
    (E·cap = 8 · 5120 slots from 16 x 1024 tokens), ~20% of the indices
    out of range (the unfilled-slot sentinel T), fp32 (the main shape)
    and bf16. The result must equal the plain version bit for bit (a
    copy). Library: ``index_select`` on the clamped indices (the nearest
    single call; it does not zero the out-of-range rows)."""
    from paddle_tpu_torch.ops.moe_dispatch import (gather_rows_reference,
                                                   moe_gather)
    gen = torch.Generator(device="cuda").manual_seed(12)
    t, d, m = 16384, 768, 40960
    idx = torch.randint(0, t, (m,), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[torch.rand(m, generator=gen, device="cuda") < 0.2] = t
    valid = int(((idx >= 0) & (idx < t)).sum())
    safe = idx.long().clamp(0, t - 1)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
        want = gather_rows_reference(x, idx)
        plain_ms = _time_ms(lambda: gather_rows_reference(x, idx))
        lib_ms = _time_ms(lambda: x.index_select(0, safe))
        elt = x.element_size()
        bms, by = _bound_ms(valid * d * elt + m * d * elt + 4 * m)
        got = moe_gather(x, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"moe_gather {dtype}: differs from the "
                                 f"plain version")
        ms = _time_ms(lambda: moe_gather(x, idx))
        print(f"moe_gather {str(dtype)[6:]:8s}: m={m} of ({t}, {d}), "
              f"{m - valid} out of range: bit-equal kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
              f"(index_select, clamped) bound_ms={bms:.5f} ({by})")
        if dtype == torch.float32:
            results.update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, library_ms=lib_ms)
        del x, want, got
    torch.cuda.empty_cache()


def _bf16_shares(got, want):
    """The largest share of each of (p, m, v)'s per-element tolerance:
    one bf16 ulp (2^-7 relative: both sides round once from fp32, and
    the kernel's contracted FMA may move an fp32 result across a
    rounding boundary) plus one fp32 ulp of the largest entry."""
    shares = []
    for a, b in zip(got, want):
        w = b.float()
        tol = 2.0 ** -7 * w.abs() + 2.0 ** -23 * float(w.abs().max())
        shares.append(float(((a.float() - w).abs() / tol).max()))
        del w, tol
    return shares


def check_adamw_bf16_moments(torch):
    """AdamW with bf16 moments (``multi_precision=False`` on a bf16
    model) on one ERNIE-MoE expert stack, 8 x 768 x 3072 = 18.9M bf16
    elements, bf16 gradient, in place, the lr and the step read from
    device memory, at steps 1, 2 and 1000. Both sides compute in
    fp32 and round p, m and v once, so each within one bf16 ulp (the
    kernel's contracted FMA may move an fp32 result across a rounding
    boundary) plus one fp32 ulp of the largest entry. Library:
    ``torch._fused_adamw_`` on the same bf16 tensors."""
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import fused_adamw
    gen = torch.Generator(device="cuda").manual_seed(13)
    n = 8 * 768 * 3072
    p = (0.02 * torch.randn(n, generator=gen, device="cuda")).bfloat16()
    g = (1e-3 * torch.randn(n, generator=gen, device="cuda")).bfloat16()
    m = (1e-4 * torch.randn(n, generator=gen, device="cuda")).bfloat16()
    v = (1e-8 * torch.rand(n, generator=gen, device="cuda")).bfloat16()
    hp = _adamw_hp(torch)
    by_step, (kp, km, kv) = _adamw_steps(torch, p, g, m, v, hp, _bf16_shares)
    shares = [max(s[i] for s in by_step.values()) for i in range(3)]
    err = _max_err(kp, p)
    if not max(shares) <= 1.0:
        raise AssertionError(f"adamw bf16 moments: largest shares of the "
                             f"per-element tol (p, m, v) by step {by_step}")
    ms = _time_eager(lambda: fused_adamw(kp, g, km, kv, **hp), iters=20)

    def plain():
        with plain_versions():
            fused_adamw(p, g, m, v, **hp)

    plain_ms = _time_eager(plain, iters=5)
    steps = [torch.tensor(2.0, device="cuda")]
    lib_ms = _time_eager(lambda: torch._fused_adamw_(
        [kp], [g], [km], [kv], [], steps, lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False), iters=20)
    bms, by = _bound_ms(n * (2 + 2 + 2 + 2 + 2 + 2 + 2))
    print(f"adamw n={n} bf16 p, g, m, v (multi_precision=False), lr and "
          f"step on the device, steps {ADAMW_STEPS}: max_abs_err p (last "
          f"step) {err:.3e}, largest shares of the per-element tol "
          f"(p, m, v) {', '.join(f'{x:.3f}' for x in shares)} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{lib_ms:.4f} (torch._fused_adamw_) bound_ms={bms:.4f} ({by})")


def check_headline_kernels(torch, results):
    """RMSNorm (forward and backward), RoPE and AdamW at the shapes the
    headline training path (phase 9) gives them, each against its plain
    version, timed beside its bound, the plain version and the library
    call (flash at its headline shape is in :func:`check_flash`):

    - RMSNorm on (16384, 2048) bf16 rows (8 x 2048 tokens, hidden 2048):
      the forward at ``RMS_BF16_TOL``, the backward at ``_rms_bwd_tol``;
    - RoPE on q and k (8, 2048, 16, 128) bf16 with the model's tables,
      one launch, forward and backward, one bf16 ulp of the largest term;
    - AdamW with bf16 p, g, m and v on the largest stack, (16, 5632,
      2048) = 184.5M elements (a grid that strides over 23M groups of 8
      with 64-bit offsets), step 3, each output within one bf16 ulp plus
      one fp32 ulp of the largest entry, and the last group updated.

    ``results`` gets one row a kernel (``rms_norm``, ``rms_norm_bwd``,
    ``rope``, ``adamw``) for the kernels line."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import (
        _rope_pair, fused_adamw, rms_norm, rms_norm_backward_reference,
        rms_norm_bwd, rms_norm_reference)
    from tools.port_train_bench import headline_big_config
    cfg = headline_big_config()
    gen = torch.Generator(device="cuda").manual_seed(17)
    eps, h = cfg.rms_norm_eps, cfg.hidden_size
    rows = 8 * 2048

    x = torch.randn(rows, h, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).bfloat16()
    ct = torch.randn(rows, h, generator=gen, device="cuda").bfloat16()
    y, want = rms_norm(x, w, eps), rms_norm_reference(x, w, eps)
    torch.cuda.synchronize()
    err = _max_err(y, want)
    if not torch.allclose(y.float(), want.float(), atol=RMS_BF16_TOL[0],
                          rtol=RMS_BF16_TOL[1]):
        raise AssertionError(f"rms_norm {tuple(x.shape)} bf16: max abs err "
                             f"{err}")
    bms, by = _bound_ms(2 * x.numel() * 2 + h * 2)
    results["rms_norm"] = dict(
        max_abs_err=err, ms=_time_ms(lambda: rms_norm(x, w, eps), iters=20),
        plain_ms=_time_ms(lambda: rms_norm_reference(x, w, eps), iters=20),
        bound_ms=bms, bound_by=by,
        library_ms=_time_ms(lambda: F.rms_norm(x, (h,), w, eps), iters=20))
    dx, dw = rms_norm_bwd(x, w, ct, eps)
    pdx, pdw = rms_norm_backward_reference(x, w, ct, eps)
    torch.cuda.synchronize()
    okx, ex, sx = _rms_bwd_close(dx, pdx, _rms_bwd_tol(torch, pdx, "dx"))
    okw, ew, sw = _rms_bwd_close(
        dw, pdw, _rms_bwd_tol(torch, pdw, "dw", x, ct, eps))
    if not (okx and okw):
        raise AssertionError(f"rms_norm_bwd {tuple(x.shape)} bf16: dx "
                             f"share {sx}, dw share {sw}")
    del dx, dw, pdx, pdw
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    with torch.cuda.stream(side):
        ylib = F.rms_norm(xl, (h,), wl, eps)
    bms, by = _bound_ms(3 * x.numel() * 2 + 2 * h * 2)
    results["rms_norm_bwd"] = dict(
        max_abs_err=max(ex, ew),
        ms=_time_ms(lambda: rms_norm_bwd(x, w, ct, eps), iters=20),
        plain_ms=_time_ms(lambda: rms_norm_backward_reference(
            x, w, ct, eps), iters=20),
        bound_ms=bms, bound_by=by,
        library_ms=_time_ms(lambda: torch.autograd.grad(
            ylib, (xl, wl), ct, retain_graph=True), iters=20, stream=side))
    torch.cuda.synchronize()
    del x, w, ct, y, want, xl, wl, ylib

    b, s, nh, d = 8, 2048, cfg.num_attention_heads, cfg.head_dim
    cos, sin = (t[:s].bfloat16() for t in _rope_cache(cfg, "cuda"))
    q, k = (torch.randn(b, s, nh, d, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    tol = 2.0 ** -7 * 2 * float(max(q.float().abs().max(),
                                    k.float().abs().max()))
    err = 0.0
    for sign in (1.0, -1.0):
        got = _rope_pair(q, k, cos, sin, sign)
        with plain_versions():
            want = _rope_pair(q, k, cos, sin, sign)
        torch.cuda.synchronize()
        err = max([err] + [_max_err(a, r) for a, r in zip(got, want)])
    if not err <= tol:
        raise AssertionError(f"rope {(b, s, nh, d)} bf16: max abs err "
                             f"{err} > {tol}")

    def rope_plain():
        with plain_versions():
            return _rope_pair(q, k, cos, sin, 1.0)

    bms, by = _bound_ms(4 * q.numel() * 2 + 2 * s * d * 2)
    results["rope"] = dict(
        max_abs_err=err,
        ms=_time_ms(lambda: _rope_pair(q, k, cos, sin, 1.0)),
        plain_ms=_time_ms(rope_plain), bound_ms=bms, bound_by=by,
        library_ms=None)
    del q, k, got, want

    shape = (cfg.num_hidden_layers, cfg.intermediate_size, h)
    n = math.prod(shape)
    p = (0.02 * torch.randn(shape, generator=gen, device="cuda")).bfloat16()
    g = (1e-3 * torch.randn(shape, generator=gen, device="cuda")).bfloat16()
    m = (1e-4 * torch.randn(shape, generator=gen, device="cuda")).bfloat16()
    v = (1e-8 * torch.rand(shape, generator=gen, device="cuda")).bfloat16()
    hp = _adamw_hp(torch)
    by_step, (kp, km, kv) = _adamw_steps(torch, p, g, m, v, hp, _bf16_shares)
    shares = [max(s[i] for s in by_step.values()) for i in range(3)]
    last = not torch.equal(km.view(-1)[-8:], m.view(-1)[-8:])
    if not (max(shares) <= 1.0 and last):
        raise AssertionError(f"adamw {shape} bf16 moments: largest shares "
                             f"(p, m, v) by step {by_step}")
    err = _max_err(kp, p)
    p, m, v = kp.clone(), km.clone(), kv.clone()    # the plain run's state

    def adamw_plain():
        with plain_versions():
            fused_adamw(p, g, m, v, **hp)

    steps = [torch.tensor(2.0, device="cuda")]
    bms, by = _bound_ms(n * 7 * 2)
    results["adamw"] = dict(
        max_abs_err=err,
        ms=_time_eager(lambda: fused_adamw(kp, g, km, kv, **hp), iters=20),
        plain_ms=_time_eager(adamw_plain, iters=3), bound_ms=bms,
        bound_by=by, library_ms=_time_eager(lambda: torch._fused_adamw_(
            [kp], [g], [km], [kv], [], steps, lr=1e-4, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False), iters=20))
    del p, g, m, v, kp, km, kv
    torch.cuda.empty_cache()
    for name, row in results.items():
        print(f"headline {name}: " + " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items()))
    print(f"headline adamw {shape} bf16 p, g, m, v, lr and step on the "
          f"device, steps {ADAMW_STEPS}: largest shares of the "
          f"per-element tol (p, m, v) "
          f"{', '.join(f'{x:.3f}' for x in shares)}")


def _decode_layer_tol(d, ff):
    """Absolute tolerance on a decode layer's output, megakernel against
    its plain version, for unit-scale inputs and weights of nn.Linear's
    init (every intermediate O(1)): the five products sum up to
    K = max(d, ff) fp32 terms in another order than cuBLAS, each
    reassociation moving a sum by about u sqrt(K) of its terms' scale
    (u = 2^-24); attention, both RMSNorms and the residuals add a few
    ulp. 8 u sqrt(K) per product covers the tail over every output: at
    Llama-2-7B width (K = 11008) 2.5e-4."""
    return 5 * 8 * 2.0 ** -24 * math.sqrt(max(d, ff))


def _device_ms(torch, fn, name=None, iters=10):
    """Device time of one call of ``fn`` from the profiler over ``iters``
    calls: of the kernel whose name contains ``name`` (one launch), or
    of every device event of the call (the host's dispatch left out);
    None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count
              and (name is None or name in e.key)]
    total = sum(e.self_device_time_total for e in events)
    if total <= 0:
        return None
    if name is not None:
        return total / sum(e.count for e in events) / 1e3
    return total / iters / 1e3


def check_decode_layer(torch, res_fp32, res_int8):
    """The decode-layer megakernel against its plain version at the
    megakernel serving phase's shapes: one Llama-2-7B layer
    (``LlamaDecoderLayer`` on the card with nn.Linear's default init,
    norm weights 1 + 0.1 N(0, 1)), x ~ N(0, 1). fp32 arena: S = 8,
    block 16, 64 table entries, lengths 1 (one row), 16 (a block
    boundary), 100, 1024 (the full table), 513, 250, 33, and one slot
    at position 1030, past the table: its write goes to the trash block
    and its read covers the whole table. int8 arena: S = 32, 128
    entries, lengths 1025 + 32 i. Held: the output within
    ``_decode_layer_tol`` of the plain version, the arena the prologue
    writes equal to the plain version's outside the trash block, two
    calls bit-identical (the kernel's split-K sums and table-walk merges
    run in fixed orders). Printed: the megakernel alone against its own
    bound (the weights it reads, the KV, its inputs and outputs and its
    scratch, written once), the phases' microseconds, the host plan. Times:
    the wrapper (torch prologue + one cooperative launch; CUDA events,
    and its device time from the profiler) and the megakernel alone
    (profiler), the plain version, and the unfused layer on the same
    inputs (the port's route without the megakernel: RMSNorm and
    paged-decode kernels, cuBLAS products; events and device time). No
    single PyTorch call computes this function (library: none)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models.llama import (LlamaDecoderLayer,
                                               _rope_cache, llama_7b_config)
    from paddle_tpu_torch.ops.decode_layer import (BAND_ROWS,
                                                   DecodeLayerScratch, _grid,
                                                   decode_layer, layer_plan,
                                                   phase_us)
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    cfg = llama_7b_config()
    torch.manual_seed(11)          # nn.Linear's init uses the global one
    layer = LlamaDecoderLayer(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(12)
    with torch.no_grad():
        for norm in (layer.input_layernorm, layer.post_attention_layernorm):
            norm.weight.add_(0.1 * torch.randn(cfg.hidden_size,
                                               generator=gen,
                                               device="cuda"))
    cos, sin = _rope_cache(cfg, "cuda")
    wts = layer._decode_layer_weights()
    d, ff, h = cfg.hidden_size, cfg.intermediate_size, \
        cfg.num_attention_heads
    kvh, dh, eps = cfg.num_key_value_heads, cfg.head_dim, cfg.rms_norm_eps
    tol = _decode_layer_tol(d, ff)
    bs = 16
    cases = [("fp32", "paged", 64, [1, 16, 100, 1024, 513, 250, 33, 1031],
              res_fp32),
             ("int8", "paged_int8", 128, [1025 + 32 * i for i in range(32)],
              res_int8)]
    for label, mode, mb, lengths, results in cases:
        S = len(lengths)
        nb = 1 + S * mb
        pos = torch.tensor([L - 1 for L in lengths], dtype=torch.int32,
                           device="cuda")
        table = torch.zeros(S, mb, dtype=torch.int32)
        perm = (torch.randperm(nb - 1, generator=torch.Generator()
                               .manual_seed(13)) + 1).tolist()
        for r, L in enumerate(lengths):
            n = min(-(-L // bs), mb)
            table[r, :n] = torch.tensor(perm[:n], dtype=torch.int32)
            perm = perm[n:]
        table = table.cuda()
        shape = (nb, bs, kvh, dh)
        if mode == "paged_int8":
            cache = [*quantize_kv(torch.randn(shape, generator=gen,
                                              device="cuda")),
                     *quantize_kv(torch.randn(shape, generator=gen,
                                              device="cuda"))]
            cache = [cache[0], cache[2], cache[1], cache[3]]
        else:
            cache = [torch.randn(shape, generator=gen, device="cuda")
                     for _ in range(2)]
        copies = [[c.clone() for c in cache] for _ in range(3)]
        del cache
        x = torch.randn(S, 1, d, generator=gen, device="cuda")
        fixed = (x, cos, sin, eps, eps, pos, table)
        scratch = DecodeLayerScratch()

        def kern():
            return decode_layer(mode, *fixed, *copies[0], *wts,
                                scratch=scratch)[0]

        def plain():
            with ops.plain_versions():
                return decode_layer(mode, *fixed, *copies[1], *wts)[0]

        def unfused():
            return layer(x, cos, sin, tuple(copies[2]), pos, table)

        with torch.inference_mode():
            got, want, unf = kern(), plain(), unfused()
            torch.cuda.synchronize()
            err, err_unf = _max_err(got, want), _max_err(unf, want)
            if not (torch.isfinite(got).all() and err <= tol
                    and err_unf <= tol):
                raise AssertionError(
                    f"decode_layer {label}: max abs err {err} (unfused "
                    f"{err_unf}), tolerance {tol}")
            for a, b in zip(copies[0], copies[1]):
                if not torch.equal(a[1:], b[1:]):
                    raise AssertionError(f"decode_layer {label}: the "
                                         "prologue's arena write differs")
            # fixed reduction orders: a second call (the same arena write)
            # gives the same bits
            if not torch.equal(kern(), got):
                raise AssertionError(f"decode_layer {label}: two calls "
                                     "differ")
            ms = _time_eager(kern, iters=20)
            kernel_ms = _device_ms(torch, kern, "decode_layer_kernel")
            dev_ms = _device_ms(torch, kern)
            plain_ms = _time_eager(plain, iters=3)
            unfused_ms = _time_eager(unfused, iters=20)
            unfused_dev_ms = _device_ms(torch, unfused)
            # per-phase microseconds from the kernel's %globaltimer
            # stamps (thread 0 of CTA 0 after each grid barrier), the
            # median of 9 launches
            stamps = torch.zeros(6, dtype=torch.int64, device="cuda")
            runs = []
            for _ in range(9):
                decode_layer(mode, *fixed, *copies[0], *wts,
                             scratch=scratch, stamps=stamps)
                torch.cuda.synchronize()
                runs.append(phase_us(stamps))
            phases = {k: sorted(r[k] for r in runs)[len(runs) // 2]
                      for k in runs[0]}
        elt = 1 if mode == "paged_int8" else 4
        row_bytes = kvh * (dh * elt + (4 if mode == "paged_int8" else 0))
        rows_read = sum(min(-(-L // bs), mb) * bs for L in lengths)
        w_bytes = sum(w.numel() * 4 for w in wts)
        nbytes = w_bytes + 2 * rows_read * row_bytes + 2 * S * row_bytes \
            + 2 * S * d * 4
        flops = 2 * S * sum(w.numel() for w in wts if w.dim() == 2) \
            + 4 * h * dh * sum(min(L, mb * bs) for L in lengths)
        bms, by = _bound_ms(nbytes, flops, FP32_FLOPS)
        # the megakernel alone: the weights it reads (wq, wo, ln2, wg, wu,
        # wd), the KV, x, r1, cos, sin and out, and its scratch written
        # once (q, attn, h1, act, the partial sums of its plan)
        plan = layer_plan(S, d, h, dh, ff, mb, _grid(mode, S, dh, x.device))
        part = sum(plan[i] * plan[i + 1] * S * BAND_ROWS
                   for i in range(0, 12, 3)) + S * h * plan[13] * (dh + 2)
        k_bytes = 4 * sum(w.numel() for w in (wts[1], wts[4], wts[5],
                                                wts[6], wts[7], wts[8])) \
            + 2 * rows_read * row_bytes + 4 * (3 * S * d + 2 * S * dh) \
            + 4 * (2 * S * h * dh + S * d + S * ff + part)
        k_flops = 2 * S * sum(wts[i].numel() for i in (1, 4, 6, 7, 8)) \
            + 4 * h * dh * sum(min(L, mb * bs) for L in lengths)
        kbms, kby = _bound_ms(k_bytes, k_flops, FP32_FLOPS)
        kms, dms, udms = ("not measured" if v is None else f"{v:.4f}"
                          for v in (kernel_ms, dev_ms, unfused_dev_ms))
        print(f"decode_layer {label} S={S} d={d} h={h} kvh={kvh} ff={ff} "
              f"bs={bs} mb={mb} lengths {min(lengths)}..{max(lengths)}: "
              f"max_abs_err={err:.3e} (unfused layer {err_unf:.3e}; tol "
              f"{tol:.3e}) ms={ms:.4f} (wrapper: prologue + 1 launch; "
              f"device {dms}) megakernel_ms={kms} plain_ms={plain_ms:.4f} "
              f"unfused_layer_ms={unfused_ms:.4f} (device {udms}) "
              f"library_ms=none bound_ms={bms:.4f} ({by}, "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        share = "not measured" if kernel_ms is None \
            else f"{kbms / kernel_ms:.3f}"
        print(f"decode_layer {label} megakernel alone: {kms} ms against "
              f"its bound {kbms:.4f} ms ({kby}, {k_bytes / 1e6:.1f} MB, "
              f"{k_flops / 1e9:.2f} GFLOP; share {share}); the wrapper's "
              f"device time {dms} ms against the unfused layer's {udms} "
              f"ms and the layer bound {bms:.4f} ms; plan {plan}")
        print(f"decode_layer {label} phases (us, median of 9 launches): "
              + " ".join(f"{k.split()[0]}={v:.2f}" for k, v in
                         phases.items())
              + f" total={sum(phases.values()):.2f}")
        results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=None,
                       megakernel_ms=kernel_ms, device_ms=dev_ms,
                       megakernel_bound_ms=kbms, phases_us=phases,
                       unfused_layer_ms=unfused_ms,
                       unfused_layer_device_ms=unfused_dev_ms)
        del copies, got, want, unf, scratch
        torch.cuda.empty_cache()
    del layer, wts
    torch.cuda.empty_cache()


def check_rms_norm_residual(torch, results):
    """The residual RMSNorm kernel against its plain version (``_rms_ref``
    with a residual) at (8, 4096) fp32 and (8192, 4096) bf16: the sum
    x + r bit-equal (both round one fp32 sum to x's dtype), the normed
    output within RMSNorm's tolerances (fp32 1e-5; bf16
    ``RMS_BF16_TOL``). Bound: bytes, x, r, out and the sum once each
    and the weight. No single PyTorch call computes both outputs
    (library: none)."""
    from paddle_tpu_torch.ops.fused import (rms_norm_residual,
                                            rms_norm_residual_reference)
    gen = torch.Generator(device="cuda").manual_seed(14)
    h, eps = 4096, 1e-5
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: RMS_BF16_TOL}
    for dtype, rows in ((torch.float32, 8), (torch.bfloat16, 8192)):
        x = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
        r = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
             ).to(dtype)
        out, total = rms_norm_residual(x, r, w, eps)
        want, want_total = rms_norm_residual_reference(x, r, w, eps)
        torch.cuda.synchronize()
        err = _max_err(out, want)
        atol, rtol = tol[dtype]
        if not (torch.equal(total, want_total) and torch.allclose(
                out.float(), want.float(), atol=atol, rtol=rtol)):
            raise AssertionError(
                f"rms_norm_residual {dtype} rows={rows}: max abs err {err},"
                f" sum equal {torch.equal(total, want_total)}")
        ms = _time_ms(lambda: rms_norm_residual(x, r, w, eps))
        plain_ms = _time_ms(lambda: rms_norm_residual_reference(x, r, w,
                                                                eps))
        nbytes = 4 * rows * h * x.element_size() + h * w.element_size()
        bms, by = _bound_ms(nbytes)
        print(f"rms_norm_residual {str(dtype)[6:]:8s} rows={rows:4d} h={h}: "
              f"max_abs_err={err:.3e} (sum bit-equal) kernel_ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms=none "
              f"bound_ms={bms:.6f} ({by})")
        if (dtype, rows) == (torch.float32, 8):
            results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, library_ms=None)


def rms_residual_entry(torch):
    """The residual RMSNorm's entry point as a caller uses it:
    ``fused_rms_norm(x, w, eps, residual=r)`` along a pre-norm residual
    stream of four blocks at (8192, 4096) bf16 (the training step's
    rows and width), forward and backward, counters zeroed just before
    and read just after: four launches of the forward kernel and four of
    the backward kernel. Returns the launch counts."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.fused import fused_rms_norm
    gen = torch.Generator(device="cuda").manual_seed(15)
    hidden = torch.randn(8192, 4096, generator=gen, device="cuda",
                         dtype=torch.bfloat16).requires_grad_()
    ws = [(1 + 0.1 * torch.randn(4096, generator=gen, device="cuda"))
          .bfloat16().requires_grad_() for _ in range(4)]
    ops.reset_launch_counts()
    stream, delta = hidden, torch.zeros_like(hidden)
    for w in ws:
        normed, stream = fused_rms_norm(delta, w, 1e-5, residual=stream)
        delta = normed * 0.5
    loss = delta.float().square().mean()
    loss.backward()
    loss = loss.detach()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    grads = [hidden.grad] + [w.grad for w in ws]
    if counts["rms_norm_residual"] != 4 or counts["rms_norm_bwd"] != 4 \
            or not all(g is not None and bool(torch.isfinite(g).all())
                       for g in grads):
        raise AssertionError(f"residual entry point: launches {counts}, "
                             f"finite grads {[g is not None for g in grads]}")
    print(f"fused_rms_norm(residual=) entry point, 4 blocks of (8192, 4096) "
          f"bf16 fwd + bwd: loss {loss.item():.6f}, launches "
          f"rms_norm_residual={counts['rms_norm_residual']} "
          f"rms_norm_bwd={counts['rms_norm_bwd']}")
    return counts


def _train_loss(model, batch):
    loss, _ = model(*batch)
    return loss


def _grads(torch, model, batch, plain):
    """(loss, {name: fp32 grad}) of one forward and backward, with the
    kernels or under ``ops.plain_versions()``; no update. A stacked
    trunk's weights are split per layer (``name[i]``)."""
    import contextlib
    from paddle_tpu_torch import ops
    model.zero_grad(set_to_none=True)
    with ops.plain_versions() if plain else contextlib.nullcontext():
        loss = _train_loss(model, batch)
        loss.backward()
    out = {}
    for n, p in model.named_parameters():
        if "__" in n:               # a stacked (L, ...) weight: each layer
            for i, g in enumerate(p.grad.unbind(0)):
                out[f"{n}[{i}]"] = g.float()
        else:
            out[n] = p.grad.float()
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def compare_plain(torch, model, cfg, b1):
    """Kernels vs plain versions on the training model's initial weights
    at batch 1, forward and backward, no update. First an fp32 copy of
    the weights (the bf16 values, exact in fp32): there the kernels and
    the plain versions differ only by summation order, so the loss to
    1e-4 and every parameter's gradient to 1e-3 relative (the norm of
    the difference over the norm). Then the bf16 model itself, held
    against that fp32 gradient: bf16 rounds at other sites in the kernels
    than in the plain versions (RoPE rounds once instead of per product;
    flash rounds the unnormalised probabilities and ds, the plain
    versions the normalised probabilities and nothing in the backward),
    so each parameter's bf16 gradient with the kernels must be no
    further from the fp32 one than 1.1 times the plain versions' is;
    the bf16 losses within 2e-2 of each other. The bf16 gradients lie
    several percent from their fp32 values at initialisation whichever
    path runs, so this check guards the wiring; the per-element kernel
    checks guard the kernels' arithmetic."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    ref = LlamaForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           seed=0)
    ref.load_state_dict({n: p.float() for n, p in
                         model.state_dict().items()})
    l32p, g32 = _grads(torch, ref, b1, plain=True)
    l32k, g32k = _grads(torch, ref, b1, plain=False)
    del ref
    rel32 = {n: _rel(g32k[n], g32[n]) for n in g32}
    del g32k
    lk, gk = _grads(torch, model, b1, plain=False)
    ek = {n: _rel(gk[n], g32[n]) for n in g32}
    bad = [n for n, g in gk.items() if not torch.isfinite(g).all()]
    del gk
    lp, gp = _grads(torch, model, b1, plain=True)
    ep = {n: _rel(gp[n], g32[n]) for n in g32}
    del gp, g32
    torch.cuda.empty_cache()

    def stats(d):
        worst = max(d, key=d.get)
        return (f"max {d[worst]:.3e} ({worst}), median "
                f"{sorted(d.values())[len(d) // 2]:.3e}")

    ratio = {n: ek[n] / max(ep[n], 1e-12) for n in ek}
    print(f"batch-1 fp32 weights, kernels vs plain: loss {l32k:.6f} vs "
          f"{l32p:.6f} (|diff| {abs(l32k - l32p):.3e}, tol 1e-4); grad "
          f"relative error {stats(rel32)} (tol 1e-3)")
    print(f"batch-1 bf16 model: loss kernels {lk:.6f} plain {lp:.6f} "
          f"fp32 {l32p:.6f} (|kernels - plain| {abs(lk - lp):.3e}, tol "
          f"2e-2); grad error vs fp32: kernels {stats(ek)}; plain "
          f"{stats(ep)}; ratio kernels/plain {stats(ratio)} (tol "
          f"kernels <= 1.1 x plain)")
    over = [n for n in ek if ek[n] > 1.1 * ep[n]]
    if bad or abs(l32k - l32p) > 1e-4 or max(rel32.values()) > 1e-3 \
            or abs(lk - lp) > 2e-2 or over:
        raise AssertionError(f"kernels vs plain: non-finite {bad}, fp32 "
                             f"loss {l32k} vs {l32p}, over tolerance "
                             f"{over}")


def _eager_steps(model, loss_fn, opt, batches):
    """The hand-written eager loop a captured ``TrainStep`` is held
    against: forward, backward, ``opt.step()``, ``clear_grad`` per batch.
    Returns the losses (device tensors)."""
    losses = []
    for b in batches:
        opt.clear_grad()
        loss = loss_fn(model, b)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach().clone())
    return losses


def _states(model, opt):
    """Every parameter and optimizer state of ``(model, opt)`` by name
    (the live tensors), and the device step count."""
    out = {}
    for n, p in model.named_parameters():
        out[n] = p.detach()
        for k, v in opt._slots.get(id(p), {}).items():
            out[f"{n}.{k}"] = v
    out["@step"] = int(opt._step_tensor)
    return out


def _snapshot(model, opt, device="cpu"):
    """``_states`` copied to ``device``."""
    return {k: v if k == "@step" else v.to(device, copy=True)
            for k, v in _states(model, opt).items()}


def _check_captured(torch, label, step, want_losses, want, got_losses):
    """The captured step against the eager loop: losses, every parameter,
    every optimizer state (moments, fp32 masters) and the step count
    bit-equal, and one capture. Prints the largest difference of each
    kind either way."""
    model, opt = step.model, step.optimizer
    got = _states(model, opt)
    if set(got) != set(want):
        raise AssertionError(f"{label}: captured and eager states hold "
                             f"other tensors")
    diff, unequal = {}, []
    for k, w in want.items():
        if k == "@step":
            continue
        g = got[k]
        wd = w.to(g.device)
        if not torch.equal(g, wd):
            unequal.append(k)
            kind = k.rsplit(".", 1)[-1] if "." in k else "param"
            kind = kind if kind in ("moment1", "moment2", "master") \
                else "param"
            diff[kind] = max(diff.get(kind, 0.0), _max_err(g, wd))
        del wd
    got_losses = [float(x) for x in got_losses]
    want_losses = [float(x) for x in want_losses]
    loss_eq = [a == b for a, b in zip(got_losses, want_losses)]
    print(f"{label} captured vs eager loop over {want['@step']} steps: "
          f"losses {', '.join(f'{x:.6f}' for x in got_losses)} "
          f"(eager {', '.join(f'{x:.6f}' for x in want_losses)}), "
          f"bit-equal {loss_eq}; {len(want) - 1} parameters and states, "
          f"{len(unequal)} not bit-equal (largest |diff| {diff}); step "
          f"{got['@step']} (eager {want['@step']}); captures "
          f"{step.captures}; graph pool {step.graph_bytes / 2**20:.1f} MiB")
    if unequal or not all(loss_eq) or got["@step"] != want["@step"] \
            or step.captures != 1 or len(loss_eq) != len(want_losses):
        raise AssertionError(f"{label}: the captured step differs from the "
                             f"eager loop: {unequal[:8]}, losses {loss_eq}, "
                             f"captures {step.captures}")


def _llama_7b_width(torch):
    """Phase 7's model and optimizer from seed 0: Llama-2-7B's width at 8
    layers, ``amp.decorate`` O2 bf16 with fp32 masters."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.optimizer import AdamW
    cfg = llama_7b_config(num_hidden_layers=8)
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=True)
    amp.decorate(model, opt, level="O2", dtype="bfloat16")
    return cfg, model, opt


def _llama_per_step(L, n_tensors):
    return {"rms_norm": 2 * L + 1, "paged_attention_decode": 0,
            "paged_attention_decode_int8": 0, "flash_attention_fwd": L,
            "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
            "rope": 2 * L, "adamw": n_tensors, "xent_fwd": 0,
            "xent_bwd": 0, "moe_gather": 0, "rms_norm_residual": 0,
            "decode_layer": 0, "decode_layer_int8": 0,
            "rms_norm_bwd": 2 * L + 1}


def train_path(torch, card):
    """The training step at Llama-2-7B's width, 8 layers (see the module
    docstring). Returns the launch counts of its 8 captured steps and
    the idle share of its profiled step."""
    import numpy as np
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import TrainStep
    B, S, compared, timed = 4, 2048, 3, 5
    rs = np.random.RandomState(0)
    cfg, ref, ropt = _llama_7b_width(torch)
    ids = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    batch = (torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda())
    # the eager loop first, its states kept on the host: two models of
    # this width and their AdamW states do not fit on the card together
    want_losses = _eager_steps(ref, _train_loss, ropt, [batch] * compared)
    want = _snapshot(ref, ropt)
    del ref, ropt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, model, opt = _llama_7b_width(torch)
    step = TrainStep(model, _train_loss, opt)
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    n_params = model.num_params()
    print(f"train model: Llama-2-7B width, {L} layers, "
          f"{n_params / 1e9:.4f}B params bf16 (O2) on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    compare_plain(torch, model, cfg, (batch[0][:1], batch[1][:1]))
    n_tensors = len(list(model.parameters()))
    per_step = _llama_per_step(L, n_tensors)
    if n_tensors != 9 * L + 3:
        raise AssertionError(f"{n_tensors} parameter tensors, expected "
                             f"{9 * L + 3}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, times, got_losses = [], [], []
    for i in range(compared + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)            # ends in the loss's host read
        times.append(time.perf_counter() - t0)
        losses.append(step.last_loss)
        if i < compared:
            got_losses.append(loss)
        if i == compared - 1:
            _check_captured(torch, "train", step, want_losses, want,
                            got_losses)
            del want
    counts = ops.launch_counts()
    n = compared + timed
    want_counts = {k: n * v for k, v in per_step.items()}
    if counts != want_counts:
        raise AssertionError(f"train launch counts {counts}, expected "
                             f"{want_counts} ({per_step} per step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    for p in model.parameters():
        if not torch.isfinite(p).all():
            raise AssertionError("a parameter went non-finite")
    step_s = sum(times[compared:]) / timed
    tok_s = B * S / step_s
    flops = model.flops_per_token(S) * B * S
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train launches over {n} steps (the first the warm-up, then one "
          f"capture and {n - 1} replays): {counts} (per step {per_step})")
    print(f"train losses: {', '.join(f'{x:.6f}' for x in losses)}")
    print(f"train step times ms (first: warm-up and capture): "
          f"{', '.join(f'{1e3 * x:.2f}' for x in times)}")
    print(f"[{card}] train step_ms={1e3 * step_s:.3f} "
          f"tokens_per_s={tok_s:.1f} tflop_per_step={flops / 1e12:.3f} "
          f"mfu={flops / step_s / BF16_FLOPS:.4f} (vs 989 TFLOP/s bf16) "
          f"peak_mem_gb={peak_gb:.3f} graph_pool_mib="
          f"{step.graph_bytes / 2**20:.1f}")
    idle = profile_train_step(torch, lambda: step(batch), card)
    return counts, idle


def io_path(torch, card, idle7):
    """Phase 10: phase 7's model fed from the ``io`` DataLoader (see the
    module docstring). Returns the launch counts of its 4 steps."""
    import numpy as np
    from paddle_tpu_torch import core, io, ops
    from paddle_tpu_torch.jit import TrainStep
    t_phase = time.perf_counter()
    n_seq, B, S = 16, 4, 2048
    cfg, model, opt = _llama_7b_width(torch)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (n_seq, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)

    class Sequences(io.Dataset):
        def __len__(self):
            return n_seq

        def __getitem__(self, i):
            return ids[i], labels[i]

    loader = io.DataLoader(Sequences(), batch_size=B, num_workers=2,
                           use_shared_memory=True)
    if not (loader._shm_usable() and core.native_available()):
        raise AssertionError("io: the DataLoader's shared-memory ring is not "
                             "native (csrc/shm_ring.cc did not build)")
    step = TrainStep(model, _train_loss, opt)
    per_step = _llama_per_step(cfg.num_hidden_layers,
                               len(list(model.parameters())))
    epochs = 2
    ops.reset_launch_counts()
    fed, idle = [], {}
    for epoch in range(epochs):
        batches = io.device_prefetch(loader, size=2)
        fed.append(step(tuple(next(batches))))
        # the second step's window holds the ring pop, collation and
        # pinned copy of the batch after it (the third's, the loader's
        # end); in the first epoch its pinned block is new (the capture
        # emptied the host allocator's cache), in the second it is reused
        idle[epoch] = profile_train_step(
            torch, lambda: fed.append(step(tuple(next(batches)))), card,
            label=f"io-fed (epoch {epoch + 1})")
        fed += [step(tuple(b)) for b in batches]
    counts = ops.launch_counts()
    n = epochs * n_seq // B
    want = {k: n * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"io launch counts {counts}, expected {want}")
    # the loader's cost to the step, unprofiled (the profiler's
    # instrumentation of a graph launch moves the idle share it reports
    # by several points from launch to launch): a third epoch's steps 2-4
    # (step 1 forks the workers) against the same graph fed a batch that
    # is on the card already, each step ending in its loss read
    walls = {"loader": [], "direct": []}
    batches = io.device_prefetch(loader, size=2)
    step(tuple(next(batches)))
    for _ in range(n_seq // B - 1):
        walls["loader"].append(
            _step_wall(torch, step, lambda: tuple(next(batches))))
    on_card = (torch.from_numpy(ids[:B]).cuda(),
               torch.from_numpy(labels[:B]).cuda())
    for _ in range(3):
        walls["direct"].append(_step_wall(torch, step, lambda: on_card))
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    _, model, opt = _llama_7b_width(torch)
    step = TrainStep(model, _train_loss, opt)
    direct = [step((torch.from_numpy(ids[i:i + B]).cuda(),
                    torch.from_numpy(labels[i:i + B]).cuda()))
              for _ in range(epochs) for i in range(0, n_seq, B)]
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    equal = [bool(torch.equal(a, b)) for a, b in zip(fed, direct)]
    print(f"io: DataLoader(batch_size={B}, num_workers=2) over {n_seq} x "
          f"{S} tokens from RandomState(0), {epochs} epochs, forked "
          f"workers over the native shared-memory ring, "
          f"device_prefetch(size=2) into the captured step: losses "
          f"{', '.join(f'{float(x):.6f}' for x in fed)}; fed directly "
          f"{', '.join(f'{float(x):.6f}' for x in direct)}; bit-equal "
          f"{equal}; launches over {n} steps exact")
    def pct(x):
        return "not measured" if x is None else f"{100 * x:.1f}%"

    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    added = 1 - med["direct"] / med["loader"]
    print(f"[{card}] io step walls ms, loader-fed (epoch 3, steps 2-4): "
          f"{', '.join(f'{1e3 * x:.3f}' for x in walls['loader'])}; fed "
          f"from the card: {', '.join(f'{1e3 * x:.3f}' for x in walls['direct'])}"
          f"; idle added by the loader {100 * added:.2f} points (gate: "
          f"within 2). Profiled idle: loader-fed {pct(idle[1])} (epoch "
          f"2), {pct(idle[0])} (epoch 1, its pinned block new); phase "
          f"7's {pct(idle7)}")
    if added > 0.02:
        raise AssertionError(f"io: the loader adds {added:.4f} of idle to "
                             f"the step ({med})")
    if not all(equal):
        raise AssertionError(f"io: loader-fed losses {fed} differ from the "
                             f"directly fed {direct}")
    print(f"phase 10 (io) took {time.perf_counter() - t_phase:.1f} s")
    return counts


def _step_wall(torch, step, batch):
    """Host wall seconds of ``step(batch())`` (fetching the batch
    included; the call ends in its loss read), from a synchronized
    start."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch())
    return time.perf_counter() - t0


def profile_train_step(torch, run, card, label="train"):
    """Where one training step's time goes: device time by kernel and the
    device's busy share of the host wall time of ``run()`` (one step).
    Returns the idle share, or None when the profiler saw no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us == 0:
        print(f"{label} step profile: the profiler saw no device time "
              "(device busy share not measured)")
        return None
    print(f"[{card}] {label} step profile: wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle)")
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:16]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% "
              f"x{n:<6d} {name[:90]}")
    families = {}
    for name, t, n in kernels:
        fam = _kernel_family(name)
        ms, launches = families.get(fam, (0.0, 0))
        families[fam] = (ms + t / 1e3, launches + n)
    print(f"  by family: " + "; ".join(
        f"{fam} {ms:.3f} ms ({100 * 1e3 * ms / busy_us:.1f}%, x{n})"
        for fam, (ms, n) in sorted(families.items(), key=lambda f: -f[1][0])))
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda k: -k[1])[:6]
    print("  host, by self time (the step's end waits in its loss read): "
          + "; ".join(f"{name[:48]} {t / 1e3:.3f} ms x{n}"
                      for name, t, n in host))
    return 1 - busy_us / wall_us


# device kernel name fragments -> family, for the profiles' breakdown
_FAMILIES = (("flash_", "flash"), ("xent_", "xent"),
             ("gather_rows", "moe_gather"), ("adamw_kernel", "adamw"),
             ("rms_norm_bwd", "rms_norm_bwd"),
             ("rms_norm_kernel", "rms_norm"), ("rope_kernel", "rope"),
             ("gemm", "GEMM"), ("nvjet", "GEMM"), ("xmma", "GEMM"))


def _kernel_family(name: str) -> str:
    for frag, fam in _FAMILIES:
        if frag in name:
            return fam
    return "other (elementwise, copies, reductions)"


def _ernie_loss(model, batch):
    """The bench's ERNIE-MoE loss: the forward under ``auto_cast`` O2."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(dtype="bfloat16", level="O2"):
        return model(*batch)[0]


def _ernie_grads(torch, model, batch, plain, loss_fn, pin=None,
                 pin_aux=True):
    """(loss, {name: fp32 grad}, {MoE layer index: (T, k) routes}) of
    one forward and backward, with the kernels or under
    ``ops.plain_versions()``; no update. The routes are the experts the
    router would pick, read from each gate's logits as the layer reads
    them. With ``pin`` ({MoE layer index: (T, k) routes}, from another
    run) every MoE layer routes by those instead of its own top-k, and
    with ``pin_aux`` its GShard aux loss also counts each token's first
    pinned expert as its top-1 (the argmax of the logits, which the
    routes' first column equals in an unpinned run)."""
    import contextlib
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.incubate.distributed.models import moe
    top_k, gshard_aux = moe._top_k, moe._gshard_aux
    routes = {}

    def recorder(i, k):
        def hook(module, inputs, out):
            routes[i] = top_k(out[0].detach().float(), k)[1]
        return hook

    hooks = [layer.mlp.gate.register_forward_hook(
        recorder(i, layer.mlp.top_k))
        for i, layer in enumerate(model.ernie.layers) if layer.use_moe]
    if pin is not None:
        # each MoE layer calls moe._gshard_aux (in its gate) and then
        # moe._top_k (in _route) once, in layer order
        tops = [pin[i] for i in sorted(pin)]
        firsts = [r[:, 0] for r in tops]
        moe._top_k = lambda x, k: (None, tops.pop(0))

        def aux(lg):
            # moe._gshard_aux with the top-1 experts given
            e = lg.shape[-1]
            ce = torch.nn.functional.one_hot(firsts.pop(0), e).to(
                lg.dtype).mean(dim=0)
            return (torch.softmax(lg, dim=-1).mean(dim=0) * ce).sum() * e

        if pin_aux:
            moe._gshard_aux = aux
    model.zero_grad(set_to_none=True)
    try:
        with ops.plain_versions() if plain else contextlib.nullcontext():
            loss = loss_fn(model, batch)
            loss.backward()
    finally:
        moe._top_k, moe._gshard_aux = top_k, gshard_aux
        for h in hooks:
            h.remove()
    if pin is not None and (tops or (pin_aux and firsts)):
        raise AssertionError("pinned routes left unused")
    out = {}
    for n, p in model.named_parameters():
        if "__" in n:               # a stacked (L, ...) weight: each layer
            for i, g in enumerate(p.grad.unbind(0)):
                out[f"{n}[{i}]"] = g.float()
        else:
            out[n] = p.grad.float()
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), out, routes


def ernie_compare_plain(torch, model, cfg, b4):
    """Kernels vs plain versions on the ERNIE-MoE phase's initial
    weights, at batch 4 x 1024, forward and backward, no update. First
    an fp32 copy of the weights (the bf16 values, exact in fp32) without
    ``auto_cast``: the kernels and the plain versions differ only in the
    order of fp32 sums (the gather is a copy), so the loss to 1e-4, every
    gradient to 1e-3 relative (norm of the difference over the norm),
    and the same expert routes. Then the bf16 model under ``auto_cast``
    O2, held against that fp32 gradient. In bf16 the gate logits tie
    often, so a last-bit difference upstream (the flash kernels round
    at other sites than their plain versions) changes some tokens'
    expert choices, in the routes and in the GShard aux loss's top-1
    count, which is itself rounded to bf16. So the kernel run is made
    three times. Free, it routes by its own logits: the tokens routed
    differently from the plain run are counted per MoE layer, and its
    loss is held within 2e-2 of the plain one. With the routes pinned
    to the plain run's, and with the aux loss's top-1 pinned as well:
    then every parameter's bf16 gradient with the kernels must be no
    further from the fp32 one than 1.25 times the plain versions' is,
    plus 1e-3, and the loss within 2e-2. The errors of the parameters
    in front of a router (gate weight, ``ln_2``) are printed for all
    three, to show which choices move them. A plain run pinned to its
    own choices must reproduce the free plain run bit for bit (the
    pinning changes nothing else)."""
    from paddle_tpu_torch.models import ErnieMoEForCausalLM
    ref = ErnieMoEForCausalLM(cfg, device="cuda", seed=0)
    ref.load_state_dict({n: p.float() for n, p in
                         model.state_dict().items()})
    l32p, g32, r32p = _ernie_grads(torch, ref, b4, True, _train_loss)
    l32k, g32k, r32k = _ernie_grads(torch, ref, b4, False, _train_loss)
    del ref
    rel32 = {n: _rel(g32k[n], g32[n]) for n in g32}
    flips32 = sum(int((r32k[i] != r32p[i]).any(-1).sum()) for i in r32p)
    del g32k
    lp, gp, rp = _ernie_grads(torch, model, b4, True, _ernie_loss)
    ep = {n: _rel(gp[n], g32[n]) for n in g32}
    lpp, gpp, _ = _ernie_grads(torch, model, b4, True, _ernie_loss, pin=rp)
    selfpin = lpp == lp and all(torch.equal(gpp[n], gp[n]) for n in gp)
    del gp, gpp
    errs, losses, bad = {}, {}, []
    for run, pin, pin_aux in (("free", None, False),
                              ("routes pinned", rp, False),
                              ("routes and aux pinned", rp, True)):
        losses[run], g, r = _ernie_grads(torch, model, b4, False,
                                         _ernie_loss, pin, pin_aux)
        errs[run] = {n: _rel(g[n], g32[n]) for n in g32}
        bad += [(run, n) for n, x in g.items() if not torch.isfinite(x).all()]
        if pin is None:
            rf = r
        del g
    del g32
    torch.cuda.empty_cache()
    ek, lk = errs["routes and aux pinned"], losses["routes and aux pinned"]
    flips = {i: int((rf[i] != rp[i]).any(-1).sum()) for i in rp}
    vs32 = {i: (int((rf[i] != r32p[i]).any(-1).sum()),
                int((rp[i] != r32p[i]).any(-1).sum())) for i in rp}

    def stats(d):
        worst = max(d, key=d.get)
        return (f"max {d[worst]:.3e} ({worst}), median "
                f"{sorted(d.values())[len(d) // 2]:.3e}")

    router = sorted(f"ernie.layers.{i}.{x}" for i in rp
                    for x in ("mlp.gate.gate.weight", "ln_2.weight",
                              "ln_2.bias"))
    ratio = {n: ek[n] / max(ep[n], 1e-12) for n in ek}
    print(f"ernie batch-4 fp32 weights, kernels vs plain: loss {l32k:.6f} "
          f"vs {l32p:.6f} (|diff| {abs(l32k - l32p):.3e}, tol 1e-4); grad "
          f"relative error {stats(rel32)} (tol 1e-3); tokens routed "
          f"differently {flips32} (tol 0)")
    print(f"ernie batch-4 bf16 (O2) model, routes and aux top-1 pinned to "
          f"the plain run's: loss kernels {lk:.6f} plain {lp:.6f} fp32 "
          f"{l32p:.6f} (|kernels - plain| {abs(lk - lp):.3e}, tol 2e-2); "
          f"grad error vs fp32: kernels {stats(ek)}; plain {stats(ep)}; "
          f"ratio kernels/plain {stats(ratio)} (tol kernels <= 1.25 x "
          f"plain + 1e-3); plain run pinned to its own choices "
          f"bit-identical: {selfpin}")
    print(f"ernie bf16 kernel runs, loss (|kernels - plain|, tol 2e-2): "
          + ", ".join(f"{r} {x:.6f} ({abs(x - lp):.3e})"
                      for r, x in losses.items())
          + f"; tokens (of {b4[0].numel()}) routed differently by MoE "
          f"layer: free kernels vs plain {flips}; (free kernels, plain) vs "
          f"fp32 {vs32}")
    print("ernie bf16 grad error vs fp32 of the parameters in front of a "
          "router, kernels free / routes pinned / routes and aux pinned; "
          "plain: " + ", ".join(
              f"{n} " + " / ".join(f"{errs[r][n]:.3e}" for r in errs)
              + f"; {ep[n]:.3e}" for n in router))
    over = [n for n in ek if ek[n] > 1.25 * ep[n] + 1e-3]
    if bad or abs(l32k - l32p) > 1e-4 or max(rel32.values()) > 1e-3 \
            or flips32 or not selfpin or over \
            or max(abs(x - lp) for x in losses.values()) > 2e-2:
        raise AssertionError(f"ernie kernels vs plain: non-finite {bad}, "
                             f"fp32 loss {l32k} vs {l32p}, fp32 route flips "
                             f"{flips32}, self-pinned plain run identical "
                             f"{selfpin}, bf16 losses {losses} vs plain "
                             f"{lp}, over tolerance {over}")


def ernie_moe_path(torch, card):
    """The ERNIE-MoE training step (``bench_workloads.py`` ``ernie_moe``):
    ``ernie_moe_base_config(expert_parallel=False)`` at full size (vocab
    30522, hidden 768, 12 layers, 8 experts top-2 in every second layer)
    on the card, random weights from seed 0, ``amp.decorate`` O2 bf16,
    ``AdamW(lr=1e-4, weight_decay=0.01, multi_precision=False)`` (bf16
    moments), the forward under ``auto_cast`` O2, one 16 x 1024 batch
    from ``RandomState(0)`` with labels rolled by one (on the card the
    loss and the MoE data movement always take their kernels). Kernels
    vs plain versions first (batch 4), then 2 warm-up and 8 timed steps
    with exact launch counts per step, and one profiled step. Returns
    the launch counts of the 10 steps and the profiled step's idle
    share."""
    import numpy as np
    from paddle_tpu_torch import amp, ops
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (ErnieMoEForCausalLM,
                                         ernie_moe_base_config)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = ernie_moe_base_config(expert_parallel=False)
    B, S = 16, 1024

    def build():
        model = ErnieMoEForCausalLM(cfg, device="cuda", seed=0)
        amp.decorate(model, level="O2", dtype="bfloat16")
        opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                    parameters=model.parameters(), multi_precision=False)
        return model, opt

    t0 = time.perf_counter()
    model, opt = build()
    step = TrainStep(model, _ernie_loss, opt)
    torch.cuda.synchronize()
    n_params, active = model.num_params(), model.active_params()
    print(f"ernie model: {n_params / 1e6:.2f}M params "
          f"({active / 1e6:.2f}M active per token), bf16 (O2, "
          f"LayerNorm fp32) on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    batch = (torch.from_numpy(ids).cuda(),
             torch.from_numpy(labels).cuda())
    ernie_compare_plain(torch, model, cfg, (batch[0][:4], batch[1][:4]))
    compared = 3
    ref, ropt = build()
    want_losses = _eager_steps(ref, _ernie_loss, ropt, [batch] * compared)
    want = _snapshot(ref, ropt, device="cuda")
    del ref, ropt
    torch.cuda.empty_cache()

    L = cfg.num_hidden_layers
    n_moe = L // cfg.moe_every
    # a dense block holds 12 tensors, an MoE block 13; wte, wpe, ln_f
    n_tensors = len(list(model.parameters()))
    if n_tensors != 12 * (L - n_moe) + 13 * n_moe + 4:
        raise AssertionError(f"{n_tensors} parameter tensors, expected "
                             f"{12 * (L - n_moe) + 13 * n_moe + 4}")
    per_step = {"rms_norm": 0, "paged_attention_decode": 0,
                "paged_attention_decode_int8": 0,
                "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                "flash_attention_bwd_dkv": L, "rope": 0,
                "adamw": n_tensors, "xent_fwd": 1, "xent_bwd": 1,
                "moe_gather": 5 * n_moe, "rms_norm_residual": 0,
                "decode_layer": 0, "decode_layer_int8": 0, "rms_norm_bwd": 0}
    torch.cuda.reset_peak_memory_stats()
    warm, timed = 2, 8
    ops.reset_launch_counts()
    losses, times, got_losses = [], [], []
    for i in range(warm + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)            # ends in the loss's host read
        times.append(time.perf_counter() - t0)
        losses.append(step.last_loss)
        if i < compared:
            got_losses.append(loss)
        if i == compared - 1:
            _check_captured(torch, "ernie", step, want_losses, want,
                            got_losses)
            del want
    counts = ops.launch_counts()
    want = {k: (warm + timed) * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"ernie launch counts {counts}, expected "
                             f"{want} ({per_step} per step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite ERNIE-MoE loss: {losses}")
    for p in model.parameters():
        if not torch.isfinite(p).all():
            raise AssertionError("a parameter went non-finite")
    moments = {s["moment1"].dtype for s in opt._slots.values()}
    step_s = sum(times[warm:]) / timed
    tokens = B * S
    flops = 6 * active * tokens
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"ernie launches over {warm + timed} steps: {counts} "
          f"(per step {per_step})")
    print(f"ernie moment dtypes: {sorted(str(d) for d in moments)}")
    print(f"ernie losses: {', '.join(f'{x:.6f}' for x in losses)}")
    print(f"ernie step times ms (first: warm-up and capture): "
          f"{', '.join(f'{1e3 * x:.2f}' for x in times)}")
    print(f"[{card}] ernie step_ms={1e3 * step_s:.3f} "
          f"tokens_per_s={tokens / step_s:.1f} "
          f"tflop_per_step={flops / 1e12:.3f} (6 x active params x "
          f"tokens) mfu={flops / step_s / BF16_FLOPS:.4f} (vs 989 "
          f"TFLOP/s bf16) peak_mem_gb={peak_gb:.3f} graph_pool_mib="
          f"{step.graph_bytes / 2**20:.1f}")
    idle = profile_train_step(torch, lambda: step(batch), card,
                              label="ernie")
    if idle is not None:
        print(f"[{card}] ernie replayed step idle {100 * idle:.1f}% (the "
              f"eager step's before the step was one graph: 16%)")
    return counts


def _check_lr_reaches_replay(torch, label, step, batch):
    """A scheduler's lr change between calls reaches the replayed graph,
    read once a ``run_steps``: under ``PiecewiseDecay(boundaries=[1],
    values=[1e-4, 0])`` two replayed steps move the parameters, then,
    after ``scheduler.step()``, two more leave them bit-equal (lr 0) while
    the step count goes on."""
    import numpy as np
    from paddle_tpu_torch.optimizer import lr as tlr
    opt = step.optimizer
    sched = tlr.PiecewiseDecay(boundaries=[1], values=[1e-4, 0.0])
    opt.set_lr_scheduler(sched)
    reads, get_lr = [], opt.get_lr
    opt.get_lr = lambda: reads.append(1) or get_lr()
    try:
        before = [p.detach().clone() for p in step.model.parameters()]
        step.run_steps(batch, 2)
        lr1, n1 = float(opt._lr_tensor), len(reads)
        moved = not all(torch.equal(p, q) for p, q in
                        zip(step.model.parameters(), before))
        sched.step()
        before = [p.detach().clone() for p in step.model.parameters()]
        s0 = int(opt._step_tensor)
        step.run_steps(batch, 2)
        lr2, n2 = float(opt._lr_tensor), len(reads) - n1
        still = all(torch.equal(p, q) for p, q in
                    zip(step.model.parameters(), before))
        steps = int(opt._step_tensor) - s0
    finally:
        del opt.get_lr
    print(f"{label}: lr by the scheduler: run_steps(2) at lr {lr1:.3g} "
          f"({n1} lr read) moved the parameters: {moved}; after "
          f"scheduler.step() run_steps(2) at lr {lr2:.3g} ({n2} lr read) "
          f"left them bit-equal: {still}; device step +{steps}")
    if not (moved and still and n1 == n2 == 1 and steps == 2
            and lr1 == np.float32(1e-4) and lr2 == 0.0):
        raise AssertionError(f"{label}: the scheduler's lr did not reach "
                             "the replayed step")


def headline_path(torch, card):
    """Phase 9: bench.py's headline training configuration through
    ``tools/port_train_bench.py`` (see the module docstring). Returns
    the launch counts of its two stages' steps."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import LlamaForCausalLM
    from tools import port_train_bench as bench
    t_phase = time.perf_counter()
    cfg = bench.headline_big_config("full")
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"headline model: {model.num_params() / 1e9:.4f}B params bf16, "
          f"stacked trunk of {L} layers, full recompute, on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    import numpy as np
    np.random.seed(0)
    ids = np.random.randint(0, cfg.vocab_size, (1, bench.SEQ)).astype(
        np.int32)
    batch1 = (torch.from_numpy(ids).cuda(),
              torch.from_numpy(np.roll(ids, -1, axis=1).astype(np.int32))
              .cuda())
    compare_plain(torch, model, cfg, batch1)
    del model
    torch.cuda.empty_cache()
    # one step: the forward and its repeat in the backward launch the
    # layer's RMSNorms, RoPE and flash forward twice
    per_step = {k: 0 for k in ops.launch_counts()}
    per_step.update({"rms_norm": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
                     "rope": 3 * L, "flash_attention_fwd": 2 * L,
                     "flash_attention_bwd_dq": L,
                     "flash_attention_bwd_dkv": L, "adamw": 12})
    totals, stages = {k: 0 for k in per_step}, {}
    n_steps = bench.WARMUP + bench.STEPS
    for gran, b in bench.STAGES.items():
        # the eager loop over the stage's steps first, its states kept on
        # the host (the stage's peak memory is read from the card)
        ref, ropt, data = bench.build_stage(gran, b)
        eager = _eager_steps(ref, bench._loss, ropt, [data] * n_steps)
        want_losses = [float(x) for x in eager[:bench.WARMUP]] \
            + [float(eager[-1])]
        want = _snapshot(ref, ropt)
        del ref, ropt, data, eager
        gc.collect()
        torch.cuda.empty_cache()
        idle = {}

        def inspect(model, step, batch, result, gran=gran, b=b, want=want,
                    want_losses=want_losses, idle=idle):
            label = f"headline {gran} b{b}"
            if not all(torch.isfinite(p).all() for p in model.parameters()):
                raise AssertionError(f"headline {gran}: a parameter went "
                                     "non-finite")
            n_tensors = len(list(model.parameters()))
            if n_tensors != 12:
                raise AssertionError(f"{n_tensors} parameter tensors, "
                                     "expected 12")
            _check_captured(torch, label, step, want_losses, want,
                            result["losses"])
            want.clear()
            idle["share"] = profile_train_step(
                torch, lambda: step(batch), card, label=label)
            _check_lr_reaches_replay(torch, label, step, batch)
            half = tuple(t[:, :t.shape[1] // 2].contiguous() for t in batch)
            step(half)
            print(f"{label}: a second batch shape {tuple(half[0].shape)} is "
                  f"a second capture: captures {step.captures}; graph pool "
                  f"{step.graph_bytes / 2**20:.1f} MiB")
            if step.captures != 2:
                raise AssertionError(f"{label}: {step.captures} captures "
                                     "after a second batch shape")

        r = bench.bench_stage(gran, b, inspect=inspect)   # zeroes counts
        n = r["steps"]
        counts = {k: r["launches"].get(k, 0) for k in per_step}
        want = {k: n * v for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"headline {gran} b{b} launch counts "
                                 f"{counts}, expected {want} ({per_step} "
                                 "per step)")
        if not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"headline {gran}: non-finite loss "
                                 f"{r['losses']}")
        for k in totals:
            totals[k] += counts[k]
        stages[gran] = r
        share = idle.get("share")
        print(f"[{card}] headline {gran} b{b}x{r['seq']} step_ms="
              f"{r['step_ms']:.3f} tokens_per_s={r['tokens_per_sec']:.1f} "
              f"mfu={r['mfu']:.4f} (vs 989 TFLOP/s bf16) peak_mem_gb="
              f"{r['peak_mem_gb']:.3f} idle="
              f"{'not measured' if share is None else f'{100 * share:.1f}%'}"
              f" graph_pool_mib={r['graph_mib']:.1f} losses (warm-up, last) "
              f"{', '.join(f'{x:.6f}' for x in r['losses'])}; "
              f"launches over {n} steps exact ({per_step} per step)")
    print("headline bench line: " + json.dumps(bench.result_line(stages,
                                                                 card)))
    print(f"phase 9 (headline training) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def _prompts(rng, vocab):
    """12 requests of 32..512 prompt tokens; requests 1 and 9 share a
    256-token prefix (request 9 arrives at tick 4, after request 1's
    prefill registered the prefix blocks); request 5 samples
    (temperature 0.8, top-k 50, seed 7). Returns (prompt, max_new,
    sampling kwargs, arrival tick) per request."""
    prefix = rng.randint(0, vocab, (256,))
    lens = [32, 288, 64, 96, 128, 160, 200, 300, 384, 356, 448, 512]
    news = [32, 40, 48, 56, 64, 32, 40, 48, 56, 64, 36, 44]
    out = []
    for i, (L, mn) in enumerate(zip(lens, news)):
        p = rng.randint(0, vocab, (L,))
        if i in (1, 9):
            p[:256] = prefix
        kw = dict(temperature=0.8, top_k=50, seed=7) if i == 5 else {}
        out.append((p.astype("int32"), mn, kw, 4 if i == 9 else 0))
    return out


def _serve_checked(torch, srv, engine, reqs, vocab):
    """Submit, serve until idle with the launch counters zeroed just
    before and read just after, and check outputs, block accounting and
    prefix reuse; returns (rids, results, launch counts, wall s)."""
    import numpy as np
    from paddle_tpu_torch import ops
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
            for p, mn, kw, arr in reqs]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = srv.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for rid, (p, mn, _, _) in zip(rids, reqs):
        out = res[rid]
        if len(out) != len(p) + mn or not np.array_equal(out[:len(p)], p):
            raise AssertionError(f"request {rid}: bad output length/prompt")
        gen = out[len(p):]
        if gen.min() < 0 or gen.max() >= vocab:
            raise AssertionError(f"request {rid}: token out of vocab")
    manager = getattr(engine, "manager", None)     # paged engines
    if manager is not None:
        manager.assert_consistent()
        if manager._ref:
            raise AssertionError(f"blocks leaked: {manager._ref}")
        if srv.stats()["prefix_cache_hit_rate"] <= 0:
            raise AssertionError("the shared prefix was not reused")
    return rids, res, counts, wall


def _check_launches(engine, counts, kernel):
    """Exact launch counts of a served run: ``kernel`` (the arena's
    paged-decode kernel, or the megakernel entry with the megakernel
    on) once per layer and decode step, the other decode kernels never
    (prefill chunks read through the gathered-dense sequence); RMSNorm
    2L + 1 times per prefill chunk and per unfused decode step, once
    (the final norm) per megakernel decode step. The steps and chunks
    are graph replays: each adds the launches its graph captured
    (``graphs``), so the formulas count launches the device ran.
    With the megakernel, every layer of the last step went through
    it."""
    L = engine.backend.model.config.num_hidden_layers
    mega = engine.megakernel()
    want = {k: 0 for k in ("paged_attention_decode",
                           "paged_attention_decode_int8", "decode_layer",
                           "decode_layer_int8", "rms_norm_bwd")}
    want["rms_norm"] = (2 * L + 1) * engine.prefill_chunks \
        + (1 if mega else 2 * L + 1) * engine.steps
    want[kernel] = L * engine.steps
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"launch counts {got}, expected {want}")
    if mega and not (engine.megakernel_rewrites()
                     == engine.megakernel_kernel_calls() == L):
        raise AssertionError(
            f"megakernel routing: {engine.megakernel_rewrites()} rewrites, "
            f"{engine.megakernel_kernel_calls()} kernel calls for {L} layers")


def _check_graphs(engine, label):
    """Both serving programs captured exactly once, when the engine was
    built, and replayed over every served stream since; prints each
    capture's seconds (warm-up and capture) and the bytes its graph's
    memory pool reserved."""
    counts = (engine.decode_compile_count(), engine.prefill_compile_count())
    if counts != (1, 1):
        raise AssertionError(f"{label}compile counts (decode, prefill) "
                             f"{counts}, expected (1, 1)")
    b = engine.backend
    progs = (("decode block", b.decode_program),
             ("prefill chunk", b.prefill_program))
    print(f"{label}graphs: " + "; ".join(
        f"{name} captured once in {p.capture_s:.3f} s, pool "
        f"{p.graph_bytes / 2**20:.1f} MiB" for name, p in progs))


def _print_serving(card, label, st, extra=""):
    print(f"[{card}] {label}decode_tokens_per_s="
          f"{st['decode_tokens_per_sec']:.1f} "
          f"tokens_per_s={st['tokens_per_sec']:.1f} "
          f"ttft_p50_s={st['ttft_p50_s']:.4f} "
          f"ttft_p95_s={st['ttft_p95_s']:.4f} "
          f"decode_step_ms={st['decode_step_ms']:.3f} "
          + (f"prefix_hit_rate={st['prefix_cache_hit_rate']:.4f} "
             if "prefix_cache_hit_rate" in st else "")
          + f"occupancy={st['slot_occupancy']:.4f}{extra}")


def _check_step_logprobs(torch, model, engine, label, megakernel=False):
    """One decode step on the engine's armed slots, the kernels against
    the plain versions on the same state (both write the same K/V into
    the arena). 32 fp32 layers: the kernels' reassociated sums and
    rsqrtf differ from the plain versions by a few ulp per layer, so
    the log-probs are held to 2e-3. With ``megakernel`` three ways: the
    fused decode layer (one megakernel launch per layer), the unfused
    kernels and the plain versions, each pair within 2e-3."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import decode_step_logprobs
    from paddle_tpu_torch.ops.decode_layer import FusedDecode
    s = engine._state
    step = (s["tok"][:, None], engine.backend.cache, s["pos"])
    if "table" in s:                      # paged: the live slots' tables
        aux = dict(block_table=torch.where(s["live"][:, None], s["table"],
                                           0))
    else:                                 # dense: the slots' pad counts
        aux = dict(pad=s["pad"])
    runs = {}
    if megakernel:
        fused = FusedDecode()
        runs["megakernel"] = decode_step_logprobs(model, *step,
                                                  fused_decode=fused, **aux)
        L = model.config.num_hidden_layers
        if fused.kernel_calls != L:
            raise AssertionError(f"{label}log-prob check: {fused.kernel_calls}"
                                 f" megakernel launches for {L} layers")
    runs["kernels"] = decode_step_logprobs(model, *step, **aux)
    with ops.plain_versions():
        runs["plain"] = decode_step_logprobs(model, *step, **aux)
    torch.cuda.synchronize()
    names = list(runs)
    errs = {f"{a} vs {b}": _max_err(runs[a], runs[b])
            for i, a in enumerate(names) for b in names[i + 1:]}
    if not (all(torch.isfinite(v).all() for v in runs.values())
            and max(errs.values()) <= 2e-3):
        raise AssertionError(f"{label}decode log-probs: {errs}")
    first, plain = runs[names[0]], runs["plain"]
    agree = int((first.argmax(-1) == plain.argmax(-1)).sum())
    pos = s["pos"][s["live"]]
    print(f"{label}decode step log-probs ({int(s['live'].sum())} slots, "
          f"lengths {int(pos.min()) + 1}..{int(pos.max()) + 1}): "
          + ", ".join(f"{k} max_abs_err={v:.3e}" for k, v in errs.items())
          + f" (tolerance 2e-3), argmax {names[0]} vs plain agree "
          f"{agree}/{first.shape[0]}")


def serving_path(torch, card):
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b_config
    from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server
    cfg = llama_7b_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"model: Llama-2-7B shape, {model.num_params() / 1e9:.3f}B "
          f"params fp32 on the card in {time.perf_counter() - t0:.2f} s")
    engine = PagedEngine(model, num_slots=8, max_len=1024, decode_block=8,
                         block_size=16, prefill_chunk=32, device="cuda")
    print(f"engine: 8 slots, max_len 1024, decode_block 8, block 16, "
          f"chunk 32, {engine.num_kv_blocks} arena blocks, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    srv = Server(engine, Scheduler(prefill_token_budget=256))
    reqs = _prompts(np.random.RandomState(0), cfg.vocab_size)
    rids, res, counts, wall = _serve_checked(torch, srv, engine, reqs,
                                             cfg.vocab_size)
    _check_launches(engine, counts, "paged_attention_decode")
    _check_graphs(engine, "")
    print(f"served {len(rids)} requests in {wall:.2f} s: "
          f"{engine.steps} decode steps, {engine.prefill_chunks} prefill "
          f"chunks, launches {counts}")
    st = srv.stats()
    _print_serving(card, "", st)

    _arm_fp32_check(engine, cfg)
    _check_step_logprobs(torch, model, engine, "")
    idle = profile_decode_block(torch, engine, card)
    greedy = {i: res[rid] for i, rid in enumerate(rids) if not reqs[i][2]}
    return counts, model, dict(stats=st, idle=idle, greedy=greedy)


def _arm_fp32_check(engine, cfg):
    """Arm 8 fresh greedy requests (prompts of 40 + 37 i tokens, 32 new
    tokens: four decode blocks of work) for the one-step log-prob check
    and the block profile."""
    import numpy as np
    from paddle_tpu_torch.serving import Request
    rng = np.random.RandomState(1)
    for i in range(8):
        L0 = 40 + 37 * i
        engine.try_admit(Request(request_id=1000 + i,
                                 prompt=rng.randint(0, cfg.vocab_size,
                                                    (L0,)).astype("int32"),
                                 max_new_tokens=32))
    prefill_tick = getattr(engine, "prefill_tick", None)   # paged
    if prefill_tick is not None:
        prefill_tick(None)


def _arm_int8_check(engine, cfg):
    """Arm all 32 slots at lengths 1009..1071 for the one-step log-prob
    check and the block profile: a shared 1008-token prefix (63 blocks,
    prefilled once) plus 1 + 2 i tokens of each request's own, 32 new
    tokens each (four decode blocks of work)."""
    import numpy as np
    from paddle_tpu_torch.serving import Request
    rng = np.random.RandomState(6)
    base = rng.randint(0, cfg.vocab_size, (1008,))
    for i in range(32):
        p = np.concatenate([base, rng.randint(0, cfg.vocab_size,
                                              (1 + 2 * i,))])
        engine.try_admit(Request(request_id=2000 + i,
                                 prompt=p.astype("int32"),
                                 max_new_tokens=32))
        if i == 0:
            engine.prefill_tick(None)         # registers the prefix
    engine.prefill_tick(None)
    s = engine._state
    if int(s["live"].sum()) != 32 or int(s["pos"].min()) < 1008:
        raise AssertionError("the log-prob check needs 32 live slots")


# the symbol of each decode-path kernel in the profiler's names, by the
# wrapper that counts its launches
_PATH_KERNELS = {
    "rms_norm": ("rms_norm_kernel<", ", false>"),
    "paged_attention_decode": ("paged_decode_kernel<", "DenseKV"),
    "paged_attention_decode_int8": ("paged_decode_kernel<", "Int8KV"),
    "decode_layer": ("decode_layer_kernel<", "DenseKV"),
    "decode_layer_int8": ("decode_layer_kernel<", "Int8KV"),
}


def _profile_block(torch, engine):
    """One decode block (one replay of its graph) under the profiler,
    after two margin blocks in the same session. The profiler converts
    the device's clock to the host's, and the offset drifts over a
    process's life (by milliseconds after a few minutes on the H100): it
    drops device records it places outside the session (once, on an
    H100, a whole first block's host read), and places a block's
    first kernels before the host call that launched them. So two blocks
    run first to take the loss at the start, and a 50 ms wait follows
    the read block; the read block's records are found on the device's
    own timeline, between the last two host reads (a block's one copy to
    the host each): the block before it and its own. The read closing
    that window must end in the second half of the timed block's host
    range (a drift of milliseconds against a block of 100 ms or more),
    so a dropped last read, which would leave the block before it in the
    window, fails; a read dropped inside the window fails the caller's
    kernel-by-kernel check of the captured launches. Returns its host
    wall us and its device events as (name, us, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    mark = "chip_smoke timed decode block"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.step_block()
        engine.step_block()
        with record_function(mark):
            t0 = time.perf_counter()
            engine.step_block()
            wall_us = 1e6 * (time.perf_counter() - t0)
        time.sleep(0.05)
    timed = [e.time_range for e in prof.events()
             if e.name == mark and e.device_type == DeviceType.CPU]
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA and e.name != mark),
                    key=lambda e: e.time_range.start)
    reads = [k for k, e in enumerate(events)
             if e.name.startswith("Memcpy DtoH")]
    if not 2 <= len(reads) <= 3 or len(timed) != 1:
        raise AssertionError(f"three profiled decode blocks made "
                             f"{len(reads)} copies to the host, not one "
                             f"each (the first may be dropped), and "
                             f"{len(timed)} timed ranges, not one")
    mid = (timed[0].start + timed[0].end) / 2
    if events[reads[-1]].time_range.end < mid:
        raise AssertionError("the last host read the profiler recorded "
                             "ends before the middle of the timed block: "
                             "the window would hold the block before it")
    kernels = {}
    for e in events[reads[-2] + 1:reads[-1] + 1]:
        t, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return wall_us, [(name, t, n) for name, (t, n) in kernels.items()
                     if t > 0]


def _path_counts(kernels):
    """Launches of each decode-path kernel among the profiled events."""
    return {w: sum(n for name, _, n in kernels
                   if all(part in name for part in parts))
            for w, parts in _PATH_KERNELS.items()}


def profile_decode_block(torch, engine, card, arena=None):
    """Where one decode block's time goes: device time by kernel name
    and the device's busy share of the block's host wall time (every
    live slot, one replay of the block's CUDA graph ending in its host
    sync), and the RMSNorm kernel's time inside it. One unprofiled
    block runs first, for the wall time without the profiler's
    overhead; the profiled block is the third of its session
    (:func:`_profile_block`), so four blocks of work must be armed.
    The decode-path kernels the profiler saw the device run in the
    replay must equal the launches the graph captured, kernel by kernel
    (the launch counts only add the captured launches at each replay;
    this observes them). Returns the idle share."""
    live = int(engine._state["live"].sum())
    if arena is None:
        arena = "int8" if getattr(engine, "kv_int8", False) else "fp32"
        if engine.megakernel():
            arena = "megakernel " + arena
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step_block()
    print(f"[{card}] unprofiled {arena} decode block of "
          f"{engine.decode_block} steps, {live} live slots: "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms")
    wall_us, kernels = _profile_block(torch, engine)
    busy_us = sum(t for _, t, _ in kernels)
    if busy_us == 0:
        raise AssertionError("decode block profile: the profiler saw no "
                             "device time, so the replayed kernels are "
                             "not observed")
    print(f"[{card}] {arena} decode block profile ({live} live slots): "
          f"wall {wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100 * busy_us / wall_us:.1f}% busy, "
          f"{100 - 100 * busy_us / wall_us:.1f}% idle)")
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        print(f"  {t / 1e3:9.3f} ms {100 * t / busy_us:5.1f}% "
              f"x{n:<6d} {name[:90]}")
    rms = [(t, n) for name, t, n in kernels if "rms_norm_kernel" in name]
    if rms:
        t, n = sum(r[0] for r in rms), sum(r[1] for r in rms)
        print(f"[{card}] {arena} RMSNorm kernel inside the replayed block: "
              f"{n} launches, {t / n:.3f} us each (profiler)")
    captured = engine.backend.decode_program._launches
    unknown = set(captured) - set(_PATH_KERNELS)
    if unknown:
        raise AssertionError(f"decode graph launches {sorted(unknown)}, "
                             f"which the profile check cannot name")
    want = {w: captured.get(w, 0) for w in _PATH_KERNELS}
    seen = _path_counts(kernels)
    if seen != want:
        raise AssertionError(f"{arena} replayed decode block ran {seen} "
                             f"(profiler), its graph captured {want}")
    print(f"[{card}] {arena} replayed block ran the captured launches "
          f"(profiler): " + ", ".join(f"{w} {n}" for w, n in want.items()
                                      if n))
    return 1 - busy_us / wall_us


def _int8_requests(rng, vocab):
    """32 requests: request i has 256 + 48 i prompt tokens and
    64 + 16 (i % 5) new tokens. Requests 3, 11, 19 and 27 share a
    512-token prefix (request 3's 400-token prompt is its first 400
    tokens); 11, 19 and 27 arrive at tick 4, after request 3's prefill
    registered it. Requests 5 and 21 sample (temperature 0.8, top-k 50,
    seeds 7 and 11; 21 also top-p 0.95). Returns (prompt, max_new,
    sampling kwargs, arrival tick) per request."""
    prefix = rng.randint(0, vocab, (512,))
    out = []
    for i in range(32):
        L, mn = 256 + 48 * i, 64 + 16 * (i % 5)
        p = rng.randint(0, vocab, (L,))
        if i in (3, 11, 19, 27):
            n = min(L, 512)
            p[:n] = prefix[:n]
        kw = {5: dict(temperature=0.8, top_k=50, seed=7),
              21: dict(temperature=0.8, top_k=50, top_p=0.95, seed=11)
              }.get(i, {})
        out.append((p.astype("int32"), mn, kw,
                    4 if i in (11, 19, 27) else 0))
    return out


def serving_int8_path(torch, card, model):
    """Paged serving over the int8 KV arena at Llama-2-7B shape, full
    depth, on the fp32 serving path's model (see the module
    docstring). Returns the launch counts of the served requests."""
    import numpy as np
    from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server
    cfg = model.config
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    kw = dict(num_slots=32, max_len=2048, decode_block=8, block_size=16,
              prefill_chunk=128, device="cuda")
    engine = PagedEngine(model, kv_int8=True, **kw)
    arena = sum(t.numel() * t.element_size()
                for layer in engine.backend.cache for t in layer)
    fp32_arena = engine.num_kv_blocks * 16 * cfg.num_key_value_heads \
        * cfg.head_dim * 4 * 2 * L
    print(f"int8 engine: 32 slots, max_len 2048, decode_block 8, block 16, "
          f"chunk 128, {engine.num_kv_blocks} arena blocks: int8 arena "
          f"{arena / 1e9:.2f} GB (an fp32 arena would be "
          f"{fp32_arena / 1e9:.2f} GB), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    srv = Server(engine, Scheduler(prefill_token_budget=512))
    reqs = _int8_requests(np.random.RandomState(5), cfg.vocab_size)
    rids, res, counts, wall = _serve_checked(torch, srv, engine, reqs,
                                             cfg.vocab_size)
    _check_launches(engine, counts, "paged_attention_decode_int8")
    _check_graphs(engine, "int8 ")
    st = srv.stats()
    bound = engine.kv_error_bound()
    if not bound > 0:
        raise AssertionError(f"kv_error_bound {bound}")
    print(f"int8 served {len(rids)} requests in {wall:.2f} s: "
          f"{engine.steps} decode steps, {engine.prefill_chunks} prefill "
          f"chunks, launches {counts}")
    _print_serving(card, "int8 ", st,
                   f" kv_bytes_per_slot={st['kv_bytes_per_slot']} "
                   f"kv_error_bound={bound:.6e} max_memory_allocated_gb="
                   f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")

    # one decode step with all 32 slots live at lengths 1009..1071,
    # kernels vs plain versions
    _arm_int8_check(engine, cfg)
    _check_step_logprobs(torch, model, engine, "int8 ")
    idle = profile_decode_block(torch, engine, card)

    # greedy agreement with an fp32 arena on the same prompts (reported,
    # not gated); the int8 arena is freed first, the fp32 one holds 16
    # slots of 2048 tokens (34.4 GB beside the 27 GB of weights)
    greedy = [i for i, r in enumerate(reqs) if not r[2]]
    int8_out = {i: res[rids[i]] for i in greedy}
    del engine, srv
    torch.cuda.empty_cache()
    fp_engine = PagedEngine(model, kv_int8=False, **dict(kw, num_slots=16))
    fp_srv = Server(fp_engine, Scheduler(prefill_token_budget=512))
    fp_reqs = [reqs[i] for i in greedy]
    fp_rids, fp_res, _, fp_wall = _serve_checked(torch, fp_srv, fp_engine,
                                                 fp_reqs, cfg.vocab_size)
    _check_graphs(fp_engine, "fp32 16-slot ")
    same = total = prefix_sum = 0
    identical = 0
    for i, rid in zip(greedy, fp_rids):
        p_len = len(reqs[i][0])
        a, b = int8_out[i][p_len:], fp_res[rid][p_len:]
        eq = a == b
        same += int(eq.sum())
        total += len(a)
        first = int(np.argmin(eq)) if not eq.all() else len(a)
        prefix_sum += first
        identical += int(eq.all())
    print(f"int8 vs fp32 arena greedy streams ({len(greedy)} requests, "
          f"{fp_wall:.2f} s for the fp32 run): {identical} identical, "
          f"token agreement {same / total:.4f}, mean agreeing prefix "
          f"{prefix_sum / len(greedy):.1f} of "
          f"{total / len(greedy):.1f} generated tokens (not gated)")
    del fp_engine, fp_srv
    torch.cuda.empty_cache()
    return counts, dict(stats=st, idle=idle, greedy=int8_out)


def serving_megakernel_path(torch, card, model, refs):
    """Megakernel decode serving on the fp32 serving path's model: the
    fp32 engine of phase 3 and the int8 engine of phase 4 with
    ``megakernel=True``, serving the same requests. Exact launch counts,
    the routing counters, one decode step's log-probs three ways, one
    profiled decode block; decode step ms, decode tokens/s and the idle
    share beside the unfused engine's (``refs``, from phases 3 and 4 of
    this run), and its greedy streams, which must be token-identical
    to it. Returns the launch counts of both served runs."""
    import numpy as np
    from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server
    cfg = model.config
    runs = [("fp32", "decode_layer", 256, _prompts, 0, _arm_fp32_check,
             dict(num_slots=8, max_len=1024, prefill_chunk=32)),
            ("int8", "decode_layer_int8", 512, _int8_requests, 5,
             _arm_int8_check,
             dict(num_slots=32, max_len=2048, prefill_chunk=128,
                  kv_int8=True))]
    total = None
    for label, kernel, budget, make_reqs, seed, arm, kw in runs:
        engine = PagedEngine(model, decode_block=8, block_size=16,
                             megakernel=True, device="cuda", **kw)
        if not engine.megakernel():
            raise AssertionError("megakernel=True did not arm the engine")
        srv = Server(engine, Scheduler(prefill_token_budget=budget))
        reqs = make_reqs(np.random.RandomState(seed), cfg.vocab_size)
        rids, res, counts, wall = _serve_checked(torch, srv, engine, reqs,
                                                 cfg.vocab_size)
        _check_launches(engine, counts, kernel)
        _check_graphs(engine, f"megakernel {label} ")
        st = srv.stats()
        ref = refs[label]
        print(f"megakernel {label} served {len(rids)} requests in {wall:.2f}"
              f" s: {engine.steps} decode steps, {engine.prefill_chunks} "
              f"prefill chunks, megakernel_rewrites="
              f"{engine.megakernel_rewrites()} megakernel_kernel_calls="
              f"{engine.megakernel_kernel_calls()}, launches {counts}")
        _print_serving(card, f"megakernel {label} ", st)
        _print_serving(card, f"unfused {label} (same run) ", ref["stats"])
        same = total_tok = identical = 0
        for i, out in ref["greedy"].items():
            p_len = len(reqs[i][0])
            eq = res[rids[i]][p_len:] == out[p_len:]
            same += int(eq.sum())
            total_tok += len(eq)
            identical += int(eq.all())
        print(f"megakernel {label} vs unfused greedy streams "
              f"({len(ref['greedy'])} requests): {identical} identical, "
              f"token agreement {same / total_tok:.4f}")
        if identical != len(ref["greedy"]):
            raise AssertionError(f"megakernel {label}: greedy streams "
                                 "differ from the unfused engine's")
        arm(engine, cfg)
        _check_step_logprobs(torch, model, engine, f"megakernel {label} ",
                             megakernel=True)
        idle = profile_decode_block(torch, engine, card)
        rst = ref["stats"]
        print(f"[{card}] {label} decode, megakernel vs unfused: step "
              f"{st['decode_step_ms']:.3f} vs {rst['decode_step_ms']:.3f} ms, "
              f"decode tokens/s {st['decode_tokens_per_sec']:.1f} vs "
              f"{rst['decode_tokens_per_sec']:.1f}, device idle "
              f"{100 * idle:.1f}% vs {100 * ref['idle']:.1f}%")
        total = counts if total is None else {
            k: total[k] + counts[k] for k in total}
        del engine, srv
        torch.cuda.empty_cache()
    return total


def _check_dense_launches(engine, counts):
    """Exact launch counts of a dense engine's served run: RMSNorm 2L + 1
    times per decode step and per prefill (each a graph replay), every
    other kernel never (the slot pool rotates per row in torch ops and
    reads through the dense einsum sequence)."""
    L = engine.backend.model.config.num_hidden_layers
    want = {k: 0 for k in counts}
    want["rms_norm"] = (2 * L + 1) * (engine.steps + engine.prefills)
    if counts != want:
        raise AssertionError(f"dense launch counts {counts}, expected "
                             f"{want}")


def serving_dense_path(torch, card, model, ref):
    """Phase 6, the dense engine: ``ContinuousBatchingEngine`` without
    ``paged`` on the fp32 serving path's model serves phase 3's 12
    requests. Both programs are CUDA graphs: the decode block captured
    once at construction, one prefill per prompt bucket at its first
    admission. Gates: greedy streams token-identical to phase 3's paged
    engine (``ref``), one decode capture, one prefill capture per bucket
    used, exact launch counts, one decode step's log-probs with the
    kernels against the plain versions, one profiled decode block.
    Returns the launch counts, the engine's greedy tokens for
    ``generate_path`` and its stats."""
    import numpy as np
    from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                          Scheduler, Server)
    cfg = model.config
    buckets = (64, 128, 256, 512)
    engine = ContinuousBatchingEngine(model, num_slots=8, max_len=1024,
                                      decode_block=8, prompt_buckets=buckets,
                                      device="cuda")
    b = engine.backend
    pool = sum(t.numel() * t.element_size() for layer in b.cache
               for t in layer)
    row = sum(t.numel() * t.element_size() for layer in b.row for t in layer)
    print(f"dense engine: 8 slots, max_len 1024, decode_block 8, buckets "
          f"{buckets}: pool {pool / 1e9:.3f} GB, prefill row "
          f"{row / 1e9:.3f} GB, {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated")
    srv = Server(engine, Scheduler(prefill_token_budget=256))
    reqs = _prompts(np.random.RandomState(0), cfg.vocab_size)
    rids, res, counts, wall = _serve_checked(torch, srv, engine, reqs,
                                             cfg.vocab_size)
    _check_dense_launches(engine, counts)
    used = sorted({engine.bucket_len(len(r[0])) for r in reqs})
    compiles = (engine.decode_compile_count(), engine.prefill_compile_count())
    if compiles != (1, len(used)):
        raise AssertionError(f"dense compile counts (decode, prefill) "
                             f"{compiles}, expected (1, {len(used)})")
    dec = b.decode_program
    pre = sorted(b.prefill_programs().items())
    print(f"dense graphs: decode block captured once in {dec.capture_s:.3f}"
          f" s, pool {dec.graph_bytes / 2**20:.1f} MiB; the prefills share "
          f"one pool of {sum(p.graph_bytes for _, p in pre) / 2**20:.1f} "
          f"MiB: " + "; ".join(
              f"prefill {n} captured once in {p.capture_s:.3f} s, pool "
              f"growth {p.graph_bytes / 2**20:.1f} MiB" for n, p in pre))
    print(f"dense served {len(rids)} requests in {wall:.2f} s: "
          f"{engine.steps} decode steps, {engine.prefills} prefills "
          f"(buckets {used}), launches {counts}")
    st = srv.stats()
    _print_serving(card, "dense ", st,
                   f" prefill_s={engine.prefill_s:.3f}")
    _print_serving(card, "paged (phase 3, same run) ", ref["stats"])
    same = total_tok = identical = 0
    for i, out in ref["greedy"].items():
        p_len = len(reqs[i][0])
        eq = res[rids[i]][p_len:] == out[p_len:]
        same += int(eq.sum())
        total_tok += len(eq)
        identical += int(eq.all())
    print(f"dense vs paged greedy streams ({len(ref['greedy'])} requests): "
          f"{identical} identical, token agreement {same / total_tok:.4f}")
    if identical != len(ref["greedy"]):
        raise AssertionError("dense engine: greedy streams differ from the "
                             "paged engine's")
    _arm_fp32_check(engine, cfg)
    _check_step_logprobs(torch, model, engine, "dense ")
    idle = profile_decode_block(torch, engine, card, arena="dense fp32")
    rst = ref["stats"]
    print(f"[{card}] dense vs paged decode: step {st['decode_step_ms']:.3f} vs "
          f"{rst['decode_step_ms']:.3f} ms, decode tokens/s "
          f"{st['decode_tokens_per_sec']:.1f} vs "
          f"{rst['decode_tokens_per_sec']:.1f}, ttft p50 "
          f"{st['ttft_p50_s']:.4f} vs {rst['ttft_p50_s']:.4f} s, p95 "
          f"{st['ttft_p95_s']:.4f} vs {rst['ttft_p95_s']:.4f} s, device "
          f"idle {100 * idle:.1f}% vs {100 * ref['idle']:.1f}%")
    return counts, engine


def generate_path(torch, card, model, engine):
    """Phase 6, ``generate()``: 4 prompts of 128 tokens, 64 new tokens,
    greedy (the scan tail: no host read between steps). Gates: the
    step's CUDA graph captured once; RoPE through its serving route,
    exactly L launches per decode step plus L for the prefill, RMSNorm
    2L + 1 per step and for the prefill, nothing else; the tokens equal
    the dense ``engine``'s greedy streams for the same prompts (the
    largest log-prob difference of one decode step between the two
    routes is printed beside it). Then a ragged ``attention_mask``
    batch, a sampled run and a 4-beam run at 8 new tokens (shapes,
    vocabulary, the ragged row against its unpadded prompt). Returns
    the launch counts of the greedy run."""
    import numpy as np
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.models import decode_step_logprobs
    from paddle_tpu_torch.serving import Request, Scheduler, Server
    cfg = model.config
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    prompts = np.random.RandomState(3).randint(0, V, (4, 128)) \
        .astype(np.int32)
    new = 64
    model.release_decode_programs()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    (step,) = model.__dict__["_decode_fn_cache"].values()
    if step.program.captures != 1:
        raise AssertionError(f"generate(): {step.program.captures} "
                             "captures of its step")
    want = {k: 0 for k in counts}
    want["rope"] = L * (new - 1) + L
    want["rms_norm"] = (2 * L + 1) * new
    if counts != want:
        raise AssertionError(f"generate() launch counts {counts}, expected "
                             f"{want}")
    gen = out.cpu().numpy()
    if gen.shape != (4, 128 + new) or gen.min() < 0 or gen.max() >= V:
        raise AssertionError(f"generate(): bad output {gen.shape}")
    t0 = time.perf_counter()
    model.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # the replayed step alone (CUDA events around 10 replays), and the
    # eager prefill on the same shapes
    step_ms = _time_eager(step, iters=10)
    ids = torch.from_numpy(prompts).to(model.device)
    prefill_ms = _time_eager(lambda: decode_step_logprobs(
        model, ids, step.cache, 0), iters=3)
    print(f"[{card}] generate() 4 x 128 prompts, {new} new tokens, greedy: "
          f"first call {first_s:.3f} s (step captured in "
          f"{step.program.capture_s:.3f} s, pool "
          f"{step.program.graph_bytes / 2**20:.1f} MiB), warm call "
          f"{warm_s:.3f} s; replayed step {step_ms:.3f} ms a token "
          f"({4e3 / step_ms:.1f} tokens/s), prefill {prefill_ms:.3f} ms; "
          f"launches {counts}")

    # the dense engine on the same prompts: the same greedy tokens
    engine.reset()
    srv = Server(engine, Scheduler())
    rids = [srv.submit(p, max_new_tokens=new) for p in prompts]
    res = srv.run_until_idle()
    agree = [int((res[r][128:] == gen[i, 128:]).sum())
             for i, r in enumerate(rids)]
    # one decode step of both routes from the same state: the generate
    # step's cache after its prefill, and the engine's slots armed the
    # same way
    engine.reset()
    for i, p in enumerate(prompts):
        engine.admit(Request(request_id=i, prompt=p, max_new_tokens=new))
    s = engine._state
    lp_engine = decode_step_logprobs(model, s["tok"][:, None],
                                     engine.backend.cache, s["pos"],
                                     pad=s["pad"])
    step.start(None)
    tok = torch.from_numpy(gen[:, 128]).to(model.device)
    decode_step_logprobs(model, ids, step.cache, 0)
    lp_gen = decode_step_logprobs(model, tok[:, None], step.cache,
                                  torch.tensor(128, dtype=torch.int32,
                                               device=model.device))
    torch.cuda.synchronize()
    diff = _max_err(lp_engine[:4], lp_gen)
    print(f"generate() vs dense engine greedy tokens: "
          f"{sum(agree)}/{4 * new} agree ({agree}); one decode step's "
          f"log-probs max_abs_diff={diff:.3e} (fused RoPE over a "
          f"{128 + new}-entry cache vs per-row RoPE over the 1024-entry "
          f"pool)")
    if sum(agree) != 4 * new:
        raise AssertionError("generate(): greedy tokens differ from the "
                             "dense engine's")
    engine.reset()

    # ragged, sampled and beam runs at 8 new tokens
    am = np.ones((4, 128), np.int32)
    am[1, :40] = 0
    am[3, :100] = 0
    rag = model.generate(prompts, max_new_tokens=8, attention_mask=am)
    alone = model.generate(prompts[1:2, 40:], max_new_tokens=8)
    smp = model.generate(prompts, max_new_tokens=8, do_sample=True,
                         temperature=0.8, top_k=50, top_p=0.95, seed=7)
    beam = model.generate(prompts, max_new_tokens=8, num_beams=4)
    torch.cuda.synchronize()
    for name, t in (("ragged", rag), ("sampled", smp), ("beam", beam)):
        t = t.cpu().numpy()
        if t.shape != (4, 136) or t.min() < 0 or t.max() >= V \
                or not np.array_equal(t[:, :128], prompts):
            raise AssertionError(f"generate() {name}: bad output")
    rag_ok = bool(torch.equal(rag[1, 40:], alone[0]))
    print(f"generate() at 8 new tokens: ragged (pads 0, 40, 0, 100; row 1 "
          f"equals its unpadded prompt's: {rag_ok}), sampled (t 0.8, top-k "
          f"50, top-p 0.95, seed 7) and 4-beam runs: shapes and tokens ok; "
          f"{len(model.__dict__['_decode_fn_cache'])} step programs cached")
    model.release_decode_programs()
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import build
    from tools.port_train_bench import card_line

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build(ptxas_verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(sorted(build.KERNEL_SOURCES))})")
    for name, text in sorted(logs.items()):
        kernel = ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = _kernel_name(entry.group(1))
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  [{name}] {kernel}: {line.strip()}")

    check_flash_sass()
    check_megakernel_sass()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32 off for matmul and cuDNN (full fp32 products)")
    rms, pa, pa8, flash, rope, adamw = {}, {}, {}, {}, {}, {}
    xent_f, xent_b, gather = {}, {}, {}
    rms_res, mega, mega8, rms_bwd = {}, {}, {}, {}
    heads = {}          # kernel name -> its row at the headline shapes
    check_rms_norm(torch, rms, (torch.float32, 8))
    check_paged_attention(torch, pa, 32)
    check_paged_attention_int8(torch, pa8)
    check_flash(torch, flash)
    print("flash at ERNIE's shape (16, 1024, 12, 64): "
          + json.dumps(flash["ernie"]))
    check_rope(torch, rope)
    check_adamw(torch, adamw)
    check_rms_norm_backward(torch, rms_bwd)
    check_xent(torch, xent_f, xent_b)
    check_moe_gather(torch, gather)
    check_adamw_bf16_moments(torch)
    check_headline_kernels(torch, heads)
    heads.update({f"flash_attention_{'bwd_' if k != 'fwd' else ''}{k}": row
                  for k, row in flash["headline"].items()})
    check_rms_norm_residual(torch, rms_res)
    check_decode_layer(torch, mega, mega8)
    residual = rms_residual_entry(torch)
    torch.cuda.empty_cache()
    serving, model, ref = serving_path(torch, card)
    torch.cuda.empty_cache()
    serving8, ref8 = serving_int8_path(torch, card, model)
    megakernel = serving_megakernel_path(torch, card, model,
                                         {"fp32": ref, "int8": ref8})
    torch.cuda.empty_cache()
    dense, dense_engine = serving_dense_path(torch, card, model, ref)
    gen = generate_path(torch, card, model, dense_engine)
    del dense_engine, model
    torch.cuda.empty_cache()
    print(f"after the serving paths: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    train, idle7 = train_path(torch, card)
    torch.cuda.empty_cache()
    loader = io_path(torch, card, idle7)
    torch.cuda.empty_cache()
    ernie = ernie_moe_path(torch, card)
    torch.cuda.empty_cache()
    headline = headline_path(torch, card)
    paths = dict(residual=residual, serving=serving, int8_serving=serving8,
                 megakernel_serving=megakernel, dense_serving=dense,
                 generate=gen, training=train, ernie_moe_training=ernie,
                 headline_training=headline, io_training=loader)
    counts = {k: sum(c[k] for c in paths.values()) for k in serving}
    print("launches: " + "; ".join(f"{name} {c}"
                                   for name, c in paths.items()))
    src = "paddle_tpu_torch/csrc/"
    fa = "paddle_tpu/ops/pallas/flash_attention.py"
    kernels = [
        dict(name="rms_norm", route="cuda", source=src + "rms_norm.cu",
             replaces="paddle_tpu/ops/pallas/fused.py:58",
             launches=counts["rms_norm"], **rms),
        dict(name="paged_attention_decode", route="cuda",
             source=src + "paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:226",
             launches=counts["paged_attention_decode"], **pa),
        dict(name="paged_attention_decode_int8", route="cuda",
             source=src + "paged_attention.cu",
             replaces="paddle_tpu/ops/pallas/paged_attention.py:236",
             launches=counts["paged_attention_decode_int8"], **pa8),
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention.cu", replaces=fa + ":104",
             launches=counts["flash_attention_fwd"], **flash["fwd"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source=src + "flash_attention.cu", replaces=fa + ":138",
             launches=counts["flash_attention_bwd_dq"], **flash["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source=src + "flash_attention.cu", replaces=fa + ":165",
             launches=counts["flash_attention_bwd_dkv"], **flash["dkv"]),
        dict(name="rope", route="cuda", source=src + "rope.cu",
             replaces="paddle_tpu/ops/pallas/fused.py:196",
             launches=counts["rope"], **rope),
        dict(name="adamw", route="cuda", source=src + "adamw.cu",
             replaces="paddle_tpu/ops/pallas/fused.py:295",
             launches=counts["adamw"], **adamw),
        dict(name="xent_fwd", route="cuda", source=src + "xent.cu",
             replaces="paddle_tpu/ops/pallas/xent.py:127",
             launches=counts["xent_fwd"], **xent_f),
        dict(name="xent_bwd", route="cuda", source=src + "xent.cu",
             replaces="paddle_tpu/ops/pallas/xent.py:139",
             launches=counts["xent_bwd"], **xent_b),
        dict(name="moe_gather", route="cuda", source=src + "moe_gather.cu",
             replaces="paddle_tpu/ops/pallas/moe_dispatch.py:105",
             launches=counts["moe_gather"], **gather),
        dict(name="rms_norm_bwd", route="cuda", source=src + "rms_norm.cu",
             replaces="paddle_tpu/ops/pallas/fused.py:119",
             launches=counts["rms_norm_bwd"], **rms_bwd),
        dict(name="rms_norm_residual", route="cuda",
             source=src + "rms_norm.cu",
             replaces="paddle_tpu/ops/pallas/fused.py:65",
             launches=counts["rms_norm_residual"], **rms_res),
        dict(name="decode_layer", route="cuda",
             source=src + "decode_layer.cu",
             replaces="paddle_tpu/ops/pallas/decode_layer.py:278",
             launches=counts["decode_layer"], **mega),
        dict(name="decode_layer_int8", route="cuda",
             source=src + "decode_layer.cu",
             replaces="paddle_tpu/ops/pallas/decode_layer.py:278",
             launches=counts["decode_layer_int8"], **mega8),
    ]
    for k in kernels:
        if k["name"] in heads:      # the same keys at phase 9's shapes
            k["headline"] = dict(heads[k["name"]],
                                 launches=headline[k["name"]])
    unused = [k["name"] for k in kernels if not k["launches"] > 0]
    if unused:
        raise AssertionError(f"kernels no path launched: {unused}")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
