#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py                 # needs one GPU

Phases, each of which raises on failure (nothing is caught):

1. Card, torch and CUDA versions; build every kernel from ``csrc/`` with
   ``nvcc`` (one process per source, all started together), printing the
   build seconds and the ptxas register/shared-memory report; the bf16
   flash kernels' SASS must hold wgmma (``HGMMA``) and TMA (``UTMALDG``)
   instructions, the decode-layer megakernel's TF32 wgmma, every
   instance of the weight-only product bf16 tensor-core products
   (``HMMA``) and cp.async (``LDGSTS``).
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
   published widths at 12 layers (``_SERVING_LAYERS``: the depth cut
   from 32 for the script's time, for phases 3-6 and 11-15 alike), fp32
   (random weights from a seeded generator, created on the card), 12
   requests with a shared prefix and one sampled stream (threefry, as
   ``jax.random``). The engine captures
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
   max_len=2048, kv_int8=True)``, a 4097-block int8 arena (17.72 GB at
   32 layers, where an fp32 arena of 68.7 GB would not fit beside the
   fp32 weights; three eighths of both at 12); 32 requests of 256-1744
   prompt tokens, four sharing a prefix, two sampled. Outputs, block
   accounting, exact launch counts, the
   error bound, both compile counts 1, one decode step with all 32 slots
   at lengths over 1024 (kernels against plain versions), one profiled
   decode block, and how far the greedy streams agree with an fp32
   arena's (reported, not gated: quantized logits may diverge within
   the bound).
5. Megakernel decode serving on the same model: the engines of
   phases 3 and 4 with ``megakernel=True`` (phase 4's engines freed
   first) serve the same requests; exact launch counts (the megakernel
   once per layer and decode step, the paged-decode kernels never),
   ``megakernel_kernel_calls() == L``, both compile counts 1, greedy
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
   launch counts; then three more epochs time their steps 2-4 (host
   clock, unprofiled, the batch's fetch included), each followed by a
   step of the same graph fed a batch already on the card: the idle the
   loader adds, from the medians of the 9 steps of each side, must stay
   within 2 points. The profiled idle shares of a loader-fed step
   in each of the first two epochs are printed beside phase 7's (in the
   first its pinned staging block is new: the capture emptied the host
   allocator's cache).

11. Serving resilience and observability (run after phase 6, on its
   7B model before it is freed; the dense engine of phase 6 freed
   first). Phases 3-6 already serve through the same ``Server``, the NaN
   sentinel on and faults disarmed; phase 3 prints its decode step ms
   beside the one before the sentinel's flags. Four engines at
   ``num_slots=8, max_len=256, decode_block=8`` (a 129-block arena,
   2.2 GB): ``PagedEngine(block_size=16, prefill_chunk=32)`` fp32, the
   same with ``kv_int8=True`` and with ``megakernel=True``, and
   ``ContinuousBatchingEngine(prompt_buckets=(64, 128))``; 12 requests
   of 16-128 prompt tokens from ``RandomState(0)``, 64 new tokens each,
   two sharing a 64-token prefix, one sampled, a prefill budget of 64
   tokens a tick. Each engine serves a clean run (the reference
   streams; exact launches). Then (a) on the paged fp32 and the dense
   engine a seeded chaos schedule (``serving.step_block``,
   ``serving.harvest``, ``serving.prefill_tick``, ``serving.allocate``,
   ``server.tick`` at p 0.05, seed 0): every stream token-identical to
   the clean run, no block leaked, one capture per program, launches
   exact for the blocks and chunks actually replayed, retries and step
   failures printed; (b) on all four, ``serving.poison`` at the fourth
   block: its request alone ends "poisoned", every other stream as in
   the clean run (the NaN written into the static pool must reach the
   sentinel through the card's kernels); (c) on the paged fp32 and the
   dense engine: served tick by tick until a request is mid-prefill
   (queued, dense) while another decodes, snapshot to a temporary
   directory, the engine freed, a fresh one built (its graphs captured
   anew), ``Server.restore`` into it and the run finished: streams
   token-identical, one capture per program; the snapshot's bytes,
   write and restore seconds printed, the file deleted. On the restored
   fp32 engine: (d) ``serving.step_block:every=1``: every request ends
   ``circuit_open``, the flight ring is dumped, every block comes back;
   (e) two requests with ``deadline_ticks`` end as ``timeout`` (blocks
   released exactly), and with ``max_queue_depth=6`` the other six are
   shed; (f) the clean run again with request tracing armed, metrics on
   and a host-only ``profiler.Profiler`` (the native host tracer): the
   exported trace loads and holds one terminal per request, the token
   and step counters equal ``Server.stats()``, the streams equal the
   disarmed run's; tokens/s armed and disarmed are printed, not gated.
   The phase prints its seconds.
12. The decode features (run after phase 11, on phase 3's 7B model
   before it is freed). (a) The weight-only product kernel
   (``csrc/weight_only_gemm.cu``) against its plain version
   (``dequantize_array`` + ``F.linear``) at every product of a 7B decode
   step (4096->4096, 4096->11008, 11008->4096, 4096->32000), int8 per
   channel and int4 with group 128, at 1, 8, 32 (the prefill chunk), 40
   (the verify step) and 64 (one full tile) rows, each within the
   summation-order bound (its share printed) and timed beside its bound
   (bytes, or the kernel's bf16 MMA operations: 6 x 2MNK for fp32 x at
   989 TFLOP/s); the plain version and the library call at 8 rows:
   ``torch._weight_int8pack_mm`` (if the build takes fp32 activations)
   for int8, ``torch._weight_int4pack_mm`` (bf16 activations, codes
   packed by ``torch._convert_weight_to_int4pack``) for int4. On phase 3's engine shape: (c) ``spec=SpecConfig(k=4)``
   on the paged and the dense engine serve phase 3's 12 requests and 3
   repetitive prompts: greedy streams token-identical to phase 3's (and
   to a plain paged engine's), one verify capture, exact launches,
   acceptance rate, tokens a verify step and verify-step ms printed; (d)
   a ``Frontend`` over the plain paged engine, tenants a and b weighted
   2:1, 10 low-priority streams and one priority-5 arrival: exactly one
   preemption and one resume, every stream identical to the unpreempted
   run and delivered whole through its callback; (b) ``quant="int8"``
   and ``QuantConfig("int4", group_size=128)`` paged engines serve the
   12 requests with exact launches (weight-only 7L + 1 per decode step
   and chunk, paged decode L per step), one capture per program, decode
   step ms, weight bytes a step, the error bound and peak memory
   printed, and one int8 decode block profiled (the weight-only kernel's
   share of the device's time); last, the model's linear weights are
   overwritten with each engine's dequantized codes and the plain
   engine's greedy streams must equal the quantized engine's (the
   dequant twin). The phase prints its seconds.

13. The disaggregated serving fleet (``serving.fleet``; run after phase
   12, on phase 3's 7B model rebuilt from seed 0, since phase 12's
   dequant twins overwrote the linears). Every worker takes that one
   model. (a) Two ``PrefillPagedEngine`` workers (4 slots, max_len 1024,
   block 16, chunk 32; built without a decode program) and two decode
   ``PagedEngine`` workers (8 slots, decode block 8) over the in-process
   transport serve phase 3's 12 requests: every stream (the sampled one
   too: its key travels) identical to phase 3's unified engine; exact
   launches (paged decode L per decode step on the decode workers,
   RMSNorm 2L + 1 per prefill chunk and per decode step, no other decode
   kernel); captures (decode, chunk) (0, 1) per prefill worker and
   (1, 1) per decode worker, whose chunk graph never replays; one handoff
   a request; wire bytes and ms a handoff (extract, encode, transport,
   decode, adopt) printed. (c) On (a)'s fleet: decode worker 1 killed
   mid-decode (streams redriven, identical to (a)'s); the localhost
   ``SocketTransport`` with ``transport.corrupt`` armed once (the same
   streams, a CRC drop and a resend); affinity off with request 9 pinned
   away from request 1's worker (at least one prefix fetch, the same
   streams). (d) One open-loop ``loadgen`` trace (7B's vocabulary,
   prompts 32-512, outputs 16-64, a 256-token shared prefix on half the
   requests, a quarter sampled) replayed against one ``Server`` over
   phase 3's engine shape and against (a)'s fleet: every request ends in
   a result, the fleet's streams equal the server's, and TTFT p50/p95 in
   ticks and seconds, decode tokens/s and the prefix hit rate printed
   for each. (b) The ``kv_int8`` fleet on the 12 requests: streams
   identical to a unified int8 server, int8 paged-decode launches exact,
   the fp32/int8 payload ratio printed. The phase prints its seconds.

14. The fleet's durable control plane and its SLO autoscaler
   (``serving.durability``, ``serving.autoscaler``; run after phase 13,
   on phase 3's 7B model rebuilt from seed 0). Two prefill engines (2
   slots, max_len 512, block 16, chunk 32) and two decode engines (4
   slots), phase 3's requests 0-7 (request 5 samples); every durability
   directory is a fresh temporary directory, removed when its arm ends.
   (a) A clean run gives the reference rows (equal to phase 3's engine);
   then a durable run takes requests 0-3, is checkpointed once one
   stream decodes while another is still being prefilled, takes requests
   4-7, runs two ticks and dies: its engines are freed, and
   ``Fleet.recover`` rebuilds every worker on engines built anew. Gates:
   every recovered row equals the clean run's, one terminal a request,
   no leaked block, captures (decode, chunk) (0, 1) a prefill worker and
   (1, 1) a decode worker, launches exact over the recovered run.
   Printed: the checkpoint's bytes and seconds, ``recover``'s seconds by
   part, the records replayed and streams redriven, journal appends and
   ms an append. (b) The same over ``kv_int8`` engines with
   ``journal.torn_tail`` armed once after the checkpoint: the recovery
   warns, reports the torn tail, and its rows equal a clean int8 run.
   (c) (a)'s shape with affinity off, watermarks 0.05/0.02 and a 4 GiB
   spill tier: evicted chains go to disk; request 1's prompt,
   resubmitted once its chain left every arena, is a spill hit with the
   same stream; spill bytes and ms a write and a read + adopt printed.
   (d) A kill-and-burst ``loadgen`` trace (7B's vocabulary, prompts
   32-256, outputs 16-48, one burst at 5x) through three static decode
   workers and through an autoscaled pool (min 1, max 3, queue-driven,
   engines built before the trace, one decode worker killed inside the
   burst): every request ends in a result or an explicit failure, the
   rows of both arms are identical, the pool scales up, is repaired by
   the next scale-up after the kill and drains back to 1, one decode
   graph an engine; decode worker-ticks and the TTFT share under twice
   the static arm's p50 printed for each arm. The phase prints its
   seconds and the largest directory's bytes.

15. Tensor-parallel serving (``serving.tp``; run after phase 14, on
   phase 3's 7B model rebuilt from seed 0) over a 2-way mesh whose two
   logical devices are this one card (``build_device_mesh({"mp": 2},
   devices=[cuda:0, cuda:0])``): each shard holds half of the q/k/v,
   gate/up and lm_head rows and half of the KV heads. (a) A paged exact
   ``tp=2`` engine with phase 3's geometry serves phase 3's 12 requests:
   every stream equal to phase 3's, captures (1, 1), exact launches
   (RMSNorm 2 (2L + 1) a step and a chunk, paged decode 2 L a step,
   RoPE none: per-row positions rotate in torch ops), each shard's arena
   half of phase 3's, the decode step's ms and a replayed block's idle
   share beside phase 3's; on 8 armed slots, one step of the sharded
   model's kernels against its plain versions (the kernels at the shard
   shapes) and against the unsharded model on the same K/V (the global
   arena gathered), each within 2e-3. (b) The int8 arena: launches,
   captures and the same two one-step checks; its streams against an
   unsharded int8 engine's are printed, not gated (a K/V an ulp apart
   moves an int8 code), and the cause is shown: one prompt prefilled
   on fp32 and int8 arenas at tp=1 and tp=2, layer 0's int8 rows
   ``quantize_kv`` of the fp32 twin's bit for bit, the fp32 K/V under
   half a step apart, the codes one apart at most; as a control, an
   unsharded int8 engine prefilling in chunks of 64 (no tensor
   parallelism) against the same streams and codes. (c) A dense exact ``tp=2`` engine (buckets
   64-512) on requests 0-7 against phase 3's greedy streams (phase 6
   holds the unsharded dense engine to them). (d) ``mode="psum"``: one
   request's step log-probs against the exact engine's (max |delta|
   printed), then ``int8=True``: the runtime bound, one measured hop's
   |int8 - fp32| hidden state within it, and a budget below it refused
   twice. (e) ``quant="int8"`` with exact ``tp=2``: streams equal to
   phase 12 (b)'s int8 streams, weight-only launches 2 (7L + 1) a step
   and a chunk, one step's kernels against the plain versions. (f) A snapshot of (a) mid-stream restored onto a fresh
   ``tp=2`` engine, and a prefix fetch from the ``tp=2`` owner adopted
   by a ``tp=1`` engine: streams equal. The phase prints its seconds and
   its peak memory.

16. The process-group runtime and data-parallel training (run after
   phase 9). ``tools/port_dp_worker.py`` launched with ``python -m
   paddle_tpu_torch.distributed.launch``. (a) ``headline_big_config
   ("full")`` (953.2M, bf16, AdamW with bf16 moments) on 2 ranks sharing
   the card (so ``init_parallel_env`` picks gloo, which stages CUDA
   tensors through pinned host memory), 4 x 2048 a rank (the headline's
   global b8) from ``RandomState(0)`` through ``DistributedBatchSampler``,
   ``DataLoader`` and ``device_prefetch``, 3 eager steps with
   ``fused_allreduce_gradients`` bucketed (25 MB): both ranks' parameters
   bit-identical after every step (SHA-256 over the native store); step
   1's synced gradient equal bit for bit to the mean of the two halves'
   gradients computed on one rank, and within 5e-2 (per tensor, relative)
   of the one-rank global batch's; finite losses; each rank's launches
   exact (phase 9's per step); step ms by part (forward+backward; the
   sync: device-to-host, transport, host-to-device; AdamW), the sync's
   bytes and GB/s, peak memory and each collective's route printed. (c)
   In the same job: a 64 MiB CUDA tensor's p2p round trip through the
   native store (the bulk guard warns once a rank), a collective of the
   subset group [1] (rank 0 takes no part), ``ElasticManager``
   membership of both ranks. (b) The headline width at 2 layers (cut:
   the depth, so that the checkpoints stay small), 3 steps, each rank's
   atomic checkpoint after step 2; under ``max_restarts=1`` rank 1 exits
   after step 2, the pod is relaunched and resumes from the checkpoints:
   the final parameters bit-identical to the same job run uninterrupted
   beside it; (b)'s pods run after phase 17 (a), beside 17's other
   gate-only work (below), so they print no time. (d) A one-rank nccl
   group on the card (``init_parallel_env`` picks nccl for a rank with a card of its own): ``all_reduce``,
   ``broadcast`` and ``all_gather`` of a 256 MiB fp32 bucket, each equal
   to its input and timed (one rank moves nothing between cards). The
   phase prints its seconds; its workers' launches are the launches
   line's ``dp_training``. Phases 16 and 17 run in this order: 16 (a),
   17 (c), 17 (a) with (b)'s save and 2-rank load, each alone (their
   times are measurements); then side by side 16 (b), 17 (b)'s one-rank
   load and 17 (d), whose gates are bitwise or a tolerance and whose
   times are not printed; then 16 (d).

17. Group-sharded (ZeRO) training, the sharded checkpoint, the in-graph
   bucketer and gradient merge (run after phase 16).
   ``tools/port_zero_worker.py`` launched with ``python -m
   paddle_tpu_torch.distributed.launch``: phase 16's model, data and 2
   gloo ranks sharing the card. (a) From phase 16 (a)'s weights and
   batches, 2 steps each, held to its data-parallel digests after those
   steps (the DP reference: the same loop, so the job does not run it
   again): ``group_sharded_parallel`` ``os``, ``os_g``
   built through ``fleet.init`` + ``fleet.distributed_model`` +
   ``fleet.distributed_optimizer`` (``sharding_configs={"stage": 2}``)
   and ``p_g_os``: every stage's parameters bit-identical
   to DP's after every step (SHA-256 digests over the store), the ranks
   agreeing, finite losses, each rank's launches exact a step (phase
   16's, AdamW once a parameter); each stage's peak and resting memory
   a rank, slot bytes, step ms by part and bytes a collective printed.
   (b) ``save_state_dict`` of the ``os`` state (model and optimizer)
   after step 1, ``async_save=True`` then ``wait_async_save()``; loaded
   at 2 ranks into a fresh ``p_g_os`` run and in a fresh one-rank
   process: every region bit-equal to the saved one, and step 2 from
   each load bit-equal to the continuing job's (the one-rank process
   takes the two ranks' mean gradient); save and load seconds and the
   largest host buffer against the largest region (the one-rank
   process's load prints no time: it runs beside 16 (b)). (d)
   ``fleet.distributed_optimizer`` with ``gradient_merge_configs=
   {"k_steps": 2}`` (and sharding stage 1) at the headline width and 2
   layers (cut: the depth, for the phase's time), in a 2-rank job of its
   own: two micro-steps of 2 x 2048 against one step of 4 x 2048, the
   merged gradient within 5e-2 (per tensor, relative norm; bf16). (c) In
   this process, before the job:
   ``BucketedGradSync`` over a 2-way ``("dp",)`` mesh of cuda:0 on
   per-shard fp32 gradients of the headline's 12 shapes, captured once
   as a CUDA graph and replayed: the replay and the eager hook bit-equal
   to the plain mean; ``compress="int8"`` with ``error_bound=0``
   bit-equal to fp32 and a loose budget within ``int8_error_bound`` (on
   the embedding and the norms); then ``run_comms_bench`` over that
   mesh (``within_bound``, ``constant_exact``). The parts print their
   seconds; its workers' launches are the launches line's
   ``zero_training``.

18. Tensor-parallel (mp) training (run after phases 16 and 17, alone on
   the card). ``tools/port_mp_worker.py`` launched with ``python -m
   paddle_tpu_torch.distributed.launch``, 2 gloo ranks sharing the
   card. (a) ``headline_big_config("full")`` with ``tensor_parallel=
   True`` (953.2M, bf16, AdamW with bf16 moments, full recompute, the
   stacked trunk; hidden 2048, 16 heads of 128, MLP 5632, vocabulary
   32000): ``fleet.init(mp_degree=2)``, ``fleet.distributed_model``
   (each rank keeps its half of every split parameter: 8 heads, 2816
   MLP columns, 16000 vocabulary rows), ``fleet.distributed_optimizer``;
   both ranks take phase 16's first 4 x 2048 batch and the next, 2
   eager steps. Gates: the replicated parameters' SHA-256 digests equal
   across the ranks after every step (over the store); finite losses;
   rank 0 first runs the same two steps on the whole model from the same
   weights and batches, and the mp loss, step 1's gradients and each
   step's parameters (gathered over the mp group) are held to it
   (``tools/port_mp_worker.py``'s tolerances: loss 2^-9 relative,
   gradients 5e-2 and parameters 9e-3 per tensor, relative norm, and
   step 1's gradients no further from fp32 gradients of the same weights
   than 1.5x one rank's bf16 gradients; how they follow from the
   rounding sites: there); each rank's launches
   exact a step (phase 16's per step on the split shapes); 5L + 5 mp
   collectives a step. Printed: step ms by part (forward and backward,
   of which the mp all-reduces' count, bytes and seconds; AdamW), peak
   and resting memory a rank beside phase 16's data-parallel peak. (b)
   ``save_state_dict(convert.jax_state_dict(model))`` of (a)'s
   parameters after step 2 (JAX's layout and global shapes), loaded in
   a fresh one-rank process at the headline width: every saved region
   bit-equal (SHA-256). (c) In this process, after the job: flash
   forward, dq and dkv at one rank's shape (4, 2048, 8, 128) bf16 (with
   phase 2's flash cases), RoPE on q and k of that shape, RMSNorm
   forward and backward on (8192, 2048) bf16, AdamW over bf16 moments
   on the split stacks (16, 2816, 2048) and (16, 2048, 2816), each
   against its plain version. The phase prints its seconds; its
   workers' launches are the launches line's ``mp_training``.

Launch counters are zeroed just before each path and read just after.
``phase seconds: {...}`` gives each phase's wall seconds (phase 1 with
the builds, 2 with the kernel checks; 6 holds ``generate()``), then the
``launches:`` line. The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a GPU the script
exits 1 before printing any result."""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shlex
import signal
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


def check_weight_only_sass():
    """The weight-only product as built: every instance (int8 and int4
    codes, fp32 and bf16 x, the 8-row and the 64-row tile) runs its
    products on the tensor cores (``HMMA`` with ``BF16`` operands in the
    SASS that ``cuobjdump`` prints of the library) and streams its codes
    with ``LDGSTS`` (cp.async)."""
    import os
    from paddle_tpu_torch.ops import build
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           str(build.lib_path("weight_only_gemm"))],
                          capture_output=True, text=True, check=True).stdout
    found = {}
    for part in sass.split("Function : ")[1:]:
        head = part.split("\n", 1)[0]
        if "weight_only_gemm_kernel" in head:
            hmma = len(re.findall(r"HMMA\.\S*BF16", part))
            found[head.strip()] = (hmma, part.count("LDGSTS"))
    print(f"weight_only_gemm in SASS: {len(found)} instances, (bf16 HMMA, "
          f"LDGSTS) each: " + ", ".join(f"{h}/{g}" for h, g in
                                        found.values()))
    if len(found) != 8 or not all(h and g for h, g in found.values()):
        raise AssertionError(f"weight_only_gemm instances without bf16 "
                             f"tensor-core products or cp.async: {found}")


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
    S, d, bs, mb = 8, 128, 16, 64
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
        # Llama-2-7B's heads, GQA, and one shard's of a tp=2 engine
        for h, kvh in ((32, 32), (32, 8), (16, 16)):
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
            if (dtype, h, kvh) == (torch.float32, 32, main_kvh):
                results.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by="bytes",
                               library_ms=None)


def check_paged_attention_int8(torch, results):
    """The int8 paged-decode kernel against its plain version (the
    per-block loop of the JAX ``_int8_decode_fallback``): the main shape
    of the int8 serving path (32 slots, h = kvh = 32, d 128, block 16,
    every slot at length 2048: 128 table entries), GQA kvh = 8, bf16 q,
    a ragged case (lengths 1 and 17, trash entries, a dead row) and one
    shard's heads of a tp=2 engine (h = kvh = 16).
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
    cases = [("main", 32, 32, 32, [mb * bs] * 32, torch.float32),
             ("gqa", 32, 32, 8, [mb * bs] * 32, torch.float32),
             ("bf16", 32, 32, 32, [mb * bs] * 32, torch.bfloat16),
             ("ragged", 8, 32, 32, [1, 17, 1, 17, 300, 2048, 17, 5],
              torch.float32),
             ("tp=2 shard", 32, 16, 16, [mb * bs] * 32, torch.float32)]
    for name, S, h, kvh, lengths_h, dtype in cases:
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
    (16, 1024, 12, 64) bf16 causal, the headline training path's
    (8, 2048, 16, 128) bf16 causal and one rank's of its mp 2 run (4,
    2048, 8, 128). The backward pair gets the kernel's o and lse and the
    same delta on both sides.

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
    times go into the kernels line, the ERNIE, headline and mp 2 shapes'
    into ``results["ernie"]``, ``results["headline"]`` and
    ``results["mp2"]``."""
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
             ("headline", 8, 2048, 16, 16, 128, torch.bfloat16),
             ("mp2", 4, 2048, 8, 8, 128, torch.bfloat16)]
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
            elif name in ("ernie", "headline", "mp2"):
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
            "rms_norm_bwd": 2 * L + 1, "weight_only_gemm": 0}


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
    # by several points from launch to launch): three more epochs' steps
    # 2-4 (step 1 forks the workers), each followed by a step of the same
    # graph fed a batch that is on the card already, so host noise hits
    # both sides alike; each step ends in its loss read, and each side's
    # figure is the median of its 9 steps
    walls = {"loader": [], "direct": []}
    on_card = (torch.from_numpy(ids[:B]).cuda(),
               torch.from_numpy(labels[:B]).cuda())
    for _ in range(3):
        batches = io.device_prefetch(loader, size=2)
        step(tuple(next(batches)))
        for _ in range(n_seq // B - 1):
            walls["loader"].append(
                _step_wall(torch, step, lambda: tuple(next(batches))))
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
    print(f"[{card}] io step walls ms, loader-fed (epochs 3-5, steps "
          f"2-4): {', '.join(f'{1e3 * x:.3f}' for x in walls['loader'])}; "
          f"fed from the card, interleaved: "
          f"{', '.join(f'{1e3 * x:.3f}' for x in walls['direct'])}"
          f"; idle added by the loader (medians of 9) {100 * added:.2f} "
          f"points (gate: within 2). Profiled idle: loader-fed {pct(idle[1])} (epoch "
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
                "decode_layer": 0, "decode_layer_int8": 0, "rms_norm_bwd": 0,
                "weight_only_gemm": 0}
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
    the arena). Each fp32 layer: the kernels' reassociated sums and
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


# The serving phases' model (3-6, 11-15): Llama-2-7B's published widths
# at this depth, cut from 32 layers for the script's time (PERF.md §4;
# every gate there holds at any depth: streams against references made at
# the same depth in the same run, launch counts by the config's L).
_SERVING_LAYERS = 12


def _serving_config():
    from paddle_tpu_torch.models import llama_7b_config
    return llama_7b_config(num_hidden_layers=_SERVING_LAYERS)


def serving_path(torch, card):
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import PagedEngine, Scheduler, Server
    cfg = _serving_config()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    print(f"model: Llama-2-7B widths, {cfg.num_hidden_layers} layers, "
          f"{model.num_params() / 1e9:.3f}B params fp32 on the card in "
          f"{time.perf_counter() - t0:.2f} s")
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
    print(f"[{card}] decode_step_ms={st['decode_step_ms']:.3f} with the "
          f"sentinel's ok flags in the block ({cfg.num_hidden_layers} "
          f"layers; PERF.md at 32 layers before them: 23.4-24.0 ms)")

    _arm_fp32_check(engine, cfg)
    _check_step_logprobs(torch, model, engine, "")
    idle = profile_decode_block(torch, engine, card)
    greedy = {i: res[rid] for i, rid in enumerate(rids) if not reqs[i][2]}
    return counts, model, dict(stats=st, idle=idle, greedy=greedy,
                               rows=[res[rid] for rid in rids])


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
    "weight_only_gemm": ("weight_only_gemm_kernel<",),
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
    wo = [(t, n) for name, t, n in kernels
          if "weight_only_gemm_kernel" in name]
    if wo:
        t, n = sum(r[0] for r in wo), sum(r[1] for r in wo)
        print(f"[{card}] {arena} weight-only kernel inside the replayed "
              f"block: {n} launches, {t / 1e3:.3f} ms, {100 * t / busy_us:.1f}"
              f"% of the device's busy time, {t / n:.3f} us each "
              f"(profiler)")
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
    """Paged serving over the int8 KV arena at Llama-2-7B's widths, on
    the fp32 serving path's model (see the module docstring). Returns the launch counts of the served requests."""
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


# -- phase 11: serving resilience and observability ---------------------------

_RES_KW = dict(num_slots=8, max_len=256, decode_block=8)
_RES_PAGED = dict(_RES_KW, block_size=16, prefill_chunk=32)
_RES_BUDGET = 64
_CHAOS = ("serving.step_block:p=0.05;serving.harvest:p=0.05;"
          "serving.prefill_tick:p=0.05;serving.allocate:p=0.05;"
          "server.tick:p=0.05")


def _resilience_requests(rng, vocab):
    """The phase's 12 requests: 16..128 prompt tokens, 64 new tokens
    each; requests 1 and 7 share a 64-token prefix (7 arrives at tick
    4); request 5 samples (temperature 0.8, top-k 50, seed 7). Returns
    (prompt, max_new, sampling kwargs, arrival tick) per request."""
    prefix = rng.randint(0, vocab, (64,))
    lens = rng.randint(16, 129, size=12)
    lens[1], lens[7] = 96, 112
    out = []
    for i, L in enumerate(lens):
        p = rng.randint(0, vocab, (int(L),))
        if i in (1, 7):
            p[:64] = prefix
        kw = dict(temperature=0.8, top_k=50, seed=7) if i == 5 else {}
        out.append((p.astype("int32"), 64, kw, 4 if i == 7 else 0))
    return out


def _res_engine(torch, model, kind):
    """One of the phase's four engines, built on the card (its programs
    captured at construction; the dense prefills at first admission)."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine, PagedEngine
    t0 = time.perf_counter()
    if kind == "dense":
        eng = ContinuousBatchingEngine(model, prompt_buckets=(64, 128),
                                       device="cuda", **_RES_KW)
    else:
        eng = PagedEngine(model, kv_int8=kind == "int8",
                          megakernel=kind == "megakernel", device="cuda",
                          **_RES_PAGED)
    torch.cuda.synchronize()
    print(f"phase 11 {kind} engine built (programs captured) in "
          f"{time.perf_counter() - t0:.2f} s")
    return eng


def _res_serve(torch, engine, reqs, spec=None, seed=0, res_kw=None,
               obs=None, submit_kw=None, totals=None):
    """Serve ``reqs`` on a reset engine through a fresh ``Server`` (the
    fault schedule ``spec`` armed for the run, else disarmed), launch
    counts zeroed just before and read just after (added to ``totals``).
    Returns (server, results by request index, launch counts)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import ResilienceConfig, Scheduler, Server
    from paddle_tpu_torch.utils import faults
    engine.reset()
    srv = Server(engine, Scheduler(prefill_token_budget=_RES_BUDGET),
                 resilience=ResilienceConfig(**(res_kw or {})),
                 observability=obs)
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr,
                       **kw, **((submit_kw or {}).get(i, {})))
            for i, (p, mn, kw, arr) in enumerate(reqs)]
    ops.reset_launch_counts()
    with faults.injected(spec or "", seed=seed):
        res = srv.run_until_idle(max_ticks=2000)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if totals is not None:
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
    if srv.scheduler.pending() or engine.has_live():
        raise AssertionError("the server did not drain")
    return srv, [res[r] for r in rids], counts


def _res_check_pool(engine, label):
    """No block leaked: the arena accounting holds and every usable
    block is free or LRU-retained again."""
    m = getattr(engine, "manager", None)
    if m is None:
        return
    m.assert_consistent()
    if m._ref or m.available() != m.usable_blocks():
        raise AssertionError(f"{label}: blocks leaked ({m._ref})")


def _res_check_compiles(engine, label):
    dec = engine.decode_compile_count()
    if hasattr(engine.backend, "prefill_programs"):      # dense
        pre = [p.captures for p in
               engine.backend.prefill_programs().values()]
        ok = dec == 1 and all(c == 1 for c in pre)
    else:
        pre = engine.prefill_compile_count()
        ok = dec == pre == 1
    if not ok:
        raise AssertionError(f"{label}: captures decode {dec}, prefill "
                             f"{pre} (each program must be captured once)")


def _res_same(label, got, want, skip=()):
    """Every stream but ``skip`` token-identical to the clean run."""
    import numpy as np
    from paddle_tpu_torch.serving import RequestFailure
    for i, (v, w) in enumerate(zip(got, want)):
        if i in skip:
            continue
        if isinstance(v, RequestFailure) or not np.array_equal(v, w):
            raise AssertionError(f"{label}: request {i} is {v!r}, not its "
                                 "clean-run stream")


def _res_launches(engine, counts, label):
    """Exact launches of a run: the per-block (per-chunk, per-prefill)
    launches times the blocks (chunks, prefills) actually replayed."""
    if hasattr(engine, "manager"):
        kernel = ("decode_layer" if engine.megakernel() else
                  "paged_attention_decode") + \
            ("_int8" if engine.kv_int8 else "")
        _check_launches(engine, counts, kernel)
    else:
        _check_dense_launches(engine, counts)
    print(f"{label} launches exact: {engine.steps} decode steps, "
          f"{getattr(engine, 'prefill_chunks', engine.prefills)} prefill "
          f"{'chunks' if hasattr(engine, 'manager') else 'calls'}: "
          + ", ".join(f"{k} {n}" for k, n in counts.items() if n))


def _res_kill(torch, kind, engine, reqs, tmp, totals):
    """(c), the kill: serve tick by tick until a request is mid-prefill
    (paged; queued, dense) while another decodes, then snapshot. Returns
    (path, bytes, write seconds)."""
    import os
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import Scheduler, Server
    engine.reset()
    srv = Server(engine, Scheduler(prefill_token_budget=_RES_BUDGET))
    for p, mn, kw, arr in reqs:
        srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
    ops.reset_launch_counts()
    k = 0
    while True:
        srv.run_until_idle(max_ticks=1)
        k += 1
        waiting = bool(engine._jobs) if kind != "dense" \
            else srv.scheduler.pending() > 0
        if k >= 2 and waiting and engine.has_decoding():
            break
        if k > 50:
            raise AssertionError(f"{kind}: no tick with a request waiting "
                                 "and one decoding")
    jobs = getattr(engine, "_jobs", [])
    decoding = [r.request.request_id for s, r in engine.live_runs()
                if s not in engine._prefill_slots]
    print(f"phase 11 {kind} killed after {k} ticks: requests {decoding} "
          f"decoding, {[j.run.request.request_id for j in jobs]} "
          f"mid-prefill (prompt tokens resident "
          f"{[(j.done, len(j.prompt)) for j in jobs]}), "
          f"{srv.scheduler.pending()} queued, {len(srv.results)} done")
    path = os.path.join(tmp, f"{kind}.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.snapshot(path)
    write_s = time.perf_counter() - t0
    for name, n in ops.launch_counts().items():
        totals[name] = totals.get(name, 0) + n
    return path, os.path.getsize(path), write_s


def _res_restore(torch, model, kind, reqs, clean, card, snap, totals):
    """(c), the restart: a fresh engine of the same configuration, the
    snapshot restored into it, every stream finished. Returns the fresh
    engine."""
    import os
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import Scheduler, Server
    path, nbytes, write_s = snap
    fresh = _res_engine(torch, model, kind)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv = Server.restore(path, fresh,
                         Scheduler(prefill_token_budget=_RES_BUDGET))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    res = srv.run_until_idle(max_ticks=2000)
    torch.cuda.synchronize()
    for name, n in ops.launch_counts().items():
        totals[name] = totals.get(name, 0) + n
    _res_same(f"{kind} restored", [res[r] for r in range(len(reqs))], clean)
    _res_check_compiles(fresh, f"{kind} restored")
    _res_check_pool(fresh, f"{kind} restored")
    os.remove(path)
    os.remove(path + ".flight.json")
    print(f"[{card}] phase 11 {kind} kill and restore: streams identical "
          f"to the clean run; snapshot {nbytes} bytes "
          f"({nbytes / 1e9:.3f} GB), written in {write_s:.3f} s "
          f"({nbytes / 1e9 / write_s:.3f} GB/s), restored in "
          f"{restore_s:.3f} s ({nbytes / 1e9 / restore_s:.3f} GB/s)")
    return fresh


def serving_resilience_path(torch, card, model):
    """Phase 11 (see the module docstring). Returns the launch counts of
    every run of the phase."""
    import gc
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.serving import RequestFailure
    t_phase = time.perf_counter()
    reqs = _resilience_requests(np.random.RandomState(0),
                                model.config.vocab_size)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    totals = {}
    clean_runs = {}
    chaos_cfg = dict(retry_attempts=12, retry_backoff_s=0.001,
                     breaker_threshold=40, seed=0)
    try:
        for kind in ("fp32", "dense", "int8", "megakernel"):
            engine = _res_engine(torch, model, kind)
            label = f"phase 11 {kind}"
            srv, clean, counts = _res_serve(torch, engine, reqs,
                                            totals=totals)
            clean_runs[kind] = (srv.stats(), clean)
            _res_launches(engine, counts, f"{label} clean")
            _res_check_compiles(engine, label)
            _res_check_pool(engine, label)
            if any(isinstance(v, RequestFailure) for v in clean):
                raise AssertionError(f"{label}: the clean run failed "
                                     "requests")
            st = srv.stats()
            print(f"[{card}] {label} clean: decode_step_ms="
                  f"{st['decode_step_ms']:.3f} (with the ok flags; "
                  f"PERF.md at 32 layers before them: 23.4-24.0 at 8 "
                  f"slots of 1024), "
                  f"tokens_per_s={st['tokens_per_sec']:.1f}, "
                  f"{st['decode_steps']} steps")
            if kind in ("fp32", "dense"):
                # (a) chaos
                srv, got, counts = _res_serve(torch, engine, reqs,
                                              spec=_CHAOS, seed=0,
                                              res_kw=chaos_cfg,
                                              totals=totals)
                _res_same(f"{label} chaos", got, clean)
                _res_check_pool(engine, f"{label} chaos")
                _res_check_compiles(engine, f"{label} chaos")
                _res_launches(engine, counts, f"{label} chaos")
                st = srv.stats()
                if not st["step_failures"] or st["breaker_open"]:
                    raise AssertionError(f"{label} chaos: {st}")
                print(f"{label} chaos ({_CHAOS}, seed 0): every stream "
                      f"identical to the clean run; retries="
                      f"{st['retries']} step_failures="
                      f"{st['step_failures']} tick_faults="
                      f"{st['tick_faults']} admissions deferred by "
                      f"allocate faults: "
                      f"{sum(1 for e in srv.flight.events() if e['kind'] == 'block_pool_defer')}"
                      f" (flight ring)")
            # (b) poison at the fourth block
            srv, got, _ = _res_serve(torch, engine, reqs,
                                     spec="serving.poison:at=4",
                                     totals=totals)
            fails = [i for i, v in enumerate(got)
                     if isinstance(v, RequestFailure)]
            if len(fails) != 1 or got[fails[0]].reason != "poisoned":
                raise AssertionError(f"{label} poison: failures "
                                     f"{[(i, got[i]) for i in fails]}")
            _res_same(f"{label} poison", got, clean, skip=fails)
            _res_check_pool(engine, f"{label} poison")
            _res_check_compiles(engine, f"{label} poison")
            print(f"{label} poison at block 4: request {fails[0]} alone "
                  f"quarantined ({got[fails[0]].tokens_emitted} tokens), "
                  f"{len(got) - 1} streams identical to the clean run")
            if kind in ("fp32", "dense"):
                # (c) kill, free the engine, restart
                snap = _res_kill(torch, kind, engine, reqs, tmp, totals)
                del engine, srv
                gc.collect()
                torch.cuda.empty_cache()
                engine = _res_restore(torch, model, kind, reqs, clean, card,
                                      snap, totals)
                srv = None
            if kind == "fp32":
                _res_fp32_extra(torch, card, engine, reqs, clean, tmp,
                                totals, clean_runs["fp32"][0])
            del engine, srv
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 11 (serving resilience) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


def _res_fp32_extra(torch, card, engine, reqs, clean, tmp, totals, st0):
    """(d) breaker, (e) deadlines and shedding, (f) observability, on the
    restored fp32 engine."""
    import json as _json
    import os
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import ObservabilityConfig, metrics
    from paddle_tpu_torch.serving import RequestFailure
    label = "phase 11 fp32"
    # (d) breaker: every dispatch fails; the threshold is reached within
    # one tick's retries (a prefill tick that succeeds resets the count)
    dump_dir = os.path.join(tmp, "flight")
    srv, got, _ = _res_serve(
        torch, engine, reqs, spec="serving.step_block:every=1",
        res_kw=dict(retry_attempts=3, retry_backoff_s=0.001,
                    breaker_threshold=4),
        obs=ObservabilityConfig(flight_dump_dir=dump_dir), totals=totals)
    reasons = {v.reason if isinstance(v, RequestFailure) else "ok"
               for v in got}
    dump = srv.flight.last_dump_path
    if reasons != {"circuit_open"} or not dump or not os.path.exists(dump):
        raise AssertionError(f"{label} breaker: outcomes {reasons}, dump "
                             f"{dump}")
    _res_check_pool(engine, f"{label} breaker")
    print(f"{label} breaker (serving.step_block:every=1): all "
          f"{len(got)} requests circuit_open, flight ring dumped "
          f"({os.path.getsize(dump)} bytes), every block back")
    # (e) deadlines and shedding
    srv, got, _ = _res_serve(torch, engine, reqs, totals=totals,
                             submit_kw={2: dict(deadline_ticks=3),
                                        9: dict(deadline_ticks=2)})
    for i in (2, 9):
        v = got[i]
        if not (isinstance(v, RequestFailure) and v.reason == "timeout"):
            raise AssertionError(f"{label} deadline: request {i} is {v!r}")
    _res_same(f"{label} deadlines", got, clean, skip=(2, 9))
    _res_check_pool(engine, f"{label} deadlines")
    print(f"{label} deadlines: requests 2 (3 ticks, "
          f"{got[2].tokens_emitted} tokens) and 9 (2 ticks, "
          f"{got[9].tokens_emitted} tokens) timed out, blocks released "
          f"at exact refcounts, 10 streams identical to the clean run")
    srv, got, _ = _res_serve(torch, engine, reqs, totals=totals,
                             res_kw=dict(max_queue_depth=6))
    shed = [i for i, v in enumerate(got)
            if isinstance(v, RequestFailure) and v.reason == "shed"]
    if shed != list(range(6, 12)):
        raise AssertionError(f"{label} shedding: shed {shed}")
    _res_same(f"{label} shedding", got, clean, skip=shed)
    _res_check_pool(engine, f"{label} shedding")
    print(f"{label} shedding (max_queue_depth=6): requests {shed} shed, "
          f"the 6 others identical to the clean run")
    # (f) observability armed: request tracing, metrics, the profiler's
    # host ring through the native tracer (host spans only: a device
    # target would add CUPTI to every launch)
    was = metrics.enabled()
    metrics.REGISTRY.reset()
    metrics.enable(True)
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    prof._drain_events()
    try:
        with prof:
            srv, got, _ = _res_serve(
                torch, engine, reqs, totals=totals,
                obs=ObservabilityConfig(trace_requests=True))
    finally:
        metrics.enable(was)
    st = srv.stats()
    _res_same(f"{label} armed", got, clean)
    reg = metrics.REGISTRY
    m_tok = reg.get("pt_engine_tokens_emitted_total").value()
    m_steps = reg.get("pt_engine_decode_steps_total").value()
    if (m_tok, m_steps) != (st["tokens_emitted"], st["decode_steps"]):
        raise AssertionError(f"{label} metrics: tokens {m_tok}, steps "
                             f"{m_steps}; stats {st['tokens_emitted']}, "
                             f"{st['decode_steps']}")
    path = srv.export_trace(os.path.join(tmp, "trace.json"), profiler=prof)
    with open(path) as f:
        events = _json.load(f)["traceEvents"]
    rows = {e["tid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and
            str(e["args"].get("name", "")).startswith("request ")}
    terms = {}
    for e in events:
        if str(e.get("name", "")).startswith("terminal:"):
            terms[e["tid"]] = terms.get(e["tid"], 0) + 1
    host = sum(1 for e in events if e.get("name") == "serving.decode_block")
    if len(rows) != len(reqs) or any(terms.get(t) != 1 for t in rows) \
            or not host or not profiler._tracer():
        raise AssertionError(f"{label} trace: {len(rows)} request rows, "
                             f"terminals {terms}, {host} decode-block "
                             "host spans (native tracer needed)")
    print(f"[{card}] {label} observability armed: trace {len(events)} "
          f"events ({os.path.getsize(path)} bytes), one terminal per "
          f"request ({len(rows)}), {host} native decode-block host spans; "
          f"metrics tokens={int(m_tok)} decode_steps={int(m_steps)} equal "
          f"Server.stats(); streams identical armed and disarmed; "
          f"tokens_per_s armed {st['tokens_per_sec']:.1f} vs disarmed "
          f"{st0['tokens_per_sec']:.1f} (not gated)")


# -- phase 12: the decode features (weight-only quant, spec, front door) -----

# the weight-only products of one Llama-2-7B decode step: (in, out)
_WO_PRODUCTS = {"4096x4096": (4096, 4096), "4096x11008": (4096, 11008),
                "11008x4096": (11008, 4096), "4096x32000": (4096, 32000)}
# decode at 1 and 8 slots, the prefill chunk (32 rows), the verify step
# at 8 slots x (k + 1) = 40 rows, one full 64-row tile
_WO_ROWS = (1, 8, 32, 40, 64)
# the kernel's precision scheme: x and w split by truncation into bf16
# pieces, six (fp32 x) or three (bf16 x) products on the tensor cores
_WO_SCHEME = "bf16 split, 6 products (fp32 x)"


def _wo_tolerance(torch, x, w):
    """Per element: the kernel and the plain version compute the same
    weights (a product, then a true division) and sum the same K terms
    in other orders; any order lies within K u sum|x w| of the exact sum
    (u = 2^-24), so the two within twice that."""
    k = x.shape[-1]
    return 2 * k * 2.0 ** -24 * torch.nn.functional.linear(x.abs(), w.abs())


def check_weight_only(torch, results):
    """Phase 12 (a): the weight-only kernel against its plain version at
    every product of a 7B decode step, int8 per channel and int4 with
    group 128, at every row count the phase's engines give it and one
    full 64-row tile; the kernel timed at each against its bound (the
    bytes, or the MMA operations of its precision scheme, ``_WO_SCHEME``:
    6 x 2MNK at the bf16 tensor-core rate), the plain version and the
    library call at 8 rows. Fills ``results`` with the kernels line's
    keys (the main row: int8, 4096 -> 4096, 8 rows) and every shape under
    ``shapes``."""
    from paddle_tpu_torch.nn.quant import dequantize_array, quantize_array
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.weight_only import (weight_only_bytes,
                                                  weight_only_matmul)
    g = torch.Generator(device="cuda").manual_seed(12)
    shapes, worst = [], 0.0
    for cfg_name, bits, group in (("int8", 8, -1), ("int4g128", 4, 128)):
        for pname, (k, n) in _WO_PRODUCTS.items():
            w = 0.02 * torch.randn(n, k, generator=g, device="cuda")
            codes, scales = quantize_array(w, bits, group)
            del w
            wd = dequantize_array(codes, scales, bits, in_features=k)
            for m in _WO_ROWS:
                x = torch.randn(m, k, generator=g, device="cuda")
                got = weight_only_matmul(x, codes, scales, bits, k)
                with plain_versions():
                    want = weight_only_matmul(x, codes, scales, bits, k)
                torch.cuda.synchronize()
                err = (got - want).abs()
                tol = _wo_tolerance(torch, x, wd)
                if not bool((err <= tol).all()):
                    raise AssertionError(
                        f"weight_only {cfg_name} {pname} m={m}: error "
                        f"{float(err.max()):.3e} over the summation bound")
                share = float((err / tol.clamp_min(1e-30)).max())
                worst = max(worst, share)
                ms = _time_ms(lambda: weight_only_matmul(x, codes, scales,
                                                         bits, k))
                bound, by = _bound_ms(weight_only_bytes(x.shape, codes,
                                                        scales, x.dtype),
                                      6 * 2.0 * m * n * k, BF16_FLOPS)
                row = dict(config=cfg_name, product=pname, rows=m,
                           ms=round(ms, 5), bound_ms=round(bound, 5),
                           bound_by=by, share_of_bound=round(bound / ms, 3),
                           max_abs_err=float(err.max()), err_share=share)
                if m == 8:
                    with plain_versions():
                        row["plain_ms"] = round(_time_eager(
                            lambda: weight_only_matmul(x, codes, scales,
                                                       bits, k), 5), 5)
                    row["library_ms"] = _wo_library_ms(torch, x, codes,
                                                       scales, bits, k,
                                                       want)
                shapes.append(row)
            del codes, scales, wd
            torch.cuda.empty_cache()
    for r in shapes:
        print(f"weight_only {r['config']:8s} {r['product']:11s} "
              f"m={r['rows']:<3d} ms={r['ms']:.5f} bound={r['bound_ms']:.5f}"
              f" ({r['bound_by']}, {r['share_of_bound']:.2f} of it) "
              f"err={r['max_abs_err']:.2e} ({r['err_share']:.4f} of its "
              f"summation bound)"
              + (f" plain_ms={r['plain_ms']:.5f} library_ms="
                 f"{r['library_ms']}" if "plain_ms" in r else ""))
    print(f"weight_only: every shape within its summation bound (largest "
          f"share {worst:.3f}; bound 2 K 2^-24 sum|x w| per element); time "
          f"bound: bytes at 3.35 TB/s or {_WO_SCHEME} at 989 TFLOP/s")
    main = next(r for r in shapes if r["config"] == "int8"
                and r["product"] == next(iter(_WO_PRODUCTS))
                and r["rows"] == 8)
    results.update(bound_scheme=_WO_SCHEME, ms=main["ms"],
                   plain_ms=main["plain_ms"],
                   bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                   library_ms=main["library_ms"],
                   max_abs_err=max(r["max_abs_err"] for r in shapes),
                   shapes=shapes)


def _wo_int4_library_ms(torch, x, codes, scales, k, want):
    """One PyTorch call computing the int4 product with groups of 128:
    ``torch._weight_int4pack_mm`` (the tinygemm kernel) over bf16
    activations, the codes as unsigned nibbles q = c + 8 packed by
    ``torch._convert_weight_to_int4pack`` (8 inner k-tiles), and bf16
    (scale / 7, zero 0) per group — the same function up to the bf16
    rounding of x and of the scales (its largest error against the plain
    version, relative to the output's largest magnitude, is printed).
    Timed if this build takes it; None otherwise, the refusal printed."""
    from paddle_tpu_torch.nn.quant import _unpack_int4
    try:
        q = _unpack_int4(codes, k).to(torch.int32) + 8
        try:           # torch >= 2.5: (N, K / 2) uint8, even column high
            packed = torch._convert_weight_to_int4pack(
                (q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 8)
        except RuntimeError:
            packed = torch._convert_weight_to_int4pack(q, 8)
        sz = torch.stack([(scales / 7.0).t(), torch.zeros_like(scales).t()],
                         dim=-1).to(torch.bfloat16).contiguous()
        xb = x.to(torch.bfloat16)
        out = torch._weight_int4pack_mm(xb, packed, 128, sz)
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError,
            TypeError) as e:
        print(f"weight_only: torch._weight_int4pack_mm refuses this int4 "
              f"product: {str(e).splitlines()[0][:160]}")
        return None
    rel = float((out.float() - want).abs().max() / want.abs().max())
    ms = _time_ms(lambda: torch._weight_int4pack_mm(xb, packed, 128, sz))
    print(f"weight_only: torch._weight_int4pack_mm {k}x{codes.shape[0]} "
          f"m={x.shape[0]}: {ms:.5f} ms, max error {rel:.2e} of the "
          f"output's largest magnitude (bf16 x and scales)")
    return round(ms, 5)


def _wo_library_ms(torch, x, codes, scales, bits, k=None, want=None):
    """One PyTorch call computing the same product: int8 per channel
    through ``torch._weight_int8pack_mm(x, codes, scale / 127)`` with
    fp32 activations, int4 with group 128 through
    :func:`_wo_int4_library_ms`; timed if this build takes it (None
    otherwise, the refusal printed)."""
    if bits == 4:
        return _wo_int4_library_ms(torch, x, codes, scales, k, want)
    try:
        s = scales / 127.0
        torch._weight_int8pack_mm(x, codes, s)
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        print(f"weight_only: torch._weight_int8pack_mm refuses fp32 "
              f"activations on this build: {str(e).splitlines()[0][:160]}")
        return None
    return round(_time_ms(lambda: torch._weight_int8pack_mm(x, codes, s)),
                 5)


def _features_engine(torch, model, label, **kw):
    """The phase's paged engine shape (phase 3's) with ``kw``; prints
    its build seconds."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(model, num_slots=8, max_len=1024,
                                   decode_block=8, paged=True,
                                   block_size=16, prefill_chunk=32,
                                   device="cuda", **kw)
    torch.cuda.synchronize()
    print(f"phase 12 {label} engine built (programs captured) in "
          f"{time.perf_counter() - t0:.2f} s")
    return eng


def _features_serve(torch, engine, reqs, totals, scheduler=None):
    """Serve (prompt, max_new, sampling kwargs, arrival) requests through
    a fresh Server on the reset engine, launch counts zeroed just before
    and read just after (added to ``totals``). Returns (rows, counts,
    server)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import Scheduler, Server
    engine.reset()
    srv = Server(engine, scheduler or Scheduler(prefill_token_budget=256))
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
            for p, mn, kw, arr in reqs]
    ops.reset_launch_counts()
    res = srv.run_until_idle()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n
    return [res[r] for r in rids], counts, srv


def _repetitive_requests(rng, vocab):
    """Three prompts whose greedy continuations the drafter can predict:
    a 64-token run of one token, a 12-token phrase repeated 8 times, and
    a 16-token phrase repeated 4 times; 64 new tokens each."""
    import numpy as np
    run = [rng.randint(0, vocab)] * 64
    phrase = list(rng.randint(0, vocab, (12,))) * 8
    short = list(rng.randint(0, vocab, (16,))) * 4
    return [(np.asarray(p, np.int32), 64, {}, 0)
            for p in (run, phrase, short)]


def _same_greedy(label, reqs, got, want):
    """``got[i]`` equals ``want[i]`` for every greedy request i in
    ``want`` (a dict); returns the count compared."""
    import numpy as np
    bad = [i for i in want if not np.array_equal(got[i], want[i])]
    if bad:
        raise AssertionError(f"{label}: greedy streams {bad} differ")
    return len(want)


def decode_features_path(torch, card, model, ref):
    """Phase 12 (see the module docstring): (a) the weight-only kernel,
    then on phase 3's model and engine shape (c) the speculative
    engines, (d) the front door with preemption over a plain paged
    engine, and last (b) the quantized engines, whose dequant-twin check
    overwrites the model's linear weights with the dequantized codes (the
    model is freed after the phase). Returns (the kernel's row, the
    launch counts of every served run)."""
    import gc
    import numpy as np
    from paddle_tpu_torch.nn.quant import dequantize_array
    from paddle_tpu_torch.serving import (Frontend, QuantConfig,
                                          SpecConfig, TenantConfig,
                                          WeightOnlyLinear)
    t_phase = time.perf_counter()
    cfg = model.config
    L = cfg.num_hidden_layers
    row = {}
    check_weight_only(torch, row)
    print(f"phase 12 (a) took {time.perf_counter() - t_phase:.1f} s")
    reqs = _prompts(np.random.RandomState(0), cfg.vocab_size)
    greedy = ref["greedy"]                    # phase 3's greedy streams
    rep = _repetitive_requests(np.random.RandomState(12), cfg.vocab_size)
    totals = {}
    plain = _features_engine(torch, model, "plain fp32")
    rep_want, _, _ = _features_serve(torch, plain, rep, totals)

    # (c) speculative decoding, dense and paged, k = 4
    for kind in ("paged", "dense"):
        t0 = time.perf_counter()
        if kind == "paged":
            eng = _features_engine(torch, model, "spec paged",
                                   spec=SpecConfig(k=4))
        else:
            from paddle_tpu_torch.serving import ContinuousBatchingEngine
            eng = ContinuousBatchingEngine(
                model, num_slots=8, max_len=1024, decode_block=8,
                prompt_buckets=(64, 128, 256, 512), spec=SpecConfig(k=4),
                device="cuda")
        got, counts, srv = _features_serve(torch, eng, reqs + rep, totals)
        n = _same_greedy(f"spec {kind}", reqs, got, greedy)
        for i, w in enumerate(rep_want):
            if not np.array_equal(got[len(reqs) + i], w):
                raise AssertionError(f"spec {kind}: repetitive stream {i} "
                                     "differs from the plain engine's")
        prefills = eng.prefill_chunks if kind == "paged" else eng.prefills
        want = {"rms_norm": (2 * L + 1) * (eng.verify_steps + prefills),
                "paged_attention_decode": 0, "weight_only_gemm": 0}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"spec {kind} launches {counts}, expected "
                                 f"{want}")
        if eng.decode_compile_count() != 1 or eng.draft_accepted <= 0:
            raise AssertionError(f"spec {kind}: {eng.decode_compile_count()}"
                                 f" verify captures, {eng.draft_accepted} "
                                 "drafts accepted")
        st = srv.stats()
        prog = eng.backend.decode_program
        emitted = eng.decode_tokens
        print(f"[{card}] phase 12 (c) spec {kind} k=4: {n} greedy streams "
              f"identical to phase 3's and 3 repetitive ones to the plain "
              f"engine's; one verify capture ({prog.capture_s:.3f} s, pool "
              f"{prog.graph_bytes / 2**20:.1f} MiB); acceptance_rate="
              f"{eng.acceptance_rate():.4f} ({eng.draft_accepted}/"
              f"{eng.draft_proposed}), tokens a verify step "
              f"{eng.decode_tokens / eng.verify_steps:.3f} over the 8 "
              f"slots, {emitted / max(emitted - eng.draft_accepted, 1):.3f}"
              f" a live slot, "
              f"verify_step_ms={st['decode_step_ms']:.3f} "
              f"({eng.verify_steps} steps), decode_tokens_per_s="
              f"{st['decode_tokens_per_sec']:.1f} (phase 3's plain "
              f"{ref['stats']['decode_tokens_per_sec']:.1f}); took "
              f"{time.perf_counter() - t0:.1f} s")
        del eng, srv
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the front door over the plain paged engine: tenants a and b
    # (weights 2:1), 10 low-priority streams fill the 8 slots, then a
    # high-priority arrival preempts one
    t0 = time.perf_counter()
    rng = np.random.RandomState(13)
    low = [(rng.randint(0, cfg.vocab_size, (int(rng.randint(64, 257)),))
            .astype(np.int32), 48, {}, 0) for _ in range(10)]
    high = (rng.randint(0, cfg.vocab_size, (96,)).astype(np.int32), 32, {}, 0)
    want, _, _ = _features_serve(torch, plain, low + [high], totals)
    from paddle_tpu_torch import ops
    plain.reset()
    fe = Frontend(plain, tenants={"a": TenantConfig(weight=2.0),
                                  "b": TenantConfig(weight=1.0)},
                  preemption=True)
    delivered = {}
    streams = []
    ops.reset_launch_counts()
    for i, (p, mn, _, _) in enumerate(low):
        got_i = delivered.setdefault(i, [])
        streams.append(fe.submit(p, max_new_tokens=mn, tenant="ab"[i % 2],
                                 on_token=got_i.append))
    for _ in range(3):
        fe.pump()
    got_hi = delivered.setdefault(len(low), [])
    streams.append(fe.submit(high[0], max_new_tokens=high[1], tenant="a",
                             priority=5, on_token=got_hi.append))
    res = fe.run_until_idle()
    torch.cuda.synchronize()
    for name, n in ops.launch_counts().items():
        totals[name] = totals.get(name, 0) + n
    st = fe.stats()
    for i, (s, w) in enumerate(zip(streams, want)):
        p_len = len((low + [high])[i][0])
        if not np.array_equal(res[s.request_id], w):
            raise AssertionError(f"front door: stream {i} differs from the "
                                 "unpreempted run")
        if delivered[i] != [int(t) for t in w[p_len:]] or not s.done:
            raise AssertionError(f"front door: stream {i} delivered "
                                 f"{len(delivered[i])} of {len(w) - p_len}")
    if (st["preemptions"], st["resumes"]) != (1, 1):
        raise AssertionError(f"front door: {st['preemptions']} preemptions, "
                             f"{st['resumes']} resumes (expected 1 and 1)")
    plain.manager.assert_consistent()
    if plain.manager._ref or plain.decode_compile_count() != 1:
        raise AssertionError("front door: blocks leaked or a recapture")
    print(f"[{card}] phase 12 (d) front door (tenants a:b = 2:1, 10 "
          f"low-priority streams, one priority-5 arrival): "
          f"{st['preemptions']} preemption, {st['resumes']} resume, every "
          f"stream identical to the unpreempted run and delivered whole "
          f"({sum(len(v) for v in delivered.values())} tokens); streamed "
          f"per tenant {st['tenant_stream_tokens']}; ttft_p95_s="
          f"{st['ttft_p95_s']:.4f}; took {time.perf_counter() - t0:.1f} s")

    # (b) quantized paged engines, then their dequant twins
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fp32_w = plain.decode_bytes_per_step()["weights"]
    quant_runs = []
    for label, q in (("int8", "int8"),
                     ("int4 g128", QuantConfig("int4", group_size=128))):
        eng = _features_engine(torch, model, f"quant {label}", quant=q)
        got, counts, srv = _features_serve(torch, eng, reqs, totals)
        _check_launches(eng, counts, "paged_attention_decode")
        n_wo = (7 * L + 1) * (eng.steps + eng.prefill_chunks)
        if counts["weight_only_gemm"] != n_wo:
            raise AssertionError(f"quant {label}: weight_only_gemm "
                                 f"{counts['weight_only_gemm']}, expected "
                                 f"{n_wo}")
        _check_graphs(eng, f"phase 12 quant {label} ")
        st = srv.stats()
        wb = eng.decode_bytes_per_step()["weights"]
        print(f"[{card}] phase 12 (b) quant {label}: decode_step_ms="
              f"{st['decode_step_ms']:.3f} (phase 3's fp32 "
              f"{ref['stats']['decode_step_ms']:.3f}; PERF.md at 32 "
              f"layers 23.4-24.1), "
              f"decode_tokens_per_s={st['decode_tokens_per_sec']:.1f}, "
              f"weight bytes a step {wb} ({wb / 1e9:.3f} GB; fp32 "
              f"{fp32_w / 1e9:.3f} GB), weight_error_bound="
              f"{eng.weight_error_bound():.6e}, launches exact "
              f"(weight_only_gemm {n_wo} = {7 * L + 1} x ({eng.steps} steps "
              f"+ {eng.prefill_chunks} chunks))")
        if label == "int8":           # where the int8 step's time goes
            ref["quant_int8_rows"] = got          # phase 15 (e) reads them
            _arm_fp32_check(eng, cfg)
            profile_decode_block(torch, eng, card, arena="int8-weight")
        quant_runs.append((label, eng, got))
    print(f"phase 12 (b) peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB (the fp32 model, both quantized copies and three arenas)")
    with torch.no_grad():
        for label, eng, got in reversed(quant_runs):
            for name, mod in eng.backend.model.named_modules():
                if isinstance(mod, WeightOnlyLinear):
                    model.get_submodule(name).weight.copy_(dequantize_array(
                        mod.codes, mod.scales, mod.bits,
                        in_features=mod.in_features))
            twin, _, _ = _features_serve(torch, plain, reqs, totals)
            k = _same_greedy(f"quant {label} vs its dequant twin", reqs, got,
                             {i: twin[i] for i in greedy})
            print(f"phase 12 (b) quant {label}: {k} greedy streams identical "
                  f"to the fp32 engine over the dequantized weights")
    print(f"phase 12 (b) took {time.perf_counter() - t0:.1f} s")
    del quant_runs, eng, srv, plain, fe
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 (decode features) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return row, totals


# -- phase 13: the disaggregated serving fleet -------------------------------

# two prefill workers of 4 slots and two decode workers of 8, phase 3's
# max_len, block, chunk and decode block; the prefill workers' schedulers
# pace 256 prompt tokens a tick, as phase 3's server does
_FLEET_PF = dict(num_slots=4, max_len=1024, decode_block=8, block_size=16,
                 prefill_chunk=32)
_FLEET_DC = dict(_FLEET_PF, num_slots=8)
_FLEET_BUDGET = 256
# the open-loop trace of (d): 7B's vocabulary, prompts 32-512, outputs
# 16-64, a 256-token shared prefix on half the requests, a quarter sampled
_FLEET_TRACE = dict(seed=0, vocab_size=32000, horizon=48, base_rate=0.5,
                    prompt_lo=32, prompt_hi=512, output_lo=16,
                    output_hi=64, shared_fraction=0.5, shared_len=256,
                    sampled_fraction=0.25)


def _fleet_engines(torch, model, device, kv_int8=False):
    """The fleet's engines over ONE model: two prefill-only paged
    engines (no decode program) and two decode paged engines."""
    from paddle_tpu_torch.serving import PagedEngine, PrefillPagedEngine
    t0 = time.perf_counter()
    pf = [PrefillPagedEngine(model, kv_int8=kv_int8, device=device,
                             **_FLEET_PF) for _ in range(2)]
    dc = [PagedEngine(model, kv_int8=kv_int8, device=device, **_FLEET_DC)
          for _ in range(2)]
    arena = [sum(t.numel() * t.element_size() for t in e.backend.caches())
             for e in pf + dc]
    print(f"phase 13 {'int8' if kv_int8 else 'fp32'} fleet built "
          f"(programs captured) in {time.perf_counter() - t0:.2f} s: "
          f"arenas prefill {arena[0] / 2**30:.2f} GiB x 2 "
          f"({pf[0].num_kv_blocks} blocks), decode {arena[2] / 2**30:.2f}"
          f" GiB x 2 ({dc[0].num_kv_blocks} blocks); "
          f"{_allocated_gib(torch):.2f} GiB allocated")
    return pf, dc


def _allocated_gib(torch):
    return torch.cuda.memory_allocated() / 2**30 \
        if torch.cuda.is_available() else 0.0


def _fleet(pf, dc, **kw):
    from paddle_tpu_torch.serving import (DecodeWorker, Fleet,
                                          PrefillWorker, Scheduler)
    for e in pf + dc:
        e.reset()
    return Fleet([PrefillWorker(e, scheduler=Scheduler(
        prefill_token_budget=_FLEET_BUDGET)) for e in pf],
        [DecodeWorker(e) for e in dc], **kw)


def _fleet_serve(torch, pf, dc, reqs, totals, spec="", kill=None,
                 fetch=None, **kw):
    """Serve phase 3's (prompt, max_new, sampling, arrival) requests
    through a fresh fleet over the reset engines, launch counts zeroed
    just before and read just after (added to ``totals``). ``kill``: the
    decode worker killed once it holds live streams; ``fetch=(a, b)``:
    request b is pinned to the prefill worker request a did not land on
    (a remote prefix fetch). Returns (fleet, rows, launch counts, wall
    s)."""
    import numpy as np
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.utils import faults
    fleet = _fleet(pf, dc, **kw)
    rids = []
    for i, (p, mn, skw, arr) in enumerate(reqs):
        pin = None
        if fetch is not None and i == fetch[1]:
            owner = fleet._requests[rids[fetch[0]]]["worker"]
            pin = next(w.name for w in fleet.prefill if w.name != owner)
        rids.append(fleet.submit(p, max_new_tokens=mn, arrival_step=arr,
                                 prefill_worker=pin, **skw))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with faults.injected(spec, seed=0):
        if kill is not None:
            for _ in range(200):
                if fleet.decode[kill].engine.has_live():
                    break
                fleet.tick()
            else:
                raise AssertionError(f"decode worker {kill} never held a "
                                     "stream")
            fleet.kill_decode_worker(kill)
        res = fleet.run_until_idle(max_ticks=4000)
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    if fleet.busy():
        raise AssertionError("the fleet did not drain")
    rows = [res[r] for r in rids]
    for (p, mn, _, _), row in zip(reqs, rows):
        if not isinstance(row, np.ndarray) or len(row) != len(p) + mn:
            raise AssertionError(f"fleet request: {row!r}")
    return fleet, rows, counts, wall


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _fleet_launches(fleet, counts, kernel, label, base=None):
    """Exact launches: ``kernel`` once per layer and decode step on the
    decode workers, RMSNorm 2L + 1 per prefill chunk (prefill workers)
    and per decode step (decode workers), no other decode kernel; no
    prefill worker decodes and no decode worker prefills. ``base``
    ({id(engine): (steps, chunks)}, from :func:`_engine_marks`) counts
    only the steps and chunks run since (a restored engine carries its
    snapshot's counters)."""
    def since(e, i):
        return (e.steps, e.prefill_chunks)[i] \
            - (base or {}).get(id(e), (0, 0))[i]
    pf = [w.engine for w in fleet.prefill]
    dc = [d.engine for d in fleet.decode]
    if any(since(e, 0) for e in pf) or any(since(e, 1) for e in dc):
        raise AssertionError(f"{label}: a prefill worker decoded or a "
                             "decode worker prefilled")
    L = dc[0].backend.model.config.num_hidden_layers
    steps = sum(since(e, 0) for e in dc)
    chunks = sum(since(e, 1) for e in pf)
    want = {k: 0 for k in ("paged_attention_decode",
                           "paged_attention_decode_int8", "decode_layer",
                           "decode_layer_int8", "rms_norm_bwd")}
    want["rms_norm"] = (2 * L + 1) * (chunks + steps)
    want[kernel] = L * steps
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: launch counts {got}, expected "
                             f"{want}")
    print(f"{label}: launches exact ({kernel} {want[kernel]} = {L} x "
          f"{steps} decode steps, rms_norm {want['rms_norm']} = {2 * L + 1}"
          f" x ({chunks} chunks + {steps} steps))")


def _fleet_graphs(fleet, label):
    """One decode graph per decode worker, one chunk graph per prefill
    worker and no decode graph there; the decode workers' stock chunk
    graph (captured when the engine was built) is never replayed."""
    pf = [(w.engine.decode_compile_count(), w.engine.prefill_compile_count())
          for w in fleet.prefill]
    dc = [(d.engine.decode_compile_count(), d.engine.prefill_compile_count())
          for d in fleet.decode]
    if any(c != (0, 1) for c in pf) or any(c != (1, 1) for c in dc):
        raise AssertionError(f"{label}: captures (decode, chunk) prefill "
                             f"workers {pf}, decode workers {dc}")
    print(f"{label}: captures (decode, chunk) prefill workers {pf}, decode "
          f"workers {dc} (the decode workers' chunk graphs replayed 0 "
          f"times)")


def _fleet_pools(fleet, label):
    for w in fleet.prefill + fleet.decode:
        if fleet._alive(w.name):
            _res_check_pool(w.engine, f"{label} {w.name}")


def _fleet_same(label, got, want):
    import numpy as np
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: request {i} differs")


def _fleet_print(card, label, fleet, wall):
    import numpy as np
    st = fleet.stats()
    dec = sum(d.engine.decode_tokens for d in fleet.decode)
    ttft = [t for d in fleet.decode for t in d.server.ttft.values()]
    ms = st["handoff_ms_mean"]
    print(f"[{card}] {label}: {st['handoffs']} handoffs, wire bytes a "
          f"handoff {st['handoff_wire_bytes_mean']:.0f} (KV "
          f"{st['handoff_kv_bytes_mean']:.0f}); ms a handoff: "
          + ", ".join(f"{p} {v:.3f}" for p, v in ms.items())
          + f" (sum {sum(ms.values()):.3f}); {st['ticks']} ticks, "
          f"{wall:.2f} s, decode_tokens_per_s={dec / wall:.1f}, "
          f"ttft_p50_s={np.percentile(ttft, 50):.4f} ttft_p95_s="
          f"{np.percentile(ttft, 95):.4f}, prefix_hit_rate="
          f"{st['prefix_hit_rate']:.4f}, prefix_fetches="
          f"{st['prefix_fetches']}")


def _first_tokens(engines, results, shipped, ids, arrivals, first, clock):
    """Record the tick at which each submitted request's first token
    exists: a live run holding tokens, a shipped handoff, a result."""
    live = {run.request.request_id for e in engines
            for _, run in e.live_runs() if run.tokens}
    for tid, rid in ids.items():
        if tid not in first and (rid in live or rid in results
                                 or rid in shipped):
            first[tid] = clock - arrivals[tid]


def _open_loop(torch, card, label, trace, submit, tick, busy, engines,
               results, shipped, totals):
    """Replay ``trace`` open loop (``loadgen.replay``); returns (ids,
    TTFT ticks by trace id, wall s, launch counts)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import replay
    arrivals = {r.request_id: r.arrival_step for r in trace.requests}
    first, ids = {}, {}

    def sub(req):
        rid = submit(req)
        ids[req.request_id] = rid
        return rid

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = replay(trace, sub, tick, busy, max_ticks=4000,
                 on_tick=lambda c: _first_tokens(
                     engines, results(), shipped(), ids, arrivals, first, c))
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    if got != ids or busy():
        raise AssertionError(f"{label}: the replay did not drain")
    missing = [t for t, r in ids.items() if r not in results()]
    if missing:
        raise AssertionError(f"{label}: requests {missing} ended in neither "
                             "a result nor a failure")
    return ids, first, wall, counts


def fleet_path(torch, card, ref, device="cuda"):
    """Phase 13 (see the module docstring). Returns the launch counts of
    every served run."""
    import gc
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import (PagedEngine, RequestFailure,
                                          Scheduler, Server,
                                          SocketTransport, TraceConfig,
                                          generate_trace)
    t_phase = time.perf_counter()
    cfg = _serving_config()
    # phase 12's dequant twins overwrote the model's linears: phase 3's
    # model is rebuilt from its seed
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    print(f"phase 13 model rebuilt from seed 0 in "
          f"{time.perf_counter() - t_phase:.2f} s; "
          f"{_allocated_gib(torch):.2f} GiB allocated")
    reqs = _prompts(np.random.RandomState(0), cfg.vocab_size)
    totals = {}

    # (a) the fp32 fleet
    pf, dc = _fleet_engines(torch, model, device)
    fleet, rows, counts, wall = _fleet_serve(torch, pf, dc, reqs, totals)
    _fleet_same("phase 13 (a) fp32 fleet vs phase 3's engine", rows,
                ref["rows"])
    _fleet_launches(fleet, counts, "paged_attention_decode",
                    "phase 13 (a)")
    _fleet_graphs(fleet, "phase 13 (a)")
    _fleet_pools(fleet, "phase 13 (a)")
    if fleet.handoffs != len(reqs):
        raise AssertionError(f"phase 13 (a): {fleet.handoffs} handoffs for "
                             f"{len(reqs)} requests")
    fp32_kv = fleet.stats()["handoff_kv_bytes_mean"]
    print(f"phase 13 (a): {len(reqs)} streams (11 greedy, 1 sampled) "
          f"identical to phase 3's unified engine, one handoff a request")
    _fleet_print(card, "phase 13 (a) fp32 fleet", fleet, wall)

    # (c) failures on (a)'s fleet
    t0 = time.perf_counter()
    fleet, got, counts, wall = _fleet_serve(torch, pf, dc, reqs, totals,
                                            kill=1)
    _fleet_same("phase 13 (c) decode worker killed", got, rows)
    _fleet_launches(fleet, counts, "paged_attention_decode",
                    "phase 13 (c) kill")
    _fleet_pools(fleet, "phase 13 (c) kill")
    st = fleet.stats()
    if st["workers_lost"] != 1 or st["redrives"] < 1:
        raise AssertionError(f"phase 13 (c): {st['workers_lost']} workers "
                             f"lost, {st['redrives']} redrives")
    print(f"[{card}] phase 13 (c) decode1 killed mid-decode: "
          f"{st['redrives']} streams redriven, all {len(reqs)} identical to "
          f"(a)'s; redrive latency p50 {st['redrive_latency_p50_s']} s p95 "
          f"{st['redrive_latency_p95_s']} s; {wall:.2f} s")
    t = SocketTransport("fleet", retry_backoff_s=0.001)
    try:
        fleet, got, counts, wall = _fleet_serve(
            torch, pf, dc, reqs, totals, spec="transport.corrupt:at=1",
            transport=t)
        ts = t.stats()
    finally:
        t.close()
    _fleet_same("phase 13 (c) socket transport, one frame corrupted",
                got, rows)
    _fleet_launches(fleet, counts, "paged_attention_decode",
                    "phase 13 (c) socket")
    if ts["crc_drops"] < 1 or ts["resends"] < 1:
        raise AssertionError(f"phase 13 (c) socket: {ts}")
    _fleet_print(card, "phase 13 (c) socket transport", fleet, wall)
    print(f"phase 13 (c) socket transport: {ts}")
    fleet, got, counts, wall = _fleet_serve(torch, pf, dc, reqs, totals,
                                            affinity=False, fetch=(1, 9))
    _fleet_same("phase 13 (c) affinity off", got, rows)
    _fleet_launches(fleet, counts, "paged_attention_decode",
                    "phase 13 (c) affinity off")
    _fleet_pools(fleet, "phase 13 (c) affinity off")
    st = fleet.stats()
    if st["prefix_fetches"] < 1:
        raise AssertionError("phase 13 (c) affinity off: no prefix fetch")
    print(f"[{card}] phase 13 (c) affinity off: {st['prefix_fetches']} "
          f"prefix fetches ({st['prefix_fetch_blocks']} blocks, "
          f"{st['prefix_fetch_kv_bytes_mean']:.0f} KV bytes a fetch), "
          f"streams identical; took {time.perf_counter() - t0:.1f} s")

    # (d) open-loop arrivals: one Server over phase 3's engine shape, then
    # (a)'s fleet, on the same trace
    t0 = time.perf_counter()
    trace = generate_trace(TraceConfig(**_FLEET_TRACE))
    print(f"phase 13 (d) trace: {json.dumps(trace.stats())}")

    def submit_kw(r):
        return dict(max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature, top_k=r.top_k, seed=r.seed,
                    tenant=r.tenant, priority=r.priority)

    eng = PagedEngine(model, device=device, **dict(_FLEET_DC))
    srv = Server(eng, Scheduler(prefill_token_budget=_FLEET_BUDGET))
    s_ids, s_first, s_wall, counts = _open_loop(
        torch, card, "phase 13 (d) server", trace,
        lambda r: srv.submit(r.prompt, **submit_kw(r)),
        lambda: srv.run_until_idle(max_ticks=1),
        lambda: bool(srv.scheduler.pending() or eng.has_live()), [eng],
        lambda: srv.results, lambda: (), totals)
    _check_launches(eng, counts, "paged_attention_decode")
    s_rows = {t: srv.results[r] for t, r in s_ids.items()}
    out = {"server": (s_first, s_wall, eng.decode_tokens,
                      list(srv.ttft.values()),
                      eng.prefix_cache_hit_rate())}
    del srv, eng
    gc.collect()
    fleet = _fleet(pf, dc)
    f_ids, f_first, f_wall, counts = _open_loop(
        torch, card, "phase 13 (d) fleet", trace,
        lambda r: fleet.submit(r.prompt, **submit_kw(r)), fleet.tick,
        fleet.busy, pf + dc, lambda: fleet.results,
        lambda: fleet._progress, totals)
    _fleet_launches(fleet, counts, "paged_attention_decode",
                    "phase 13 (d) fleet")
    _fleet_pools(fleet, "phase 13 (d) fleet")
    f_rows = {t: fleet.results[r] for t, r in f_ids.items()}
    failed = [t for t, v in f_rows.items() if isinstance(v, RequestFailure)]
    same = sum(1 for t in s_rows if not isinstance(s_rows[t], RequestFailure)
               and np.array_equal(s_rows[t], f_rows[t]))
    if failed or same != len(s_rows):
        raise AssertionError(f"phase 13 (d): {same}/{len(s_rows)} streams "
                             f"equal the server's, failures {failed}")
    ttft = [t for d in fleet.decode for t in d.server.ttft.values()] \
        + [t for w in fleet.prefill for t in w.server.ttft.values()]
    out["fleet"] = (f_first, f_wall,
                    sum(d.engine.decode_tokens for d in fleet.decode), ttft,
                    fleet.prefix_hit_rate())
    for name, (first, wall, dtok, ttft_s, hit) in out.items():
        ticks = list(first.values())
        print(f"[{card}] phase 13 (d) open loop, {name}: {len(trace)} "
              f"requests over {trace.config.horizon} ticks, every one "
              f"completed; ttft_ticks p50 {np.percentile(ticks, 50):.1f} "
              f"p95 {np.percentile(ticks, 95):.1f}; ttft_s p50 "
              f"{np.percentile(ttft_s, 50):.4f} p95 "
              f"{np.percentile(ttft_s, 95):.4f}; decode_tokens_per_s="
              f"{dtok / wall:.1f} ({dtok} decode tokens in {wall:.2f} s); "
              f"prefix_hit_rate={hit:.4f}")
    print(f"phase 13 (d): all {same} streams of the fleet identical to the "
          f"server's; took {time.perf_counter() - t0:.1f} s")
    del fleet, pf, dc
    gc.collect()
    _empty_cache(torch)

    # (b) the int8 fleet against a unified int8 server
    t0 = time.perf_counter()
    eng = PagedEngine(model, kv_int8=True, device=device, **_FLEET_DC)
    srv = Server(eng, Scheduler(prefill_token_budget=_FLEET_BUDGET))
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
            for p, mn, kw, arr in reqs]
    res = srv.run_until_idle()
    want = [res[r] for r in rids]
    del srv, eng
    gc.collect()
    _empty_cache(torch)
    pf, dc = _fleet_engines(torch, model, device, kv_int8=True)
    fleet, got, counts, wall = _fleet_serve(torch, pf, dc, reqs, totals)
    _fleet_same("phase 13 (b) int8 fleet vs a unified int8 server", got,
                want)
    _fleet_launches(fleet, counts, "paged_attention_decode_int8",
                    "phase 13 (b)")
    _fleet_graphs(fleet, "phase 13 (b)")
    _fleet_pools(fleet, "phase 13 (b)")
    if fleet.handoffs != len(reqs):
        raise AssertionError(f"phase 13 (b): {fleet.handoffs} handoffs")
    int8_kv = fleet.stats()["handoff_kv_bytes_mean"]
    _fleet_print(card, "phase 13 (b) int8 fleet", fleet, wall)
    print(f"[{card}] phase 13 (b): {len(reqs)} streams identical to a "
          f"unified int8 server; payload KV bytes fp32/int8 "
          f"{fp32_kv / int8_kv:.3f} (4d/(d+4) = "
          f"{4 * cfg.head_dim / (cfg.head_dim + 4):.3f} at head_dim "
          f"{cfg.head_dim}); took {time.perf_counter() - t0:.1f} s")
    del fleet, pf, dc, model
    gc.collect()
    _empty_cache(torch)
    print(f"phase 13 (fleet serving) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


# -- phase 14: the fleet's durable control plane and its SLO autoscaler -----

# two prefill engines of 2 slots and two decode engines of 4, max_len 512:
# 1 GiB and 2 GiB of fp32 arena at 7B's width. The prefill workers'
# schedulers pace 64 prompt tokens a tick, so a checkpoint finds streams
# in every state
_DUR_PF = dict(num_slots=2, max_len=512, decode_block=8, block_size=16,
               prefill_chunk=32)
_DUR_DC = dict(_DUR_PF, num_slots=4)
_DUR_BUDGET = 64
# the kill-and-burst trace of (d): 7B's vocabulary, prompts 32-256,
# outputs 16-48, one burst at 5x the base rate, a quarter sampled
_DUR_TRACE = dict(seed=0, vocab_size=32000, horizon=20, base_rate=0.25,
                  bursts=1, burst_mult=5.0, burst_len=(6, 9), prompt_lo=32,
                  prompt_hi=256, output_lo=16, output_hi=48,
                  sampled_fraction=0.25)
# queue-driven: a TTFT in seconds on the card is not one on the CPU
_DUR_SCALER = dict(min_decode=1, max_decode=3, queue_high=1,
                   interval_ticks=2, ttft_slo_s=1e9, breach_intervals=2,
                   clear_intervals=3, up_cooldown=2, down_cooldown=2)


def _dur_engine(model, device, role, kv_int8=False):
    from paddle_tpu_torch.serving import PagedEngine, PrefillPagedEngine
    if role == "prefill":
        return PrefillPagedEngine(model, kv_int8=kv_int8, device=device,
                                  **_DUR_PF)
    return PagedEngine(model, kv_int8=kv_int8, device=device, **_DUR_DC)


def _dur_engines(torch, model, device, label, kv_int8=False, n_dc=2):
    t0 = time.perf_counter()
    pf = [_dur_engine(model, device, "prefill", kv_int8) for _ in range(2)]
    dc = [_dur_engine(model, device, "decode", kv_int8)
          for _ in range(n_dc)]
    arena = [sum(t.numel() * t.element_size() for t in e.backend.caches())
             for e in (pf[0], dc[0])]
    print(f"{label}: engines built (programs captured) in "
          f"{time.perf_counter() - t0:.2f} s: arenas prefill "
          f"{arena[0] / 2**30:.2f} GiB x 2, decode {arena[1] / 2**30:.2f} "
          f"GiB x {n_dc}; {_allocated_gib(torch):.2f} GiB allocated")
    return pf, dc


def _dur_fleet(pf, dc, **kw):
    from paddle_tpu_torch.serving import (DecodeWorker, Fleet,
                                          PrefillWorker, Scheduler)
    for e in pf + dc:
        e.reset()
    return Fleet([PrefillWorker(e, scheduler=Scheduler(
        prefill_token_budget=_DUR_BUDGET)) for e in pf],
        [DecodeWorker(e) for e in dc], **kw)


def _dur_submit(fleet, reqs):
    return [fleet.submit(p, max_new_tokens=mn, **kw)
            for p, mn, kw, _ in reqs]


def _dur_run(torch, fleet, totals):
    """Run the fleet until idle with the launch counters zeroed just
    before and read just after (added to ``totals``); returns (launch
    counts, wall s)."""
    from paddle_tpu_torch import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fleet.run_until_idle(max_ticks=4000)
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    if fleet.busy():
        raise AssertionError("the fleet did not drain")
    return counts, wall


def _dur_rows(fleet, rids, reqs, label):
    import numpy as np
    res = fleet.results
    rows = [res.get(r) for r in rids]
    for (p, mn, _, _), row in zip(reqs, rows):
        if not isinstance(row, np.ndarray) or len(row) != len(p) + mn:
            raise AssertionError(f"{label}: request ended in {row!r}")
    return rows


def _engine_marks(fleet):
    """{id(engine): (steps, chunks)} of every worker's engine now."""
    return {id(w.engine): (w.engine.steps, w.engine.prefill_chunks)
            for w in fleet.prefill + fleet.decode}


def _dir_bytes(d):
    import os
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def _free_engines(torch, *holders):
    for h in holders:
        h.clear()
    gc.collect()
    _empty_cache(torch)


def _dur_recovery_arm(torch, card, model, device, reqs, want, kv_int8,
                      totals, dirs):
    """(a) / (b): a clean run, then a durable run checkpointed mid-
    traffic, fed more, killed two ticks later (its engines freed), and
    recovered onto engines built anew; the recovered rows must equal the
    clean run's (and ``want``, when given)."""
    import tempfile
    import warnings
    from paddle_tpu_torch.serving import Fleet
    from paddle_tpu_torch.utils import faults
    import shutil
    label = "phase 14 (b) int8" if kv_int8 else "phase 14 (a) fp32"
    kernel = "paged_attention_decode_int8" if kv_int8 \
        else "paged_attention_decode"
    pf, dc = _dur_engines(torch, model, device, label, kv_int8)
    fleet = _dur_fleet(pf, dc)
    rids = _dur_submit(fleet, reqs)
    counts, wall = _dur_run(torch, fleet, totals)
    clean = _dur_rows(fleet, rids, reqs, f"{label} clean")
    _fleet_launches(fleet, counts, kernel, f"{label} clean run")
    _fleet_pools(fleet, f"{label} clean run")
    if want is not None:
        _fleet_same(f"{label} clean run vs phase 3's engine", clean, want)
    print(f"[{card}] {label} clean run: {len(reqs)} streams in "
          f"{wall:.2f} s, {fleet.stats()['ticks']} ticks")

    # the durable run: requests 0-3, a checkpoint once a stream decodes
    # while another is still being prefilled, requests 4-7, two ticks,
    # then the whole fleet dies
    d = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    dirs.append(d)
    fleet = _dur_fleet(pf, dc, durability=d)
    ids = _dur_submit(fleet, reqs[:4])
    for _ in range(200):
        fleet.tick()
        decoding = any(w.engine.has_live() for w in fleet.decode)
        behind = [r for r in ids if r not in fleet._handoffs
                  and not fleet._terminal(r)]
        if decoding and behind:
            break
    else:
        raise AssertionError(f"{label}: no tick had one stream decoding "
                             "and another not yet shipped")
    j = fleet._journal
    appends, append_s, jbytes = j.appends, j.append_s, j.bytes_written
    _sync(torch)
    t0 = time.perf_counter()
    fleet.checkpoint()
    ck_s = time.perf_counter() - t0
    ck = fleet.last_checkpoint
    peak = _dir_bytes(d)
    print(f"[{card}] {label} checkpoint at tick {fleet._clock} "
          f"({len(ids) - len(behind)} streams shipped, {len(behind)} "
          f"queued or prefilling): {ck['bytes']} bytes in {ck_s:.3f} s "
          f"({ck['bytes'] / ck_s / 1e9:.3f} GB/s; snapshots "
          f"{ck['snapshot_s']:.3f} s, manifest commit "
          f"{ck['commit_s'] * 1e3:.3f} ms)")
    ids += _dur_submit(fleet, reqs[4:])
    torn = "journal.torn_tail:at=1" if kv_int8 else ""
    with faults.injected(torn):
        for _ in range(2):
            fleet.tick()
    j = fleet._journal
    appends, append_s = appends + j.appends, append_s + j.append_s
    jbytes += j.bytes_written
    print(f"[{card}] {label} journal: {appends} appends, {jbytes} bytes, "
          f"{append_s / max(appends, 1) * 1e3:.4f} ms an append (fsync "
          "each)" + (" ; journal.torn_tail armed once after the "
                     "checkpoint" if torn else ""))
    del fleet, j
    _free_engines(torch, pf, dc)

    # recovery onto new engines (each captures its programs anew)
    built = []

    def factory(role, name):
        e = _dur_engine(model, device, role, kv_int8)
        built.append(e)
        return e
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        fleet = Fleet.recover(d, engine_factory=factory)
        _sync(torch)
        rec_s = time.perf_counter() - t0
    lr = fleet.last_recovery
    torn_warned = any("torn" in str(w.message) for w in warned)
    if kv_int8 and not (torn_warned and lr["torn_tail"]):
        raise AssertionError(f"{label}: the torn tail was not reported "
                             f"({lr})")
    if lr["redriven"] < 1:
        raise AssertionError(f"{label}: nothing redriven ({lr})")
    for w in fleet.prefill:
        w.server.scheduler.prefill_token_budget = _DUR_BUDGET
    sec = lr["seconds"]
    print(f"[{card}] {label} recover: {rec_s:.3f} s (manifest "
          f"{sec['manifest'] * 1e3:.3f} ms, journal replay "
          f"{sec['replay'] * 1e3:.3f} ms, engine builds {sec['build']:.3f} "
          f"s, worker restore {sec['restore']:.3f} s, registries "
          f"{sec['registries'] * 1e3:.3f} ms, redrive "
          f"{sec['redrive'] * 1e3:.3f} ms); {lr['replayed']} records "
          f"replayed, {lr['redriven']} streams redriven, torn tail "
          f"{lr['torn_tail']}, {lr['workers']} workers")
    base = _engine_marks(fleet)
    counts, wall = _dur_run(torch, fleet, totals)
    rows = _dur_rows(fleet, ids, reqs, f"{label} recovered")
    _fleet_same(f"{label} recovered vs clean run", rows, clean)
    for r in ids:
        n = sum(1 for w in fleet.prefill + fleet.decode
                if r in w.server.results) + (r in fleet._local_results) \
            + (r in fleet._failures)
        if n != 1:
            raise AssertionError(f"{label}: request {r} has {n} terminals")
    _fleet_launches(fleet, counts, kernel, f"{label} recovered", base)
    _fleet_graphs(fleet, f"{label} recovered")
    _fleet_pools(fleet, f"{label} recovered")
    print(f"[{card}] {label}: all {len(reqs)} recovered rows (greedy and "
          f"the sampled one) identical to the clean run"
          + (" and to phase 3's engine" if want is not None else "")
          + f"; one terminal each; recovered fleet ran {wall:.2f} s, "
          f"{fleet.stats()['ticks']} ticks")
    del fleet
    _free_engines(torch, built)
    shutil.rmtree(d, ignore_errors=True)
    return peak, clean


def _dur_spill_arm(torch, card, model, device, reqs, rows, totals, dirs):
    """(c): watermark eviction with the disk spill tier on; request 1's
    prompt resubmitted after its chain left every arena is served from
    disk."""
    import shutil
    import tempfile
    import numpy as np
    pf, dc = _dur_engines(torch, model, device, "phase 14 (c) spill")
    d = tempfile.mkdtemp(prefix="chip_smoke_spill_")
    dirs.append(d)
    fleet = _dur_fleet(pf, dc, durability=d, affinity=False,
                       evict_high=0.05, evict_low=0.02,
                       spill_max_bytes=4 << 30)
    rids = _dur_submit(fleet, reqs)
    _dur_run(torch, fleet, totals)
    got = _dur_rows(fleet, rids, reqs, "phase 14 (c)")
    _fleet_same("phase 14 (c) spill fleet vs (a)'s clean run", got, rows)
    fleet.tick()                     # an idle tick evicts the rest
    spill = fleet._spill
    p1 = reqs[1][0]
    head = _sha1_head(pf[0], p1)
    if any(head in w.engine.manager._index
           for w in fleet.prefill + fleet.decode):
        raise AssertionError("phase 14 (c): request 1's chain is still in "
                             "an arena")
    fetch = fleet._spill_fetch
    took = []

    def timed(*a):
        t0 = time.perf_counter()
        out = fetch(*a)
        _sync(torch)
        if out is not None:
            took.append(time.perf_counter() - t0)
        return out
    fleet._spill_fetch = timed
    hits0 = spill.hits
    p, mn, kw, _ = reqs[1]
    rid = fleet.submit(p, max_new_tokens=mn, **kw)
    base = _engine_marks(fleet)
    counts, _ = _dur_run(torch, fleet, totals)
    again = fleet.results[rid]
    if not np.array_equal(again, rows[1]):
        raise AssertionError("phase 14 (c): the resubmitted stream differs "
                             "from its first run")
    st = spill.stats()
    if st["writes"] < 1 or spill.hits - hits0 < 1 or not took:
        raise AssertionError(f"phase 14 (c): spill {st}")
    _fleet_launches(fleet, counts, "paged_attention_decode",
                    "phase 14 (c) resubmission", base)
    _fleet_pools(fleet, "phase 14 (c)")
    print(f"[{card}] phase 14 (c) spill tier: {st['writes']} chains "
          f"spilled ({st['bytes']} bytes on disk, "
          f"{spill.write_s / st['writes'] * 1e3:.2f} ms a spill write "
          f"with its device-to-host copy excluded), {fleet.prefix_evictions}"
          f" blocks evicted; request 1 resubmitted: a spill hit of "
          f"{fleet.prefix_fetch_blocks} blocks, read + adopt "
          f"{took[0] * 1e3:.2f} ms (read {spill.read_s * 1e3:.2f} ms), "
          f"stream identical to its first run")
    peak = _dir_bytes(d)
    del fleet, spill, fetch
    _free_engines(torch, pf, dc)
    shutil.rmtree(d, ignore_errors=True)
    return peak


def _sha1_head(engine, prompt):
    """The digest a manager indexes ``prompt``'s first block under."""
    bs = engine.kv_block_size
    return engine.manager.hash_fn(b"", tuple(int(t) for t in prompt[:bs]))


def _dur_autoscale_arm(torch, trace, pool, totals, autoscale):
    """(d): replay the trace through a fleet of pre-built engines; the
    autoscaled arm starts from one decode worker, scales through a
    factory handing out the rest of ``pool`` and has one decode worker
    killed inside the burst; the static arm runs three decode workers.
    Returns (fleet, scaler, rows, ttft s by trace id, decode
    worker-ticks, kill/death ticks)."""
    import numpy as np
    from types import SimpleNamespace
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import (Autoscaler, AutoscalerConfig,
                                          RequestFailure, replay)
    pf, dcs = pool
    n0 = 1 if autoscale else 3
    fleet = _dur_fleet(pf, dcs[:n0], lease_misses=2, spill_depth=100)
    spares = list(dcs[n0:])

    def factory():
        if not spares:
            raise AssertionError("phase 14 (d): the engine pool ran out")
        e = spares.pop(0)
        e.reset()
        return e
    scaler = Autoscaler(fleet, factory,
                        config=AutoscalerConfig(**_DUR_SCALER)) \
        if autoscale else None
    b0, b1 = trace.burst_windows[0]
    kill_at = (b0 + b1) // 2
    state = {"clock": 0, "killed": None, "dead": None, "worker_ticks": 0}
    ids, t_sub, first = {}, {}, {}

    def submit(r):
        t_sub[r.request_id] = time.perf_counter()
        rid = fleet.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                           temperature=r.temperature, top_k=r.top_k,
                           seed=r.seed, tenant=r.tenant,
                           priority=r.priority)
        ids[r.request_id] = rid
        return rid

    def on_tick(clock):
        state["clock"] = clock
        now = time.perf_counter()
        live = {run.request.request_id for w in fleet.prefill + fleet.decode
                for _, run in w.engine.live_runs() if run.tokens}
        res = fleet.results
        for tid, rid in ids.items():
            if tid not in first and (rid in live or rid in res
                                     or rid in fleet._progress):
                first[tid] = now - t_sub[tid]
        state["worker_ticks"] += sum(1 for d in fleet.decode
                                     if fleet._alive(d.name)
                                     and not d.killed)
        if autoscale and state["killed"] is None and clock >= kill_at:
            live_dc = [i for i, d in enumerate(fleet.decode)
                       if not d.killed]
            if len(live_dc) > 1:
                fleet.kill_decode_worker(live_dc[-1])
                state["killed"] = clock
        if state["killed"] is not None and state["dead"] is None \
                and fleet.workers_lost:
            state["dead"] = clock
        if scaler is not None:
            scaler.on_tick(clock)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    replay(trace, submit, fleet.tick, fleet.busy, max_ticks=2000,
           on_tick=on_tick)
    while state["clock"] < trace.config.horizon + 40:
        fleet.tick()
        on_tick(state["clock"] + 1)
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n
    label = f"phase 14 (d) {'autoscaled' if autoscale else 'static peak'}"
    used = [e for e in dcs if e not in spares]
    workers = SimpleNamespace(
        prefill=[SimpleNamespace(engine=e) for e in pf],
        decode=[SimpleNamespace(engine=e) for e in used])
    _fleet_launches(workers, counts, "paged_attention_decode", label)
    res = fleet.results
    rows, failed = {}, {}
    for tid, rid in ids.items():
        v = res.get(rid)
        if v is None:
            raise AssertionError(f"{label}: request {tid} ended in neither "
                                 "a result nor a failure")
        if isinstance(v, RequestFailure):
            failed[tid] = v.reason
        else:
            rows[tid] = np.asarray(v)
    for w in fleet.prefill + fleet.decode:
        if fleet._alive(w.name):
            _res_check_pool(w.engine, f"{label} {w.name}")
    _fleet_graphs(workers, label)
    return dict(fleet=fleet, scaler=scaler, rows=rows, failed=failed,
                first=first, wall=wall, state=state, used=len(used))


def durable_path(torch, card, ref, device="cuda"):
    """Phase 14 (see the module docstring). Returns the launch counts of
    every served run."""
    import shutil
    import numpy as np
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import TraceConfig, generate_trace
    t_phase = time.perf_counter()
    cfg = _serving_config()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    print(f"phase 14 model rebuilt from seed 0 in "
          f"{time.perf_counter() - t_phase:.2f} s; "
          f"{_allocated_gib(torch):.2f} GiB allocated")
    reqs = _prompts(np.random.RandomState(0), cfg.vocab_size)[:8]
    totals, dirs, peaks = {}, [], []
    try:
        t0 = time.perf_counter()
        peak, rows = _dur_recovery_arm(torch, card, model, device, reqs,
                                       ref["rows"][:8], False, totals, dirs)
        peaks.append(peak)
        print(f"phase 14 (a) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        peak, _ = _dur_recovery_arm(torch, card, model, device, reqs, None,
                                    True, totals, dirs)
        peaks.append(peak)
        print(f"phase 14 (b) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        peaks.append(_dur_spill_arm(torch, card, model, device, reqs, rows,
                                    totals, dirs))
        print(f"phase 14 (c) took {time.perf_counter() - t0:.1f} s")

        # (d) the autoscaler: every engine built before the trace starts
        t0 = time.perf_counter()
        trace = generate_trace(TraceConfig(**_DUR_TRACE))
        print(f"phase 14 (d) trace: {json.dumps(trace.stats())}")
        pf, dcs = _dur_engines(torch, model, device, "phase 14 (d)",
                               n_dc=4)
        arms = {}
        for name, auto in (("static peak", False), ("autoscaled", True)):
            arms[name] = _dur_autoscale_arm(torch, trace, (pf, dcs), totals,
                                            auto)
        a, s = arms["autoscaled"], arms["static peak"]
        sc, st = a["scaler"], a["state"]
        both = set(a["rows"]) & set(s["rows"])
        diff = [t for t in both
                if not np.array_equal(a["rows"][t], s["rows"][t])]
        if diff or s["failed"]:
            raise AssertionError(f"phase 14 (d): streams {diff} differ, "
                                 f"static failures {s['failed']}")
        every = _DUR_SCALER["interval_ticks"]
        ups_after = [(i + 1) * every for i, d in enumerate(sc.decisions)
                     if st["dead"] is not None
                     and (i + 1) * every >= st["dead"]
                     and d.action == "up" and d.acted]
        live_end = len(a["fleet"]._live_decode())
        # min_decode=1 keeps one survivor above the floor, so the repair
        # is the queue's next scale-up, as soon as the up-cooldown lets
        # it act
        soon = (_DUR_SCALER["up_cooldown"] + 1) * every
        if not (sc.scale_ups >= 1 and st["killed"] is not None
                and st["killed"] <= trace.burst_windows[0][1]
                and ups_after and ups_after[0] - st["dead"] <= soon
                and live_end == 1
                and sc.scale_downs >= 1 and sc.removals >= 1):
            raise AssertionError(
                f"phase 14 (d): scaler {sc.stats()}, kill at "
                f"{st['killed']} (detected {st['dead']}), live at the end "
                f"{live_end}")
        p50 = float(np.percentile(list(s["first"].values()), 50))
        timeline = [(2 * (i + 1), d.action, d.reason)
                    for i, d in enumerate(sc.decisions)
                    if d.action != "hold"]
        print(f"phase 14 (d): burst ticks {trace.burst_windows[0]}, decode "
              f"worker killed at tick {st['killed']} (dead at "
              f"{st['dead']}, repaired by the scale-up at tick "
              f"{ups_after[0]}); decisions (tick, action, reason): "
              f"{timeline}; {sc.stats()}")
        for name, arm in arms.items():
            ttft = list(arm["first"].values())
            share = sum(1 for t in ttft if t < 2 * p50) / len(ttft)
            fl = arm["fleet"]
            peak_size = arm["scaler"].peak_size if arm["scaler"] else 3
            print(f"[{card}] phase 14 (d) {name}: {len(arm['rows'])} of "
                  f"{len(trace)} requests completed, {len(arm['failed'])} "
                  f"failed explicitly {sorted(set(arm['failed'].values()))};"
                  f" decode workers peak {peak_size}, end "
                  f"{len(fl._live_decode())}; decode worker-ticks "
                  f"{arm['state']['worker_ticks']}; TTFT p50 "
                  f"{np.percentile(ttft, 50):.4f} s p95 "
                  f"{np.percentile(ttft, 95):.4f} s; share under 2x the "
                  f"static arm's p50 ({2 * p50:.4f} s) {share:.4f}; "
                  f"{arm['wall']:.2f} s, {fl.stats()['ticks']} ticks, "
                  f"{arm['used']} decode engines used")
        print(f"phase 14 (d): {len(both)} streams completed in both arms, "
              f"all identical; one decode graph per engine; took "
              f"{time.perf_counter() - t0:.1f} s")
        del arms, a, s, sc, pf, dcs
    finally:
        print(f"phase 14: the largest durability directory held "
              f"{max(peaks or [0])} bytes at its peak")
        for d in dirs:      # each arm removes its own; this on a failure
            shutil.rmtree(d, ignore_errors=True)
    del model
    gc.collect()
    _empty_cache(torch)
    print(f"phase 14 (durable control plane, autoscaler) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return totals


# -- phase 15: tensor-parallel serving ----------------------------------------

_TP_PAGED = dict(num_slots=8, max_len=1024, decode_block=8, paged=True,
                 block_size=16, prefill_chunk=32)
_TP_DENSE = dict(num_slots=8, max_len=1024, decode_block=8,
                 prompt_buckets=(64, 128, 256, 512))


def _tp_engine(torch, model, device, label, **kw):
    """An engine over phase 3's model (phase 3's paged geometry unless
    ``kw`` overrides it); prints its build seconds (programs captured)."""
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    geo = dict(_TP_DENSE if kw.pop("dense", False) else _TP_PAGED)
    geo.update(kw)
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(model, device=device, **geo)
    _sync(torch)
    print(f"phase 15 {label} engine built in "
          f"{time.perf_counter() - t0:.2f} s; {_allocated_gib(torch):.2f} "
          f"GiB allocated")
    return eng


def _tp_launches(engine, counts, kernel, label):
    """Exact launches of a served run at degree d: every shard runs its
    own RMSNorms (2L + 1 a step, a chunk or a dense prefill) and its own
    paged decode at kvh / d heads (L a step); RoPE never runs its kernel
    on the slot pools (per-row positions rotate in torch ops); with
    weight-only quant every shard's 7L + 1 products launch the kernel."""
    L = engine.backend.model.config.num_hidden_layers
    d = engine.tp_degree()
    per = engine.steps + (engine.prefill_chunks
                          if hasattr(engine, "prefill_chunks")
                          else engine.prefills)
    want = {k: 0 for k in ("paged_attention_decode",
                           "paged_attention_decode_int8", "decode_layer",
                           "decode_layer_int8", "rope", "rms_norm_bwd")}
    want["rms_norm"] = d * (2 * L + 1) * per
    if kernel is not None:
        want[kernel] = d * L * engine.steps
    want["weight_only_gemm"] = d * (7 * L + 1) * per \
        if engine.backend.quant_cfg is not None else 0
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{label} launch counts {got}, expected {want}")
    return want


def _tp_serve(torch, engine, reqs, totals, label, kernel, budget=256):
    """Serve ``reqs`` through a fresh Server on the reset engine with the
    launch counts zeroed just before and read just after (added to
    ``totals``); checks outputs, block accounting and exact launches.
    Returns (rows, stats, wall s)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.serving import Scheduler, Server
    engine.reset()
    srv = Server(engine, Scheduler(prefill_token_budget=budget))
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
            for p, mn, kw, arr in reqs]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = srv.run_until_idle()
    _sync(torch)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n
    rows = [res[r] for r in rids]
    for r, (p, mn, _, _) in zip(rows, reqs):
        if len(r) != len(p) + mn:
            raise AssertionError(f"{label}: bad output length")
    manager = getattr(engine, "manager", None)
    if manager is not None:
        manager.assert_consistent()
        if manager._ref:
            raise AssertionError(f"{label}: blocks leaked {manager._ref}")
    _tp_launches(engine, counts, kernel, label)
    st = srv.stats()
    if st.get("tp_degree") != engine.tp_degree():
        raise AssertionError(f"{label}: stats tp_degree "
                             f"{st.get('tp_degree')}")
    return rows, st, wall


def _tp_same(label, got, want, which):
    import numpy as np
    bad = [i for i in which if not np.array_equal(got[i], want[i])]
    if bad:
        raise AssertionError(f"{label}: streams {bad} differ")
    return len(which)


def _tp_graphs(engine, label):
    counts = (engine.decode_compile_count(), engine.prefill_compile_count())
    if counts[0] != 1 or (hasattr(engine, "prefill_chunks")
                          and counts[1] != 1):
        raise AssertionError(f"{label}: captures (decode, prefill) "
                             f"{counts}")


def _tp_step_delta(torch, model, engine):
    """One decode step on the engine's armed slots: the sharded model's
    log-probs against the unsharded model's over the same K/V (each
    leaf's shards gathered into one global arena). Returns max |delta|
    and the argmax agreement."""
    from paddle_tpu_torch.models import decode_step_logprobs
    s = engine._state
    b = engine.backend
    table = torch.where(s["live"][:, None], s["table"], 0)
    glob = [tuple(leaf.detach() for leaf in layer) for layer in b.cache]
    one = decode_step_logprobs(model, s["tok"][:, None], glob, s["pos"],
                               block_table=table)
    del glob
    sharded = decode_step_logprobs(b.model, s["tok"][:, None], b.cache,
                                   s["pos"], block_table=table)
    live = s["live"]
    delta = float((sharded - one)[live].abs().max())
    agree = int((sharded.argmax(-1) == one.argmax(-1))[live].sum())
    if not torch.isfinite(sharded).all():
        raise AssertionError("tp=2 step log-probs are not finite")
    return delta, agree, int(live.sum())


def tp_path(torch, card, ref, device="cuda"):
    """Phase 15 (see the module docstring). Returns the launch counts of
    every served run."""
    import shutil
    import tempfile
    import numpy as np
    from paddle_tpu_torch.distributed.mesh import build_device_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving import (PagedEngine, Server, adopt_prefix,
                                          extract_prefix)
    from paddle_tpu_torch.serving.tp import TPConfig
    t_phase = time.perf_counter()
    _tp_free(torch)                 # phase 14's model and engines
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    cfg = _serving_config()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    print(f"phase 15 model rebuilt from seed 0 in "
          f"{time.perf_counter() - t_phase:.2f} s; "
          f"{_allocated_gib(torch):.2f} GiB allocated")
    mesh = build_device_mesh({"mp": 2}, devices=[device, device])
    exact = TPConfig(mesh=mesh)
    reqs = _prompts(np.random.RandomState(0), cfg.vocab_size)
    every = list(range(len(reqs)))
    greedy = sorted(ref["greedy"])
    totals = {}

    # (a) the paged exact tp=2 engine against phase 3
    t0 = time.perf_counter()
    a = _tp_engine(torch, model, device, "(a) paged exact tp=2", tp=exact)
    rows, st, wall = _tp_serve(torch, a, reqs, totals, "phase 15 (a)",
                               "paged_attention_decode")
    n = _tp_same("phase 15 (a) vs phase 3", rows, ref["rows"], every)
    _tp_graphs(a, "phase 15 (a)")
    shard_kv = a.backend.shard_kv_bytes()
    kv3 = ref["stats"]["kv_bytes_per_slot"] * a.num_slots
    if any(2 * b != kv3 for b in shard_kv):
        raise AssertionError(f"phase 15 (a): shard arenas {shard_kv} B, "
                             f"phase 3's arena {kv3} B")
    acc = a.backend.collective_accounting()
    print(f"[{card}] phase 15 (a) paged exact tp=2: {n} streams (11 greedy,"
          f" 1 sampled) identical to phase 3's; captures (1, 1); launches "
          f"exact; each shard's arena {shard_kv[0]} B (phase 3's {kv3} B); "
          f"decode_step_ms={st['decode_step_ms']:.3f} (phase 3's "
          f"{ref['stats']['decode_step_ms']:.3f} in this run), "
          f"decode_tokens_per_s={st['decode_tokens_per_sec']:.1f} (phase "
          f"3's {ref['stats']['decode_tokens_per_sec']:.1f}); collectives "
          f"{acc['calls_per_dispatch']} a dispatch, "
          f"{acc['bytes_per_token']} B a token; served in {wall:.2f} s")
    _arm_fp32_check(a, cfg)
    _check_step_logprobs(torch, a.backend.model, a, "phase 15 (a) tp=2 ")
    delta, agree, live = _tp_step_delta(torch, model, a)
    if not delta <= 2e-3:
        raise AssertionError(f"phase 15 (a): one step, tp=2 vs the "
                             f"unsharded model, differs by {delta:.3e} "
                             "(tolerance 2e-3)")
    print(f"[{card}] phase 15 (a) one step, {live} slots: tp=2 vs the "
          f"unsharded model on the same K/V: max |delta log-prob| "
          f"{delta:.3e} (tolerance 2e-3, as kernels vs plain: the shards' "
          f"narrower products sum in another order), argmax agree "
          f"{agree}/{live}")
    if device == "cuda":
        idle = profile_decode_block(torch, a, card, arena="tp=2 fp32")
        print(f"[{card}] phase 15 (a) replayed block idle "
              f"{100 * idle:.1f}% (phase 3's {100 * ref['idle']:.1f}%)")
    print(f"phase 15 (a) took {time.perf_counter() - t0:.1f} s")

    # (f) snapshot of (a) mid-stream onto a fresh tp=2 engine; a prefix
    # fetch from the tp=2 owner into a tp=1 requester
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pt-tp-")
    try:
        # requests 0-7 need 104 blocks: a 160-block arena keeps the
        # snapshot at 2.7 GB (phase 3's whole arena is 8.6 GB)
        small = dict(tp=exact, num_blocks=160)
        killed = _tp_engine(torch, model, device, "(f) 160-block tp=2",
                            **small)
        killed.reset()
        srv = Server(killed, _scheduler())
        rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
                for p, mn, kw, arr in reqs[:8]]
        srv.run_until_idle(max_ticks=3)
        path = os.path.join(tmp, "tp.npz")
        srv.snapshot(path)
        del killed, srv
        _tp_free(torch)
        fresh = _tp_engine(torch, model, device, "(f) fresh 160-block tp=2",
                           **small)
        res = Server.restore(path, fresh).run_until_idle()
        _tp_same("phase 15 (f) restored", [res[r] for r in rids],
                 ref["rows"], range(8))
        snap_b = os.path.getsize(path)
        del fresh, res
        _tp_free(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    i = 1                                  # shares the 256-token prefix
    prompt, mn = reqs[i][0], reqs[i][1]
    _tp_serve(torch, a, [reqs[i]], totals, "phase 15 (f) owner",
              "paged_attention_decode")
    nb = (len(prompt) - 1) // a.kv_block_size
    h = extract_prefix(a, prompt, nb)
    if h is None or h.meta["src_tp_degree"] != 2 or "kv_0_p1" not in h.arrays:
        raise AssertionError("phase 15 (f): no per-shard fetch payload")
    req = PagedEngine(model, num_slots=2, max_len=1024, decode_block=8,
                      block_size=16, prefill_chunk=32, device=device)
    req.reset()
    fetched = adopt_prefix(req, h, [], prompt)
    req.manager.release(fetched)
    srv = Server(req)
    rid = srv.submit(prompt, max_new_tokens=mn)
    out = srv.run_until_idle()[rid]
    if not np.array_equal(out, ref["rows"][i]) \
            or req.shared_tokens != nb * req.kv_block_size:
        raise AssertionError("phase 15 (f): the fetched prefix's stream "
                             "differs or was not reused")
    print(f"[{card}] phase 15 (f) snapshot of a 160-block tp=2 engine "
          f"mid-stream ({snap_b} B, the global arena) restored onto a fresh "
          f"one: 8 streams "
          f"identical; a {nb}-block prefix fetched from the tp=2 owner "
          f"({len([k for k in h.arrays if k.startswith('kv_')])} per-shard "
          f"chunks) adopted by a tp=1 engine: stream identical; took "
          f"{time.perf_counter() - t0:.1f} s")
    del req, srv, h
    _tp_free(torch)

    # (d) psum: one request's step against the exact engine's; int8 hop
    t0 = time.perf_counter()
    prompt = reqs[3][0]
    psum = _tp_engine(torch, model, device, "(d) psum tp=2",
                      tp=TPConfig(mode="psum", mesh=mesh))
    _tp_arm_one(a, prompt)
    _tp_arm_one(psum, prompt)
    logp = {"exact": _tp_live_logprobs(torch, a),
            "psum": _tp_live_logprobs(torch, psum)}
    if int(a._state["tok"][0]) != int(psum._state["tok"][0]):
        raise AssertionError("phase 15 (d): psum and exact prefills sampled "
                             "different first tokens")
    dl = float((logp["psum"] - logp["exact"]).abs().max())
    if not math.isfinite(dl):
        raise AssertionError("phase 15 (d): psum log-probs not finite")
    print(f"[{card}] phase 15 (d) psum tp=2 vs exact tp=2, one request's "
          f"first decode step after its prefill: max |delta log-prob| "
          f"{dl:.3e}")
    del psum
    a.reset()
    del a
    _tp_free(torch)
    p8 = _tp_engine(torch, model, device, "(d) psum int8 tp=2",
                    tp=TPConfig(mode="psum", int8=True, mesh=mesh))
    _tp_arm_one(p8, prompt)
    bound = p8.tp_int8_error_bound()
    err, hop_bound = _tp_hop_error(p8)
    if not (0 < err <= hop_bound <= bound):
        raise AssertionError(f"phase 15 (d): hop |int8 - fp32| {err}, its "
                             f"bound {hop_bound}, the step's {bound}")
    import dataclasses
    backend = p8.backend
    backend.tp = dataclasses.replace(backend.tp, int8_max_error=bound / 2)
    backend._int8_gate_pending = True
    refused = 0
    for _ in range(2):
        try:
            p8.step_block()
        except RuntimeError as e:
            if "error bound" not in str(e):
                raise
            refused += 1
    if refused != 2 or not backend._int8_gate_pending:
        raise AssertionError(f"phase 15 (d): the gate refused {refused} of "
                             "2 blocks over budget")
    print(f"[{card}] phase 15 (d) psum int8 tp=2: runtime bound "
          f"{bound:.4e} (tp_int8_error_bound), the first hop's measured "
          f"|int8 - fp32| hidden state {err:.4e} within its bound "
          f"{hop_bound:.4e}; a budget of bound / 2 refused twice, the gate "
          f"still armed; took {time.perf_counter() - t0:.1f} s")
    del p8, backend
    _tp_free(torch)

    # (b) the int8 arena against an unsharded int8 engine
    t0 = time.perf_counter()
    u8 = _tp_engine(torch, model, device, "(b) unsharded int8", kv_int8=True)
    want8 = _tp_rows(u8, reqs)
    _arm_fp32_check(u8, cfg)      # the baseline of (b)'s one-step checks
    _check_step_logprobs(torch, model, u8, "phase 15 (b) unsharded int8 ")
    del u8
    _tp_free(torch)
    # the control: no tensor parallelism, other prefill product shapes
    c8 = _tp_engine(torch, model, device, "(b) unsharded int8, chunk 64",
                    kv_int8=True, prefill_chunk=64)
    same_c, diverge_c = _tp_agreement(reqs, _tp_rows(c8, reqs), want8)
    del c8
    _tp_free(torch)
    t8 = _tp_engine(torch, model, device, "(b) int8 tp=2", kv_int8=True,
                    tp=exact)
    got8, st8, _ = _tp_serve(torch, t8, reqs, totals, "phase 15 (b)",
                             "paged_attention_decode_int8")
    _tp_graphs(t8, "phase 15 (b)")
    same, diverge = _tp_agreement(reqs, got8, want8)
    _arm_fp32_check(t8, cfg)
    _check_step_logprobs(torch, t8.backend.model, t8, "phase 15 (b) tp=2 ")
    delta, agree, live = _tp_step_delta(torch, model, t8)
    if not delta <= 2e-3:
        raise AssertionError(f"phase 15 (b): one step on the same int8 "
                             f"arena differs by {delta:.3e} (tolerance "
                             "2e-3)")
    print(f"[{card}] phase 15 (b) int8 arena tp=2: launches and captures "
          f"exact; one step on the same int8 arena (the shards' codes and "
          f"scales gathered) against the unsharded model: max |delta "
          f"log-prob| {delta:.3e} (tolerance 2e-3, phase 3's kernels vs "
          f"plain), argmax agree {agree}/{live}; streams against the "
          f"unsharded int8 engine (reported: an int8 code flips where the "
          f"K/V differ by an ulp): {len(same)}/{len(reqs)} identical, "
          f"first divergence at generated token {diverge}; an unsharded "
          f"int8 engine prefilling in chunks of 64 against the same "
          f"streams: {len(same_c)}/{len(reqs)} identical, first divergence "
          f"at {diverge_c}; decode_step_ms={st8['decode_step_ms']:.3f}; took "
          f"{time.perf_counter() - t0:.1f} s")
    del t8
    _tp_free(torch)
    _tp_int8_cause(torch, model, exact, reqs[8][0], card, device)

    # (c) the dense exact tp=2 engine on requests 0-7
    t0 = time.perf_counter()
    dense = _tp_engine(torch, model, device, "(c) dense exact tp=2",
                       dense=True, tp=exact)
    got, std, _ = _tp_serve(torch, dense, reqs[:8], totals, "phase 15 (c)",
                            None)
    n = _tp_same("phase 15 (c) dense tp=2 vs phase 3", got, ref["rows"],
                 [i for i in greedy if i < 8])
    print(f"[{card}] phase 15 (c) dense exact tp=2: {n} greedy streams "
          f"identical to phase 3's; decode captured once, "
          f"{dense.prefill_compile_count()} bucket prefills; "
          f"decode_step_ms={std['decode_step_ms']:.3f}; took "
          f"{time.perf_counter() - t0:.1f} s")
    del dense
    _tp_free(torch)

    # (e) weight-only int8 with exact tp=2 against phase 12 (b)
    t0 = time.perf_counter()
    q = _tp_engine(torch, model, device, "(e) quant int8 tp=2",
                   quant="int8", tp=exact)
    got, stq, _ = _tp_serve(torch, q, reqs, totals, "phase 15 (e)",
                            "paged_attention_decode")
    _tp_graphs(q, "phase 15 (e)")
    n = _tp_same("phase 15 (e) quant int8 tp=2 vs phase 12 (b)", got,
                 ref["quant_int8_rows"], greedy)
    _arm_fp32_check(q, cfg)
    _check_step_logprobs(torch, q.backend.model, q, "phase 15 (e) tp=2 ")
    print(f"[{card}] phase 15 (e) quant int8 exact tp=2: {n} greedy "
          f"streams identical to phase 12 (b)'s int8 engine; weight_only_gemm"
          f" launches exact at the shard shapes; decode_step_ms="
          f"{stq['decode_step_ms']:.3f}; took "
          f"{time.perf_counter() - t0:.1f} s")
    del q, model
    gc.collect()
    _empty_cache(torch)
    peak = torch.cuda.max_memory_allocated() / 1e9 \
        if torch.cuda.is_available() else 0.0
    print(f"phase 15 (tensor-parallel serving) took "
          f"{time.perf_counter() - t_phase:.1f} s, peak memory "
          f"{peak:.2f} GB")
    return totals


def _scheduler():
    from paddle_tpu_torch.serving import Scheduler
    return Scheduler(prefill_token_budget=256)


def _tp_free(torch):
    """Free the engines just dropped (they form reference cycles)."""
    gc.collect()
    _empty_cache(torch)


def _tp_rows(engine, reqs):
    """The rows of ``reqs`` served on the reset engine (no checks)."""
    from paddle_tpu_torch.serving import Server
    engine.reset()
    srv = Server(engine, _scheduler())
    rids = [srv.submit(p, max_new_tokens=mn, arrival_step=arr, **kw)
            for p, mn, kw, arr in reqs]
    res = srv.run_until_idle()
    return [res[r] for r in rids]


def _tp_agreement(reqs, got, want):
    """(indices of identical streams, {index: first differing generated
    token} of the others)."""
    import numpy as np
    same, diverge = [], {}
    for i, (g, w) in enumerate(zip(got, want)):
        if np.array_equal(g, w):
            same.append(i)
        else:
            p = len(reqs[i][0])
            diverge[i] = int(np.flatnonzero(g[p:] != w[p:])[0])
    return same, diverge


def _tp_prompt_rows(torch, engine, n):
    """Per layer, the global arena leaves' rows of slot 0's first ``n``
    positions: (k, v) fp32, or (k codes, v codes, k scales, v scales)."""
    bs = engine.kv_block_size
    idx = engine._state["table"][0, :-(-n // bs)].long()
    return [[leaf.index_select(0, idx).flatten(0, 1)[:n] for leaf in layer]
            for layer in engine.backend.cache]


def _tp_int8_cause(torch, model, exact, prompt, card, device):
    """Why the int8-arena streams of (b) fork while the fp32 ones do not:
    one prompt prefilled on four 80-block engines, fp32 and int8 arenas,
    unsharded and tp=2, and their arenas' rows of the prompt compared.
    Gates: at layer 0 (whose K/V no arena read precedes) each int8
    engine's codes and scales are ``quantize_kv`` of its fp32 twin's K/V
    bit for bit, so the two int8 arenas differ only where the two fp32
    K/V differ; those differ by less than half a quantization step
    (absmax / 127), so a code moves by one at most, and only where the
    boundary between two codes lies between the two fp32 values. The
    fp32 differences are given in ulps of each row's absmax and in
    steps. A control with no tensor parallelism: an unsharded int8
    engine prefilling in chunks of 64 against the one in chunks of 32
    (other product shapes, so other roundings); the moved codes of both
    pairs are printed by layer."""
    from paddle_tpu_torch.ops.paged_attention import quantize_kv
    t0 = time.perf_counter()
    n = len(prompt)
    rows = {}
    for name, kw in (("u32", {}), ("t32", dict(tp=exact)),
                     ("u8", dict(kv_int8=True)),
                     ("t8", dict(kv_int8=True, tp=exact)),
                     ("c8", dict(kv_int8=True, prefill_chunk=64))):
        e = _tp_engine(torch, model, device, f"(b) cause {name}",
                       num_blocks=80, **kw)
        _tp_arm_one(e, prompt)
        rows[name] = _tp_prompt_rows(torch, e, n)
        del e
        _tp_free(torch)
    fp_steps, fp_ulps, flips, dcode = [], [], [], []
    by_layer = {"tp=2": [], "chunk 64": []}
    for l, (u, t, c, ct, cc) in enumerate(zip(
            rows["u32"], rows["t32"], rows["u8"], rows["t8"], rows["c8"])):
        by_layer["tp=2"].append(int((c[0] != ct[0]).sum()
                                    + (c[1] != ct[1]).sum()))
        by_layer["chunk 64"].append(int((c[0] != cc[0]).sum()
                                        + (c[1] != cc[1]).sum()))
        for j in range(2):                       # k, v
            delta = (t[j] - u[j]).abs()
            top = u[j].abs().amax(-1, keepdim=True)       # the row's absmax
            ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
            fp_steps.append(float((delta / (top / 127)).max()))
            fp_ulps.append(float((delta / ulp).max()))
            flips.append(int((c[j] != ct[j]).sum()))
            dcode.append(int((c[j].int() - ct[j].int()).abs().max()))
            if l:
                continue
            for fp, q in ((u, c), (t, ct)):
                codes, scales = quantize_kv(fp[j])
                if not (torch.equal(codes, q[j])
                        and torch.equal(scales, q[2 + j])):
                    raise AssertionError(
                        "phase 15 (b) cause: an int8 arena's layer-0 rows "
                        "are not quantize_kv of its fp32 twin's")
    total = rows["u8"][0][0].numel()
    if not (fp_steps[0] < 0.5 and fp_steps[1] < 0.5
            and max(dcode[:2]) <= 1):
        raise AssertionError(f"phase 15 (b) cause: layer 0 fp32 K/V differ "
                             f"by {fp_steps[:2]} steps, codes by "
                             f"{dcode[:2]}")
    print(f"[{card}] phase 15 (b) cause, one {n}-token prompt prefilled on "
          f"fp32 and int8 arenas, tp=1 and tp=2: layer 0's int8 rows are "
          f"quantize_kv of the fp32 twin's K/V bit for bit; the fp32 K/V "
          f"(tp=2 vs tp=1) differ at layer 0 by at most {fp_ulps[0]:.1f} / "
          f"{fp_ulps[1]:.1f} ulp of the row's absmax (k / v), "
          f"{fp_steps[0]:.2e} / "
          f"{fp_steps[1]:.2e} of a step, over all {len(rows['u32'])} "
          f"layers by "
          f"{max(fp_ulps):.1f} ulp, {max(fp_steps):.2e} of a step; int8 "
          f"codes moved at layer 0: {flips[0]} / {flips[1]} of {total} "
          f"each, by at most {max(dcode[:2])}; "
          f"over all layers {sum(flips)} moved codes of "
          f"{2 * len(rows['u32']) * total}, "
          f"by at most {max(dcode)}; took {time.perf_counter() - t0:.1f} s")
    for name, moved in by_layer.items():
        print(f"[{card}] phase 15 (b) cause: unsharded chunk-32 int8 arena "
              f"vs {name}: moved codes by layer (of {2 * total} each) "
              f"{moved}")


def _tp_arm_one(engine, prompt):
    """Reset the engine and arm one greedy request through its prefill
    (its first token sampled, its first decode step next)."""
    from paddle_tpu_torch.serving import Request
    engine.reset()
    engine.try_admit(Request(request_id=3000, prompt=prompt,
                             max_new_tokens=32))
    engine.prefill_tick(None)


def _tp_live_logprobs(torch, engine):
    """One decode step's log-probs on the engine's live slots."""
    from paddle_tpu_torch.models import decode_step_logprobs
    s, b = engine._state, engine.backend
    table = torch.where(s["live"][:, None], s["table"], 0)
    out = decode_step_logprobs(b.model, s["tok"][:, None], b.cache,
                               s["pos"], block_table=table)
    return out[s["live"]]


def _tp_hop_error(engine):
    """The first int8 hop of one probed step: its |int8 - fp32| all-reduce
    against the fp32 one on the same partial sums, and its bound."""
    from paddle_tpu_torch.distributed.collectives.hierarchical import (
        hier_all_reduce)
    from paddle_tpu_torch.distributed.collectives.quantized import (
        quantized_all_reduce)
    from paddle_tpu_torch.utils import tp_hooks
    seen = []
    orig = tp_hooks.maybe_reduce

    def spy(ts):
        if not seen:
            seen.append([t.clone() for t in ts])
        return orig(ts)
    tp_hooks.maybe_reduce = spy
    try:
        engine.tp_int8_error_bound()
    finally:
        tp_hooks.maybe_reduce = orig
    plan = engine.backend.tp_plan
    fp32 = hier_all_reduce(seen[0], plan)[0]
    q, bound = quantized_all_reduce(seen[0], plan, return_error_bound=True)
    return float((q[0] - fp32).abs().max()), float(bound)


def _empty_cache(torch):
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# -- phase 16: the process-group runtime and data-parallel training ---------

_REPO = os.path.dirname(os.path.abspath(__file__))
_DP_WORKER = os.path.join(_REPO, "tools", "port_dp_worker.py")
_DP_TIMEOUT_S = 420


def _dp_per_step(L, n_tensors):
    """Launches of one eager headline step (phase 9's per step: the full
    recompute repeats the layer's forward kernels)."""
    from paddle_tpu_torch import ops
    per = {k: 0 for k in ops.launch_counts()}
    per.update({"rms_norm": 4 * L + 1, "rms_norm_bwd": 2 * L + 1,
                "rope": 3 * L, "flash_attention_fwd": 2 * L,
                "flash_attention_bwd_dq": L, "flash_attention_bwd_dkv": L,
                "adamw": n_tensors})
    return per


_PYCACHE = os.path.join(_REPO, "paddle_tpu_torch", "_build", "pycache")


def _cache_bytecode():
    """This process writes the bytecode of what it imports from now on
    under the build directory, where the launched jobs read it
    (``_job_env``). Where the environment sets PYTHONDONTWRITEBYTECODE
    and the installed packages hold no bytecode, every fresh interpreter
    compiles torch's modules and the port's again, seconds a process."""
    if not os.path.isdir(os.path.join(_REPO, "paddle_tpu_torch")):
        return                   # the script alone: nothing to launch
    os.makedirs(_PYCACHE, exist_ok=True)
    sys.pycache_prefix = _PYCACHE
    sys.dont_write_bytecode = False


def _job_env():
    """The launched jobs' environment: their bytecode cached where
    ``_cache_bytecode`` puts this process's."""
    os.makedirs(_PYCACHE, exist_ok=True)
    env = dict(os.environ, PYTHONPYCACHEPREFIX=_PYCACHE)
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    return env


def _start_job(tmp, tag, nproc, worker_args, max_restarts=0,
               worker=_DP_WORKER):
    """``python -m paddle_tpu_torch.distributed.launch`` of ``worker``
    (the DP worker) in ``tmp/tag``: (process, out dir, log dir)."""
    out, log = os.path.join(tmp, tag), os.path.join(tmp, tag, "log")
    os.makedirs(log, exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--log_dir", log,
           "--max_restarts", str(max_restarts), worker, "--out", out,
           *worker_args]
    proc = subprocess.Popen(cmd, cwd=_REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=_job_env(), start_new_session=True)
    return proc, out, log


def _stop_job(job):
    """Kill a ``_start_job`` job that still runs, its workers with it
    (the launcher leads a process group of its own)."""
    proc = job[0]
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()


def _finish_job(tag, job, nproc, phase=16, records=None):
    """Wait for a ``_start_job`` job; its ranks' records (``records``:
    the file names, default ``rank<r>.json``). A failed job prints the
    launcher's output and each worker log's tail and raises."""
    proc, out, log = job
    try:
        text, _ = proc.communicate(timeout=_DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop_job(job)
        text, _ = proc.communicate()
    recs = [os.path.join(out, name) for name in
            (records or [f"rank{r}.json" for r in range(nproc)])]
    if proc.returncode != 0 or not all(map(os.path.exists, recs)):
        print(f"phase {phase} {tag}: launcher exit {proc.returncode}\n"
              f"{text}")
        for name in sorted(os.listdir(log)):
            with open(os.path.join(log, name)) as f:
                print(f"--- {tag} {name} (tail) ---\n"
                      + "".join(f.readlines()[-40:]))
        raise AssertionError(f"phase {phase} {tag}: the job failed (exit "
                             f"{proc.returncode})")
    out_recs = []
    for path in recs:
        with open(path) as f:
            out_recs.append(json.load(f))
    return out_recs, text


_DP_STEPS = 3      # phase 16 (a)'s steps


def _dp_args(tmp):
    """Phase 16 (a)'s job: ``tools/port_dp_worker.py``'s arguments (it
    runs first in phase 17's job, in the same processes)."""
    return ["--out", os.path.join(tmp, "dp"), "--config", "headline",
            "--batch", "4", "--seq", "2048", "--steps", str(_DP_STEPS),
            "--reference", "--store-checks"]


def _dp_training(card, tmp):
    """Phase 16 (a) and (c): 2 ranks of the headline model on the card,
    from the records of the job's data-parallel part. Returns
    (launches, rank 0's digests after each step: phase 17's data-parallel
    reference)."""
    L = 16
    recs = []
    for r in range(2):
        with open(os.path.join(tmp, "dp", f"rank{r}.json")) as f:
            recs.append(json.load(f))
    runs = [r["runs"]["bucketed"] for r in recs]
    per_step = _dp_per_step(L, runs[0]["param_tensors"])
    totals = {k: 0 for k in per_step}
    for r, run in zip(recs, runs):
        counts = {k: run["launches"].get(k, 0) for k in per_step}
        want = {k: _DP_STEPS * v for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"phase 16 rank {r['rank']} launches "
                                 f"{counts}, expected {want}")
        for k in totals:
            totals[k] += counts[k]
    if runs[0]["digests"] != runs[1]["digests"] or any(
            x["backend"] != "gloo" or x["device"] != recs[0]["device"]
            or not x["store_native"] for x in recs):
        raise AssertionError(f"phase 16 (a): ranks differ or took another "
                             f"route: {[x['backend'] for x in recs]}")
    ref = runs[0]["reference"]
    params_b = runs[0]["params"] / 1e9
    print(f"[{card}] phase 16 (a) data-parallel headline ({params_b:.4f}B "
          f"params bf16, {L} layers, full recompute): 2 ranks "
          f"on {recs[0]['device']} over gloo, batch 4 x 2048 a rank (global "
          f"8), {_DP_STEPS} eager "
          f"steps, rank 0's own {recs[0]['seconds']:.1f} s (the job then "
          f"runs phase 17 (a))")
    print(f"phase 16 (a) params bit-identical across ranks after every "
          f"step (SHA-256 over the store): "
          f"{[d[:12] for d in runs[0]['digests']]}; losses rank 0 "
          f"{runs[0]['losses']}, rank 1 {runs[1]['losses']}")
    print(f"phase 16 (a) step 1's synced gradient: the halves' mean bit "
          f"for bit ({len(ref['halves_mean_unequal'])} tensors differ); vs "
          f"the one-rank global batch relative error max "
          f"{ref['grad_rel_max']:.4e} ({ref['grad_rel_worst']}), median "
          f"{ref['grad_rel_median']:.4e} (tol {ref['grad_tol']}); global "
          f"loss {ref['global_loss']:.6f}")
    for r, run in zip(recs, runs):
        for i, st in enumerate(run["step_s"], 1):
            gbs = st["bytes"] / st["sync"] / 1e9
            print(f"[{card}] phase 16 (a) rank {r['rank']} step {i}: "
                  f"fwd+bwd {1e3 * st['fwd_bwd']:.1f} ms, sync "
                  f"{1e3 * st['sync']:.1f} ms (d2h {1e3 * st['d2h_s']:.1f},"
                  f" transport {1e3 * st['transport_s']:.1f}, h2d "
                  f"{1e3 * st['h2d_s']:.1f}; {st['bytes'] / 1e9:.3f} GB "
                  f"each way, {gbs:.2f} GB/s), adamw "
                  f"{1e3 * st['adamw']:.1f} ms")
        peak = run.get("peak_mem_gb")
        peak = "not measured" if peak is None else f"{peak:.3f} GB"
        print(f"[{card}] phase 16 (a) rank {r['rank']}: peak memory "
              f"{peak}; routes {run['routes']}; "
              f"launches over {_DP_STEPS} steps {run['launches']}")
    for r in recs:
        st = r["store"]
        print(f"[{card}] phase 16 (c) rank {r['rank']}: native store "
              f"{st['store_native']}; 64 MiB p2p round trip "
              f"{st['p2p_round_trip_s']:.3f} s, equal {st['p2p_equal']}, "
              f"bulk warnings {st['bulk_warnings']}; subset group "
              f"{st.get('subset_ok', 'not a member')}; elastic alive "
              f"{st['elastic_alive']}; routes {r['routes']}")
    return totals, runs[0]["digests"]


def _dp_elastic_start(tmp):
    """Phase 16 (b)'s two pods, started: the headline width at 2 layers,
    3 steps, rank 1 failing after step 2 under ``max_restarts=1``, and
    the same job uninterrupted beside it."""
    common = ["--config", "headline", "--layers", "2", "--batch", "4",
              "--seq", "2048", "--steps", "3", "--ckpt-step", "2"]
    return time.perf_counter(), {
        "elastic": _start_job(tmp, "elastic", 2, common + [
            "--ckpt-dir", os.path.join(tmp, "ckpt_e"), "--fail-rank", "1",
            "--fail-step", "2"], max_restarts=1),
        "uninterrupted": _start_job(tmp, "uninterrupted", 2, common + [
            "--ckpt-dir", os.path.join(tmp, "ckpt_u")])}


def _dp_elastic_finish(torch, card, started):
    """Phase 16 (b): wait for the pods; the relaunched job must end where
    the uninterrupted one does."""
    t0, jobs = started
    got = {k: _finish_job(k, j, 2) for k, j in jobs.items()}
    wall = time.perf_counter() - t0
    (el, text), (un, _) = got["elastic"], got["uninterrupted"]
    ok = all(r["restart"] == 1 and r["runs"]["bucketed"]["resumed_from"]
             == 2 for r in el) \
        and all(r["restart"] == 0 for r in un) \
        and {r["runs"]["bucketed"]["digests"][-1] for r in el + un} \
        == {un[0]["runs"]["bucketed"]["digests"][-1]}
    note = text.strip().splitlines()[-1] if text.strip() else ""
    print(f"[{card}] phase 16 (b) elastic relaunch (headline width, 2 "
          f"layers, 3 steps): rank 1 exited after step 2, the pod "
          f"relaunched ({note}) and resumed from each rank's step-2 "
          f"checkpoint; final params "
          f"{el[0]['runs']['bucketed']['digests'][-1][:12]} vs "
          f"uninterrupted {un[0]['runs']['bucketed']['digests'][-1][:12]}: "
          f"{'bit-identical' if ok else 'DIFFERENT'} (both pods "
          f"{wall:.1f} s, beside phase 17 (b)'s one-rank load and (d): a "
          f"wall, not a measurement)")
    if not ok:
        raise AssertionError("phase 16 (b): the relaunched job does not "
                             "end where the uninterrupted one does")


def _nccl_one_rank(torch, card):
    """Phase 16 (d): a one-rank nccl group on cuda:0, all_reduce,
    broadcast and all_gather of a 256 MiB fp32 bucket, each checked
    against its input and timed."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import communication as C
    from paddle_tpu_torch.distributed.launch_utils import free_ports
    contract = {"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "1",
                "PADDLE_LOCAL_RANK": "0", "PADDLE_LOCAL_SIZE": "1",
                "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(free_ports(1)[0])}
    saved = {k: os.environ.get(k) for k in contract}
    os.environ.update(contract)
    try:
        env = dist.init_parallel_env()
        if env.backend != "nccl" or dist.get_backend() != "NCCL":
            raise AssertionError(f"one rank on its own card took "
                                 f"{env.backend}, not nccl")
        C.reset_counters()
        gen = torch.Generator(device="cuda").manual_seed(16)
        x = torch.randn(64 << 20, generator=gen, device="cuda")
        y, z, outs = x.clone(), x.clone(), []
        dist.all_reduce(y)
        dist.broadcast(z, src=0)
        dist.all_gather(outs, x)
        torch.cuda.synchronize()
        ok = torch.equal(y, x) and torch.equal(z, x) and len(outs) == 1 \
            and torch.equal(outs[0], x)
        ms = {"all_reduce": _time_eager(lambda: dist.all_reduce(y)),
              "broadcast": _time_eager(lambda: dist.broadcast(z, src=0)),
              "all_gather": _time_eager(lambda: dist.all_gather([], x))}
        routes = C.route_counts()
        still = torch.equal(y, x) and torch.equal(z, x)
    finally:
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"[{card}] phase 16 (d) one-rank nccl group on cuda:0, 256 MiB "
          f"fp32: results equal to the input {ok and still}; ms "
          f"{ {k: round(v, 4) for k, v in ms.items()} }; routes {routes} "
          f"(one rank moves no bytes between cards: multi-card NCCL is "
          f"not measured)")
    if not (ok and still) or set(r for c in routes.values() for r in c) \
            != {"nccl"}:
        raise AssertionError(f"phase 16 (d): nccl group results {ok}, "
                             f"{still}; routes {routes}")


# -- phase 17: group-sharded (ZeRO) training, the sharded checkpoint, the
# in-graph bucketer, gradient merge ------------------------------------------

_ZERO_WORKER = os.path.join(_REPO, "tools", "port_zero_worker.py")
_ZERO_STEPS = 2            # each stage's steps
_ZERO_RUNS = "os,os_g,p_g_os,load"   # (d) runs in a job of its own
_ZERO_GM_LAYERS = 2        # (d)'s depth (cut: the phase's time)


def _zero_args():
    """The worker's model and data: phase 16's (the headline model, 4 x
    2048 a rank from RandomState(0), the data sized for phase 16 (a)'s
    steps so that each rank's batches are its)."""
    return ["--config", "headline", "--batch", "4", "--seq", "2048",
            "--steps", str(_ZERO_STEPS), "--data-steps", str(_DP_STEPS)]


def _zero_check_launches(recs, per_step, per_step_gm):
    """Every rank's launches, step by step: phase 16's per step (AdamW
    once a parameter, every region non-empty at 2 ranks; (d) at its
    depth); gradient merge two forward+backward passes a step. Returns
    the totals."""
    totals = {k: 0 for k in per_step}
    for r in recs:
        for run, rec in r["runs"].items():
            for i, st in enumerate(rec["steps"], 1):
                want = dict(per_step_gm if run.startswith("gm")
                            else per_step)
                if run == "gm":
                    want = {k: (v if k == "adamw" else 2 * v)
                            for k, v in want.items()}
                got = {k: st["launches"].get(k, 0) for k in want}
                if got != want or set(st["launches"]) - set(want):
                    raise AssertionError(
                        f"phase 17 rank {r['rank']} {run} step {i} "
                        f"launches {st['launches']}, expected {want}")
                for k in totals:
                    totals[k] += got[k]
    return totals


def _zero_print(card, recs):
    """Each stage's memory, slot bytes, step ms by part and bytes."""
    for r in recs:
        for run in ("os", "os_g", "p_g_os", "load"):
            rec = r["runs"][run]
            parts = []
            for i, st in enumerate(rec["steps"], 1):
                bits = [f"fwd+bwd {1e3 * st['fwd_bwd']:.1f}"]
                for k in ("forward_all_gather", "all_reduce",
                          "reduce_scatter", "all_gather"):
                    if k in st:
                        v = st[k]
                        gbs = v["bytes"] / max(v["s"], 1e-9) / 1e9
                        bits.append(f"{k} {1e3 * v['s']:.1f} ({v['bytes'] / 1e9:.3f} GB "
                                    f"payload, {gbs:.2f} GB/s, "
                                    f"{v.get('route')})")
                bits.append(f"adamw {1e3 * st['adamw']:.1f}")
                parts.append(f"step {i}: " + ", ".join(bits))
            peak = rec.get("peak_gb")
            rest = rec["steps"][-1]["resting_gb"]
            mem = "not measured" if peak is None else \
                f"peak {peak:.3f} GB, resting {rest:.3f} GB"
            print(f"[{card}] phase 17 (a) rank {r['rank']} {run}: {mem} a "
                  f"rank, slots {rec['slot_bytes'] / 1e9:.3f} GB; ms "
                  f"{'; '.join(parts)}; losses {rec['losses']}")


def _zero_training(torch, card, tmp):
    """Phases 16 (a) and 17 (a) with (b)'s save and 2-rank load: one
    2-rank job, alone on the card, that runs phase 16 (a)'s data-parallel
    job and then the ZeRO stages, held to its digests (the same loop,
    model and batches). Returns (phase 16 (a)'s launches, its records,
    phase 17's launches, the launches of one step)."""
    L = 16
    t0 = time.perf_counter()
    recs, _ = _finish_job("zero", _start_job(tmp, "zero", 2, _zero_args() + [
        "--runs", _ZERO_RUNS, "--dp-args=" + shlex.join(_dp_args(tmp))],
        worker=_ZERO_WORKER), 2, phase=17)
    wall = time.perf_counter() - t0
    dp, dp_digests = _dp_training(card, tmp)
    n_tensors = recs[0]["runs"]["os"]["param_tensors"]
    per_step = {k: v for k, v in _dp_per_step(L, n_tensors).items() if v}
    totals = _zero_check_launches(recs, per_step, None)
    for r in recs:
        for run in ("os", "os_g", "p_g_os"):
            if r["runs"][run]["digests"] != list(dp_digests[:_ZERO_STEPS]):
                raise AssertionError(f"phase 17 (a) rank {r['rank']} {run}: "
                                     f"params differ from phase 16's dp")
    if any(x["backend"] != "gloo" for x in recs):
        raise AssertionError("phase 17: the ranks took another route: "
                             f"{[x['backend'] for x in recs]}")
    print(f"[{card}] phase 17 (a) ZeRO on the headline model "
          f"({recs[0]['runs']['os']['params'] / 1e9:.4f}B params bf16, {L} "
          f"layers, full recompute, AdamW bf16 moments): 2 gloo ranks on "
          f"{recs[0]['device']}, batch 4 x 2048 a rank, {_ZERO_STEPS} steps "
          f"each of os, os_g, p_g_os, alone on the card; the launcher's "
          f"wall with phase 16 (a) {wall:.1f} s (seconds by run, rank 0: "
          f"{ {k: round(v['seconds'], 1) for k, v in recs[0]['runs'].items()} })")
    print(f"phase 17 (a) every stage's params bit-identical to phase 16 "
          f"(a)'s data-parallel run after each of its first {_ZERO_STEPS} "
          f"steps, both ranks (SHA-256 over the store): "
          f"{[d[:12] for d in dp_digests[:_ZERO_STEPS]]}; os_g built "
          f"through fleet.init + distributed_model + distributed_optimizer "
          f"(stage 2); routes os_g {recs[0]['runs']['os_g']['routes']}")
    _zero_print(card, recs)
    for r in recs:
        sv, ld = r["runs"]["os"]["save"], r["runs"]["load"]
        print(f"[{card}] phase 17 (b) rank {r['rank']}: save (async) of "
              f"the os state after step {_ZERO_STEPS - 1}: host snapshot "
              f"{sv['snapshot_s']:.3f} s, file writes {sv['write_s']:.3f} "
              f"s, {sv['bytes'] / 1e9:.3f} GB "
              f"({sv['bytes'] / 1e9 / max(sv['snapshot_s'] + sv['write_s'], 1e-9):.2f} GB/s); "
              f"2-rank load into p_g_os {ld['load_s']:.3f} s, largest "
              f"host buffer {ld['load_max_buffer_bytes'] / 1e6:.1f} MB vs "
              f"largest region {ld['largest_region_bytes'] / 1e6:.1f} MB; "
              f"regions bit-equal {ld['regions_equal']}, next step "
              f"bit-equal to the continuing job's {ld['next_step_equal']}")
        if not (ld["regions_equal"] and ld["next_step_equal"]) or \
                ld["load_max_buffer_bytes"] > ld["largest_region_bytes"]:
            raise AssertionError(f"phase 17 (b) rank {r['rank']}: {ld}")
    return dp, recs, totals, per_step


def _zero_beside_start(tmp):
    """(b)'s one-rank load of the job's checkpoint (a fresh process) and
    (d)'s 2-rank gradient-merge job, started beside phase 16 (b)."""
    ckpt = os.path.join(tmp, "zero", "ckpt")
    return (_start_job(tmp, "load1", 1, _zero_args() + [
                "--load1", "--ckpt", ckpt], worker=_ZERO_WORKER),
            _start_job(tmp, "gm", 2, _zero_args() + [
                "--runs", "gm,gm_full", "--gm-layers",
                str(_ZERO_GM_LAYERS)], worker=_ZERO_WORKER))


def _zero_beside_finish(card, started, recs, per_step):
    """Gates of (b)'s one-rank load (against the saving job's records)
    and of (d); no time is printed (they ran beside phase 16 (b)).
    Returns their launches."""
    load1, gm = started
    (one,), _ = _finish_job("load1", load1, 1, phase=17,
                            records=["load1.json"])
    saved = [r["runs"]["os"] for r in recs]
    ok = one["loaded_params"] == saved[0]["saved_params"] \
        and one["loaded_slots"] == [x["saved_slots"] for x in saved] \
        and one["digest"] == saved[0]["digests"][-1]
    print(f"[{card}] phase 17 (b) one-rank load (fresh process): largest "
          f"host buffer {one['load_max_buffer_bytes'] / 1e6:.1f} MB; params "
          f"and both ranks' slot regions bit-equal, and the next step (the "
          f"two ranks' mean gradient) bit-equal to the continuing job's: "
          f"{ok}")
    if not ok:
        raise AssertionError(f"phase 17 (b) one-rank load: {one}")
    per1 = {k: (v if k == "adamw" else 2 * v) for k, v in per_step.items()}
    if {k: one["launches"].get(k, 0) for k in per1} != per1:
        raise AssertionError(f"phase 17 (b) one-rank launches "
                             f"{one['launches']}, expected {per1}")
    gm_recs, _ = _finish_job("gm", gm, 2, phase=17)
    per_gm = {k: v for k, v in _dp_per_step(
        _ZERO_GM_LAYERS, recs[0]["runs"]["os"]["param_tensors"]).items()
        if v}
    totals = _zero_check_launches(gm_recs, per_step, per_gm)
    for k in totals:
        totals[k] += per1[k]
    for r in gm_recs:
        gm, full = r["runs"]["gm"], r["runs"]["gm_full"]
        print(f"[{card}] phase 17 (d) rank {r['rank']}: gradient merge "
              f"k=2 at the headline width, {_ZERO_GM_LAYERS} layers (two "
              f"micro-steps of 2 x 2048, sharding stage 1) vs one "
              f"step of 4 x 2048: merged gradient relative error max "
              f"{gm['grad_rel_max']:.4e}, median {gm['grad_rel_median']:.4e}"
              f" (tol {gm['grad_tol']}); losses {gm['losses']} vs "
              f"{full['losses']}")
    return totals


def _bucketer_check(torch, card):
    """Phase 17 (c): ``BucketedGradSync`` over a 2-way ("dp",) mesh of
    cuda:0 on per-shard fp32 gradients of the headline's shapes,
    captured once as a CUDA graph and replayed; the int8 fallback; then
    ``run_comms_bench`` over that mesh."""
    from paddle_tpu_torch.distributed.collectives import (
        BucketedGradSync, configure, int8_error_bound, run_comms_bench)
    from paddle_tpu_torch.distributed.mesh import build_device_mesh
    from paddle_tpu_torch.graphs import CapturedProgram
    from paddle_tpu_torch.models import LlamaForCausalLM
    from tools.port_train_bench import headline_big_config
    model = LlamaForCausalLM(headline_big_config("full"), device="cuda")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    mesh = build_device_mesh({"dp": 2}, devices=["cuda:0", "cuda:0"])
    gen = torch.Generator(device="cuda").manual_seed(17)
    grads = [{n: torch.randn(s, generator=gen, device="cuda")
              for n, s in shapes.items()} for _ in range(2)]

    def plain(n):      # the plain mean, made per tensor (memory)
        return (grads[0][n] + grads[1][n]) / 2
    hook = BucketedGradSync(axes=("dp",), mesh=mesh, compress=None)
    t0 = time.perf_counter()
    eager = hook(grads)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0)
    eager_ok = all(torch.equal(eager[s][n], plain(n))
                   for s in range(2) for n in shapes)
    del eager
    outs = [{n: torch.empty(s, device="cuda") for n, s in shapes.items()}
            for _ in range(2)]

    def run():
        res = hook(grads)
        for s in range(2):
            for n in shapes:
                outs[s][n].copy_(res[s][n])
    prog = CapturedProgram(run, "cuda:0", name="the bucketed grad sync")
    prog.capture()
    for o in outs:
        for t in o.values():
            t.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prog()
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t0)
    replay_ok = all(torch.equal(outs[s][n], plain(n))
                    for s in range(2) for n in shapes)
    del outs, prog
    torch.cuda.empty_cache()
    # the int8 route on the embedding and the norms (the full set's int8
    # codes and dequantized copies would take tens of GB)
    sub = [n for n in shapes if "embed" in n or "norm" in n]
    small = [{n: g[n] for n in sub} for g in grads]
    want = {n: plain(n) for n in sub}
    with configure(compress="int8", error_bound=0.0):
        exact = BucketedGradSync(axes=("dp",), mesh=mesh)(small)
    with configure(compress="int8", error_bound=1e9):
        loose = BucketedGradSync(axes=("dp",), mesh=mesh)(small)
    exact_ok = all(torch.equal(exact[s][n], want[n])
                   for s in range(2) for n in sub)
    err = max(float((loose[0][n] - want[n]).abs().max()) for n in sub)
    absmax = max(float(g[n].abs().max()) for g in small for n in sub)
    out_mx = max(float((2 * want[n]).abs().max()) for n in sub)
    bound = float(int8_error_bound(absmax, 2, bucket_absmax_out=out_mx)) / 2
    del grads, small, exact, loose
    torch.cuda.empty_cache()
    n_el = sum(math.prod(s) for s in shapes.values())
    print(f"[{card}] phase 17 (c) BucketedGradSync over a 2-way (\"dp\",) "
          f"mesh of cuda:0, {len(shapes)} fp32 gradients of the headline's "
          f"shapes ({n_el / 1e6:.1f}M elements a shard): eager "
          f"{eager_ms:.1f} ms, bit-equal to the plain mean {eager_ok}; the "
          f"captured program (one CUDA graph) replayed in {replay_ms:.1f} "
          f"ms, bit-equal {replay_ok}; int8 with error_bound=0 bit-equal to "
          f"fp32 {exact_ok}; int8 with a loose budget max error "
          f"{err:.4e} within its bound {bound:.4e}: {err <= bound} (on "
          f"{', '.join(sub)})")
    if not (eager_ok and replay_ok and exact_ok and 0 < err <= bound):
        raise AssertionError("phase 17 (c): the bucketed grad sync failed "
                             "a gate")
    bench = run_comms_bench(size_mb=64.0, iters=3, mesh=mesh)
    print(f"[{card}] phase 17 (c) run_comms_bench(64 MB, mesh of cuda:0 "
          f"x 2; one card: copies and sums, no link): {json.dumps(bench)}")
    q = bench["all_reduce_int8"]
    if not (q["within_bound"] and q["constant_exact"]):
        raise AssertionError(f"phase 17 (c): comms bench {q}")


def dp_zero_path(torch, card):
    """Phases 16 and 17 (see the module docstring), in the order set out
    there: what prints a time runs alone on the card. Returns the launch
    counts of phase 16 (a)'s workers (both ranks, their steps) and of
    phase 17's (both ranks of (a)/(b) and of (d), and (b)'s one-rank
    load)."""
    import shutil
    import tempfile
    from paddle_tpu_torch import ops
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pt_dp_")
    jobs = []
    try:
        dp, recs, zero, per_step = _zero_training(torch, card, tmp)
        print(f"phases 16 (a) and 17 (a) with (b)'s save and 2-rank load "
              f"took {time.perf_counter() - t_phase:.1f} s")
        t0 = time.perf_counter()
        _bucketer_check(torch, card)
        print(f"phase 17 (c) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        elastic = _dp_elastic_start(tmp)
        beside = _zero_beside_start(tmp)
        jobs = list(elastic[1].values()) + list(beside)
        _dp_elastic_finish(torch, card, elastic)
        more = _zero_beside_finish(card, beside, recs, per_step)
        print(f"phase 16 (b), 17 (b)'s one-rank load and 17 (d), side by "
              f"side, took {time.perf_counter() - t0:.1f} s")
    finally:
        for job in jobs:
            _stop_job(job)
        shutil.rmtree(tmp, ignore_errors=True)
    _nccl_one_rank(torch, card)
    print(f"phases 16 and 17 took {time.perf_counter() - t_phase:.1f} s")
    zero = {k: zero.get(k, 0) + more.get(k, 0) for k in ops.launch_counts()}
    return dp, zero


# -- phase 18: tensor-parallel (mp) training --------------------------------

_MP_WORKER = os.path.join(_REPO, "tools", "port_mp_worker.py")
_MP_STEPS = 2
_MP_LAYERS = 16         # (a)'s depth: the headline's, uncut
_DP_PEAK_GB = 9.915     # phase 16 (a)'s peak a rank (PERF.md §6, run Z1)


def _mp_args(tmp):
    return ["--config", "headline", "--batch", "4", "--seq", "2048",
            "--steps", str(_MP_STEPS), "--layers", str(_MP_LAYERS)]


def _mp_check(card, recs, wall):
    """Phase 18 (a)'s gates and lines from the job's records; returns
    the launches of both ranks' steps."""
    from paddle_tpu_torch import ops
    L = _MP_LAYERS
    per_step = {k: v for k, v in _dp_per_step(
        L, recs[0]["param_tensors"]).items() if v}
    totals = {k: 0 for k in ops.launch_counts()}
    for r in recs:
        for step, got in enumerate(r["launches"], 1):
            counts = {k: got.get(k, 0) for k in per_step}
            if counts != per_step:
                raise AssertionError(f"phase 18 rank {r['rank']} step {step}"
                                     f" launches {got}, expected {per_step}")
            for k in counts:
                totals[k] += counts[k]
        if any(s["mp_collectives"] != 5 * L + 5 for s in r["step_s"]):
            raise AssertionError(f"phase 18 rank {r['rank']}: mp "
                                 f"collectives {r['step_s']}, expected "
                                 f"{5 * L + 5} a step")
    losses = recs[0]["losses"]
    if any(r["losses"] != losses or r["backend"] != "gloo"
           or r["replicated_digests"] != recs[0]["replicated_digests"]
           for r in recs) or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 18 (a): ranks disagree or took another"
                             f" route: {[(r['losses'], r['backend']) for r in recs]}")
    if recs[0]["slice_digests"] == recs[1]["slice_digests"]:
        raise AssertionError("phase 18 (a): both ranks hold the same slices")
    ref = recs[0]
    for key in ("loss_check", "param_check", "grad_check", "accuracy"):
        if key not in ref:
            raise AssertionError(f"phase 18 (a): rank 0 ran no {key}")
    print(f"[{card}] phase 18 (a) tensor-parallel headline "
          f"({ref['params'] / 1e9:.4f}B params bf16, {L} layers, full "
          f"recompute, stacked trunk, AdamW bf16 moments) at mp 2: 2 gloo "
          f"ranks on one card, {ref['local_params'] / 1e9:.4f}B params a "
          f"rank (8 heads, 2816 MLP columns, 16000 vocabulary rows), batch "
          f"4 x 2048 on both, {_MP_STEPS} steps; the launcher's wall "
          f"{wall:.1f} s (rank 0's one-rank reference "
          f"{ref['reference_s']:.1f} s of it)")
    print(f"phase 18 (a) losses {losses}; replicated parameters (the norms)"
          f" bit-identical across the ranks after every step: "
          f"{[d[:12] for d in ref['replicated_digests']]}")
    for c in ref["loss_check"]:
        print(f"phase 18 (a) loss mp {c['mp']:.6f} vs one rank "
              f"{c['one_rank']:.6f}: relative {c['rel']:.3e} (tol "
              f"{c['tol']:.3e})")
    g = ref["grad_check"]
    print(f"phase 18 (a) step 1's gradients gathered vs one rank: largest "
          f"relative norm {g['max']:.4e} ({g['worst']}, tol {g['tol']}), "
          f"median {g['median']:.4e}")
    a = ref["accuracy"]
    print(f"phase 18 (a) step 1's gradients vs fp32 gradients of the same "
          f"weights and batch: one rank (bf16) median {a['one_rank_median']:.4e}"
          f", max {a['one_rank_max']:.4e}; mp median {a['mp_median']:.4e}, "
          f"max {a['mp_max']:.4e}; largest mp / one-rank ratio "
          f"{a['ratio_max']:.3f} ({a['worst']}, tol {a['tol']})")
    for step, c in enumerate(ref["param_check"], 1):
        print(f"phase 18 (a) step {step}'s parameters gathered vs one rank:"
              f" largest relative norm {c['max']:.4e} ({c['worst']}, tol "
              f"{c['tol']})")
    for r in recs:
        for step, s in enumerate(r["step_s"], 1):
            print(f"[{card}] phase 18 (a) rank {r['rank']} step {step}: "
                  f"forward+backward {1e3 * s['fwd_bwd']:.1f} ms, of which "
                  f"{s['mp_collectives']} mp all-reduces "
                  f"{s['mp_bytes'] / 1e9:.3f} GB in {1e3 * s['mp_s']:.1f} ms"
                  f" ({s['mp_bytes'] / 1e9 / max(s['mp_s'], 1e-9):.2f} GB/s,"
                  f" gloo through pinned host memory) and compute "
                  f"{1e3 * (s['fwd_bwd'] - s['mp_s']):.1f} ms; AdamW "
                  f"{1e3 * s['adamw']:.1f} ms")
        mem = (f"peak {r['peak_mem_gb']:.3f} GB, resting "
               f"{r['resting_mem_gb']:.3f} GB") if "peak_mem_gb" in r \
            else "memory not measured (no card)"
        print(f"[{card}] phase 18 (a) rank {r['rank']}: {mem} (phase 16's "
              f"data-parallel peak {_DP_PEAK_GB} GB a rank)")
    return totals


def _mp_kernel_checks(torch):
    """Phase 18 (c): RoPE, RMSNorm forward and backward and AdamW at one
    mp rank's shapes against their plain versions (flash at that shape is
    phase 2's ``mp2`` case)."""
    from paddle_tpu_torch.models.llama import _rope_cache
    from paddle_tpu_torch.ops import plain_versions
    from paddle_tpu_torch.ops.fused import (_rope_pair, rms_norm,
                                            rms_norm_backward_reference,
                                            rms_norm_bwd, rms_norm_reference)
    from tools.port_train_bench import headline_big_config
    cfg = headline_big_config()
    gen = torch.Generator(device="cuda").manual_seed(18)
    cos, sin = (t[:2048].bfloat16() for t in _rope_cache(cfg, "cuda"))
    q, k = (torch.randn(4, 2048, 8, 128, generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    tol = 2.0 ** -7 * 2 * float(max(q.float().abs().max(),
                                    k.float().abs().max()))
    rope_err = 0.0
    for sign in (1.0, -1.0):
        got = _rope_pair(q, k, cos, sin, sign)
        with plain_versions():
            want = _rope_pair(q, k, cos, sin, sign)
        rope_err = max([rope_err] + [_max_err(a, b)
                                     for a, b in zip(got, want)])
    if not rope_err <= tol:
        raise AssertionError(f"phase 18 (c) rope (4, 2048, 8, 128): "
                             f"{rope_err} > {tol}")
    del q, k, got, want
    h, eps = cfg.hidden_size, cfg.rms_norm_eps
    x = torch.randn(4 * 2048, h, generator=gen, device="cuda").bfloat16()
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).bfloat16()
    ct = torch.randn(4 * 2048, h, generator=gen, device="cuda").bfloat16()
    y, want = rms_norm(x, w, eps), rms_norm_reference(x, w, eps)
    rms_err = _max_err(y, want)
    if not torch.allclose(y.float(), want.float(), atol=RMS_BF16_TOL[0],
                          rtol=RMS_BF16_TOL[1]):
        raise AssertionError(f"phase 18 (c) rms_norm (8192, 2048): "
                             f"{rms_err}")
    dx, dw = rms_norm_bwd(x, w, ct, eps)
    pdx, pdw = rms_norm_backward_reference(x, w, ct, eps)
    okx, _, sx = _rms_bwd_close(dx, pdx, _rms_bwd_tol(torch, pdx, "dx"))
    okw, _, sw = _rms_bwd_close(
        dw, pdw, _rms_bwd_tol(torch, pdw, "dw", x, ct, eps))
    if not (okx and okw):
        raise AssertionError(f"phase 18 (c) rms_norm_bwd (8192, 2048): dx "
                             f"share {sx}, dw share {sw}")
    del x, w, ct, y, want, dx, dw, pdx, pdw
    hp = _adamw_hp(torch)
    shares = {}
    for shape in ((16, 2816, h), (16, h, 2816)):
        p = (0.02 * torch.randn(shape, generator=gen, device="cuda")
             ).bfloat16()
        g = (1e-3 * torch.randn(shape, generator=gen, device="cuda")
             ).bfloat16()
        m = (1e-4 * torch.randn(shape, generator=gen, device="cuda")
             ).bfloat16()
        v = (1e-8 * torch.rand(shape, generator=gen, device="cuda")
             ).bfloat16()
        by_step, _ = _adamw_steps(torch, p, g, m, v, hp, _bf16_shares)
        shares[shape] = max(max(s) for s in by_step.values())
        if not shares[shape] <= 1.0:
            raise AssertionError(f"phase 18 (c) adamw {shape}: {by_step}")
        del p, g, m, v
    torch.cuda.empty_cache()
    print(f"phase 18 (c) at one mp rank's shapes, kernels vs plain: rope "
          f"(4, 2048, 8, 128) bf16 max abs err {rope_err:.4e} (tol "
          f"{tol:.4e}); rms_norm (8192, 2048) bf16 {rms_err:.4e}, its "
          f"backward within tol (largest shares dx {sx:.3f}, dw {sw:.3f}); "
          f"adamw bf16 moments largest share of the per-element tol "
          + ", ".join(f"{s} {v:.3f}" for s, v in shares.items())
          + "; flash (4, 2048, 8, 128): phase 2's mp2 lines")


def mp_path(torch, card):
    """Phase 18 (see the module docstring). Returns the launch counts of
    (a)'s workers (both ranks, their steps)."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="pt_mp_")
    jobs = []
    try:
        ckpt = os.path.join(tmp, "mp", "ckpt")
        t0 = time.perf_counter()
        jobs.append(_start_job(tmp, "mp", 2, _mp_args(tmp) + [
            "--reference", "--ckpt", ckpt], worker=_MP_WORKER))
        recs, _ = _finish_job("mp", jobs[-1], 2, phase=18)
        launches = _mp_check(card, recs, time.perf_counter() - t0)
        t0 = time.perf_counter()
        jobs.append(_start_job(tmp, "mpload", 1, _mp_args(tmp) + [
            "--load", ckpt], worker=_MP_WORKER))
        (one,), _ = _finish_job("mpload", jobs[-1], 1, phase=18)
        saved = sum(r["saved_regions"] for r in recs)
        if one["regions_checked"] != saved:
            raise AssertionError(f"phase 18 (b): {one['regions_checked']} "
                                 f"regions checked, {saved} saved")
        print(f"[{card}] phase 18 (b) the mp 2 checkpoint (JAX's layout and"
              f" global shapes, {saved} regions; rank 0's save "
              f"{recs[0]['save_s']:.2f} s) loaded by a fresh one-rank "
              f"process at the headline width in {one['load_s']:.2f} s: "
              f"every region bit-equal (SHA-256); the process took "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        for job in jobs:
            _stop_job(job)
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    _mp_kernel_checks(torch)
    print(f"phase 18 (c) took {time.perf_counter() - t0:.1f} s")
    print(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> int:
    _cache_bytecode()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    from paddle_tpu_torch.ops import build
    from tools.port_train_bench import card_line

    t_script = time.perf_counter()
    seconds, last = {}, [t_script]

    def mark(phase):
        """The seconds since the previous mark, as ``phase``'s."""
        now = time.perf_counter()
        seconds[phase] = round(now - last[0], 1)
        last[0] = now

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
    check_weight_only_sass()
    mark("1")

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
    mark("2")
    serving, model, ref = serving_path(torch, card)
    torch.cuda.empty_cache()
    mark("3")
    serving8, ref8 = serving_int8_path(torch, card, model)
    mark("4")
    megakernel = serving_megakernel_path(torch, card, model,
                                         {"fp32": ref, "int8": ref8})
    torch.cuda.empty_cache()
    mark("5")
    dense, dense_engine = serving_dense_path(torch, card, model, ref)
    gen = generate_path(torch, card, model, dense_engine)
    del dense_engine
    torch.cuda.empty_cache()
    mark("6")
    resilience = serving_resilience_path(torch, card, model)
    torch.cuda.empty_cache()
    mark("11")
    wo, features = decode_features_path(torch, card, model, ref)
    del model
    gc.collect()          # the serving phases' engines form cycles
    torch.cuda.empty_cache()
    mark("12")
    fleet = fleet_path(torch, card, ref)
    mark("13")
    durable = durable_path(torch, card, ref)
    torch.cuda.empty_cache()
    mark("14")
    tp = tp_path(torch, card, ref)
    mark("15")
    print(f"after the serving paths: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    train, idle7 = train_path(torch, card)
    torch.cuda.empty_cache()
    mark("7")
    loader = io_path(torch, card, idle7)
    torch.cuda.empty_cache()
    mark("10")
    ernie = ernie_moe_path(torch, card)
    torch.cuda.empty_cache()
    mark("8")
    headline = headline_path(torch, card)
    mark("9")
    dp, zero = dp_zero_path(torch, card)
    mark("16-17")
    mp = mp_path(torch, card)
    mark("18")
    print("phase seconds: " + json.dumps(seconds))
    paths = dict(residual=residual, serving=serving, int8_serving=serving8,
                 megakernel_serving=megakernel, dense_serving=dense,
                 generate=gen, resilience_serving=resilience,
                 decode_features=features, fleet_serving=fleet,
                 durable_fleet=durable, tp_serving=tp,
                 training=train, ernie_moe_training=ernie,
                 headline_training=headline, io_training=loader,
                 dp_training=dp, zero_training=zero, mp_training=mp)
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
        # no pallas_call: XLA fuses dequantize_array into the GEMM there
        dict(name="weight_only_gemm", route="cuda",
             source=src + "weight_only_gemm.cu",
             replaces="paddle_tpu/serving/quant.py:169",
             launches=counts["weight_only_gemm"], **wo),
    ]
    for k in kernels:
        if k["name"] in heads:      # the same keys at phase 9's shapes
            k["headline"] = dict(heads[k["name"]],
                                 launches=headline[k["name"]])
    unused = [k["name"] for k in kernels if not k["launches"] > 0]
    if unused:
        raise AssertionError(f"kernels no path launched: {unused}")
    print(f"chip_smoke took {time.perf_counter() - t_script:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
