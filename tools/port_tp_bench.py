#!/usr/bin/env python3
"""Tensor-parallel serving on the port: the same requests at tp=1 and
tp=2, on one card.

    python3 tools/port_tp_bench.py                  # Llama-2-7B shape
    python3 tools/port_tp_bench.py --config small   # the JAX bench's model
    python3 tools/port_tp_bench.py --config small --device cpu

The counterpart of ``paddle_tpu/serving/microbench.py``
``run_serving_tp_bench``. A paged engine with phase 3's geometry of
``chip_smoke.py`` (8 slots, max_len 1024, decode block 8, block 16,
chunk 32; max_len 64 and 2 slots for ``small``) serves 12 requests
(prompts of 32-512 tokens from ``np.random.RandomState(0)``, 32 new
tokens each, greedy) once to warm up and once timed,
unsharded and then over ``build_device_mesh({"mp": 2}, devices=[dev,
dev])``: a 2-way mesh whose two devices are the same card, so the two
shards share its memory bandwidth and SMs and the replicated work
(o_proj, down_proj, the embedding and the norms) runs twice. The numbers
describe the sharded program on one card; they claim nothing about two.
A psum-mode ``int8`` engine then serves one request and reports the
runtime bound of its int8 hidden-state all-reduce.

It prints one JSON line with the JAX bench's keys
(``serving_tp_devices``, ``serving_tp_axes``,
``serving_tp_bit_identical``, ``serving_tp_tokens_per_sec_1chip``,
``serving_tp_tokens_per_sec_mesh``,
``serving_tp_collective_bytes_per_step``,
``serving_tp_collective_calls_per_step``,
``serving_tp_int8_error_bound``) and beside them ``card`` (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), each engine's
decode step ms and the captures of the sharded programs. tokens/s count
the generated tokens over the timed run's wall time."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

if __package__ in (None, ""):      # run as a script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import numpy as np
import torch

GEOMETRY = {
    "7b": dict(num_slots=8, max_len=1024, decode_block=8, block_size=16,
               prefill_chunk=32),
    "small": dict(num_slots=2, max_len=64, decode_block=4, block_size=8,
                  prefill_chunk=8),
}
REQUESTS, MAX_NEW = 12, 32


def _config(name):
    from paddle_tpu_torch.models import LlamaConfig, llama_7b_config
    if name == "7b":
        return llama_7b_config()
    # the JAX bench's model (microbench.run_serving_tp_bench)
    return LlamaConfig(vocab_size=512, hidden_size=256,
                       intermediate_size=768, num_hidden_layers=4,
                       num_attention_heads=8, num_key_value_heads=8,
                       max_position_embeddings=256)


def _prompts(cfg, geo, n):
    rs = np.random.RandomState(0)
    hi = min(512, geo["max_len"] // 2)
    lo = min(32, hi // 4)
    return [rs.randint(0, cfg.vocab_size,
                       (int(rs.randint(lo, hi + 1)),)).astype(np.int32)
            for _ in range(n)]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(engine, prompts, max_new, dev):
    from paddle_tpu_torch.serving import Scheduler, Server
    engine.reset()
    srv = Server(engine, Scheduler(prefill_token_budget=256))
    rids = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    _sync(dev)
    t0 = time.perf_counter()
    res = srv.run_until_idle()
    _sync(dev)
    return [res[r] for r in rids], time.perf_counter() - t0, srv.stats()


def run(config: str = "7b", device: str = "cuda") -> dict:
    from paddle_tpu_torch.distributed.mesh import build_device_mesh
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import PagedEngine
    from paddle_tpu_torch.serving.tp import TPConfig
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(config)
    geo = GEOMETRY[config]
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    max_new = MAX_NEW
    prompts = _prompts(cfg, geo, REQUESTS)
    mesh = build_device_mesh({"mp": 2}, devices=[dev, dev])
    out = {}

    one = PagedEngine(model, device=dev, **geo)
    _run(one, prompts, max_new, dev)                   # warm-up
    ref, dt_one, st_one = _run(one, prompts, max_new, dev)
    del one
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    tp = PagedEngine(model, device=dev, tp=TPConfig(mesh=mesh), **geo)
    _run(tp, prompts, max_new, dev)
    prev = metrics.enabled()
    metrics.enable(True)
    try:
        bytes_c = metrics.counter("pt_collectives_bytes_total",
                                  "payload bytes handed to collectives",
                                  labels=("op", "mode"))
        calls_c = metrics.counter("pt_collectives_calls_total",
                                  "host-level collective dispatches",
                                  labels=("op", "mode"))
        b0 = bytes_c.value(op="tp_block", mode="tp_graph")
        c0 = calls_c.value(op="tp_block", mode="tp_graph")
        got, dt_tp, st_tp = _run(tp, prompts, max_new, dev)
        steps = max(tp.steps, 1)
        bytes_step = (bytes_c.value(op="tp_block", mode="tp_graph")
                      - b0) / steps
        calls_step = (calls_c.value(op="tp_block", mode="tp_graph")
                      - c0) / steps
    finally:
        metrics.enable(prev)
    identical = all(np.array_equal(a, b) for a, b in zip(ref, got))
    captures = (tp.decode_compile_count(), tp.prefill_compile_count())
    shard_kv = tp.backend.shard_kv_bytes()
    del tp
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    p8 = PagedEngine(model, device=dev,
                     tp=TPConfig(mode="psum", int8=True, mesh=mesh), **geo)
    _run(p8, prompts[:1], max_new, dev)
    from paddle_tpu_torch.serving import Request
    p8.reset()
    p8.try_admit(Request(request_id=0, prompt=prompts[0],
                         max_new_tokens=max_new))
    p8.prefill_tick(None)
    bound = p8.tp_int8_error_bound()
    del p8

    useful = REQUESTS * max_new
    out.update({
        "serving_tp_devices": 2,
        "serving_tp_axes": "2",
        "serving_tp_bit_identical": bool(identical),
        "serving_tp_tokens_per_sec_1chip": round(useful / dt_one, 1),
        "serving_tp_tokens_per_sec_mesh": round(useful / dt_tp, 1),
        "serving_tp_collective_bytes_per_step": int(bytes_step),
        "serving_tp_collective_calls_per_step": round(calls_step, 2),
        "serving_tp_int8_error_bound": float(bound),
        "decode_step_ms_1chip": round(st_one["decode_step_ms"], 3),
        "decode_step_ms_mesh": round(st_tp["decode_step_ms"], 3),
        "mesh_captures": list(captures),
        "mesh_shard_kv_bytes": shard_kv,
        "config": config, "requests": REQUESTS, "max_new": max_new,
    })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(GEOMETRY), default="7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("port_tp_bench: no CUDA device (pass --device cpu for the "
              "small config)", file=sys.stderr)
        return 1
    out = {}
    if args.device.startswith("cuda"):
        from tools.port_train_bench import card_line
        out["card"] = card_line()
    out.update(run(args.config, args.device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
