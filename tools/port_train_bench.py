#!/usr/bin/env python3
"""bench.py's headline training configuration on the port, on one GPU.

    python3 tools/port_train_bench.py

The counterpart of ``bench.py``'s ``_bench_train`` on
``_bench_common.headline_big_config(gran)``: the ~0.95B Llama (vocab
32000, hidden 2048, ff 5632, 16 layers, 16/16 heads) built in bf16 on
the card from seed 0 (a pure-bf16 build: ``AdamW(learning_rate=1e-4,
weight_decay=0.01, multi_precision=False)`` keeps bf16 moments), the
stacked trunk with per-layer recompute, and ``TrainStep``. Ids come from
``np.random.randint(0, vocab, (b, s))`` after ``np.random.seed(0)``,
labels are the ids rolled by one. Each stage runs 2 warm-up calls (the
first runs a step and captures the step as a CUDA graph, the second
replays it), then 8 timed steps through one ``TrainStep.run_steps``
(8 replays, one lr write, one host read of the last loss, as bench.py's
one program of 8 steps), and frees its model before the next. Stages:
"full" recompute at batch 8 x 2048 (the headline) and "selective" at
4 x 2048.

It prints one JSON line with bench.py's keys (``metric``, ``value``,
``unit``, ``mfu``, ``model_params``, ``batch``, ``seq``, ``final_loss``,
``step_ms``, ``config_big``, ``config_big_selective``): the headline is
the stage of the higher MFU, as bench.py keeps the selective stage only
when it beats full. Beside them: ``card``, the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them, each stage's peak device memory, its graph pool's MiB and
its kernel launches. MFU
is against 989 TFLOP/s (bf16 dense, H100 SXM). Without a GPU it raises:
there is no CPU run of this benchmark."""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

if __package__ in (None, ""):      # run as a script: the repo on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

SEQ = 2048
STAGES = {"full": 8, "selective": 4}       # recompute granularity: batch
STEPS, WARMUP = 8, 2
BF16_FLOPS = 989e12                        # H100 SXM, dense bf16


def headline_big_config(recompute_granularity: str = "full"):
    """The port's ``_bench_common.headline_big_config``: the same fields
    (``chip_smoke.py`` phase 9 imports it from here, so both time one
    program)."""
    from paddle_tpu_torch.models import LlamaConfig
    return LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_hidden_layers=16, num_attention_heads=16,
        num_key_value_heads=16, max_position_embeddings=2048,
        tensor_parallel=False, recompute=True,
        recompute_granularity=recompute_granularity,
        scan_layers=True, dtype="bfloat16")


def card_line() -> str:
    """``<name>, <power limit>`` of card 0, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _loss(model, batch):
    loss, _ = model(*batch)
    return loss


def build_stage(gran: str, batch: int):
    """The stage's model, optimizer and batch, built as ``bench.py``
    builds them (``chip_smoke.py`` steps a second one eagerly to hold
    the captured step against)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = headline_big_config(gran)
    model = LlamaForCausalLM(cfg, seed=0)          # on the GPU, or raises
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters(), multi_precision=False)
    np.random.seed(0)
    ids = np.random.randint(0, cfg.vocab_size, (batch, SEQ)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    data = (torch.from_numpy(ids).to(model.device),
            torch.from_numpy(labels).to(model.device))
    return model, opt, data


def bench_stage(gran: str, batch: int, inspect=None) -> dict:
    """One stage, built as ``bench.py`` builds it: ``bench.py``'s result
    dict (tokens/s, MFU, parameters, batch, seq, final loss, step ms)
    plus the peak device memory, the graph pool's MiB, the kernel
    launches of all its steps and the losses (the warm-up steps' and the
    last). ``inspect(model, step, batch, result)``, if given, runs after
    the timed steps while the model is alive."""
    import torch
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.jit import TrainStep
    torch.cuda.reset_peak_memory_stats()
    model, opt, data = build_stage(gran, batch)
    step = TrainStep(model, _loss, opt)
    ops.reset_launch_counts()
    losses = [float(step(data)) for _ in range(WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step.run_steps(data, STEPS)
    final = step.last_loss                     # read on the host
    dt = time.perf_counter() - t0
    losses.append(final)
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    tok_s = batch * SEQ * STEPS / dt
    out = {"tokens_per_sec": tok_s,
           "mfu": tok_s * model.flops_per_token(SEQ) / BF16_FLOPS,
           "model_params": int(model.num_params()),
           "batch": batch, "seq": SEQ, "final_loss": final,
           "step_ms": dt / STEPS * 1000, "remat": gran,
           "peak_mem_gb": peak / 1e9, "launches": launches,
           "graph_mib": step.graph_bytes / 2**20,
           "steps": WARMUP + STEPS, "losses": losses}
    if inspect is not None:
        inspect(model, step, data, out)
    del model, opt, step, data
    gc.collect()
    torch.cuda.empty_cache()
    return out


def result_line(stages: dict, card: str) -> dict:
    """bench.py's JSON keys from the stages' results."""
    import torch
    head = max(stages.values(), key=lambda r: r["mfu"])
    return {"metric": "llama_pretrain_tokens_per_sec_per_chip",
            "value": head["tokens_per_sec"], "unit": "tokens/s",
            "mfu": head["mfu"], "card": card,
            "device_kind": torch.cuda.get_device_name(0),
            "config_big": head,
            "config_big_selective": stages.get("selective"),
            **{k: head[k] for k in ("model_params", "batch", "seq",
                                    "final_loss", "step_ms")}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("port_train_bench needs a CUDA device; there is "
                           "no CPU run of this benchmark")
    card = card_line()
    stages = {g: bench_stage(g, b) for g, b in STAGES.items()}
    print(json.dumps(result_line(stages, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
