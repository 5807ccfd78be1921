#!/usr/bin/env python3
"""The serving phases of ``chip_smoke.py`` (3, 4 and 5: paged serving at
Llama-2-7B shape over the fp32 and the int8 arena, unfused and with the
megakernel) for one or more checkouts of the port, on one GPU, each run
in a process of its own, in the order given. It compares a change with
its parent on the same card:

    python3 tools/port_serving_ab.py parent=_archive/parent change=. \\
        --order parent,change,change,parent --out OUTDIR

Each run builds its checkout's serving kernels, runs that checkout's
``serving_path``, ``serving_int8_path`` and ``serving_megakernel_path``
and writes what they print to ``OUTDIR/<i>_<name>.log`` and every
served request's tokens to ``OUTDIR/<i>_<name>.json``. This script
prints the lines of each log that hold the serving figures (decode step
ms, decode tokens/s, TTFT, the decode block's idle share, RMSNorm's
kernel time inside a block, the graphs' capture cost), then whether each
run's streams, greedy and sampled, are token-identical to the first
run's. It exits 1 if a run fails or a stream differs."""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

SHOWN = re.compile(r"decode_step_ms|idle|graphs:|RMSNorm kernel|served \d+ "
                   r"requests|greedy streams|card:|kernels built|Error")
KERNELS = ["rms_norm", "paged_attention", "decode_layer"]


def child(root: str, out: str):
    """One run: ``root``'s serving phases on the GPU, tokens to ``out``."""
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import build
    streams = []
    serve = cs._serve_checked

    def recording(torch_, srv, engine, reqs, vocab):
        rids, res, counts, wall = serve(torch_, srv, engine, reqs, vocab)
        streams.append([res[r].tolist() for r in rids])
        return rids, res, counts, wall

    cs._serve_checked = recording
    card = cs._card_line()
    print(f"card: {card} ({root})", flush=True)
    t0 = time.perf_counter()
    build.build(KERNELS)
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, model, ref = cs.serving_path(torch, card)
    torch.cuda.empty_cache()
    _, ref8 = cs.serving_int8_path(torch, card, model)
    cs.serving_megakernel_path(torch, card, model,
                               {"fp32": ref, "int8": ref8})
    with open(out, "w") as f:
        json.dump(streams, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="name=checkout root")
    ap.add_argument("--order", help="names, comma separated")
    ap.add_argument("--out", help="directory for the logs and tokens")
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(*args.child)
        return 0
    if not args.out:
        ap.error("--out is required")
    trees = dict(t.split("=", 1) for t in args.trees)
    order = args.order.split(",") if args.order else list(trees)
    out = os.path.abspath(args.out)       # the runs change directory
    os.makedirs(out, exist_ok=True)
    runs = []
    for i, name in enumerate(order):
        log = os.path.join(out, f"{i}_{name}.log")
        tokens = os.path.join(out, f"{i}_{name}.json")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 trees[name], tokens], stdout=f, stderr=subprocess.STDOUT,
                timeout=1500).returncode
        print(f"== run {i} ({name}): exit {rc} in "
              f"{time.perf_counter() - t0:.1f} s")
        with open(log) as f:
            for line in f:
                if SHOWN.search(line):
                    print("  " + line.rstrip())
        if rc != 0:
            return 1
        with open(tokens) as f:
            runs.append((name, json.load(f)))
    first, ref = runs[0]
    ok = True
    for i, (name, streams) in enumerate(runs[1:], 1):
        same = [sum(a == b for a, b in zip(x, y)) for x, y in
                zip(ref, streams)]
        sizes = [len(x) for x in ref]
        print(f"run {i} ({name}) vs run 0 ({first}): token-identical "
              f"streams per served run {same} of {sizes}")
        ok = ok and same == sizes and len(streams) == len(ref)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
