#!/usr/bin/env python3
"""Warm prefill time of the port's model families in two source trees,
alternated, on one NVIDIA GPU.

    python3 prefill_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--arch mamba2-370m --arch llama4-scout-17b-a16e:4] [--rounds 2] \\
        [--warm 5]

Each (tree, arch) run is a process of its own with that tree's `src` on
its path, so two checkouts of `repro_torch` never share one. An arch
given as NAME:LAYERS keeps that many layers at full width (as
chip_smoke.py's SERVE_MODELS cut llama4 and qwen2-vl to fit the card). A
run draws the config's bf16 weights from --seed and a prompt batch of
chip_smoke.py's serving prefill shape, 4 × 2048, or its CHUNK_PREFILL,
1 × 16384, for a model with chunked attention: tokens from numpy's
default_rng(seed), or for a stub frontend (hubert, qwen2-vl) the
embeddings chip_smoke.py's model_inputs draws. It builds
`build_prefill_step`, calls it once cold and then --warm times,
each call closed by a synchronize, and prints one JSON line with the warm
times and their median. The trees run in the order A B B A in every
round, so that a drift of the card's clock over the call weighs on both.
The last line is the summary for each arch: the median of the runs'
medians by tree, the second tree's over the first's, the distance
between the first tree's quartiles, and in how many of the pairs of
consecutive runs (A B, then B A) the second tree was the faster.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, PROMPT = 4, 2048


def child(src: str, arch: str, seed: int, warm: int) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.steps import build_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    from dataclasses import replace

    sys.path.insert(0, str(ROOT))
    from chip_smoke import CHUNK_PREFILL, model_inputs

    name, _, layers = arch.partition(":")
    cfg = get_config(name)
    if layers:
        cfg = replace(cfg, num_layers=int(layers))
    model = init_lm(cfg, seed, device=dev)
    chunked = any(m == "attn_chunked" for m, _ in cfg.layer_list())
    shape = CHUNK_PREFILL if chunked else (BATCH, PROMPT)
    if cfg.frontend is None:
        tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)
        batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    else:
        batch = model_inputs(cfg, dev, *shape, seed, 0)
    prefill = build_prefill_step(cfg)

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(model, batch)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()):
            raise SystemExit(f"{arch}: prefill logits are not finite")
        return time.perf_counter() - t0

    cold_s = timed()
    runs = [timed() for _ in range(warm)]
    return {"arch": arch, "src": src, "cold_s": cold_s, "warm_runs_s": runs,
            "warm_s": statistics.median(runs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a tree's src directory; give two")
    ap.add_argument("--arch", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--warm", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", nargs=2, metavar=("SRC", "ARCH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(*args.child, args.seed, args.warm)))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) != 2:
        ap.error("give two --tree NAME=PATH")
    archs = args.arch or ["mamba2-370m", "granite-moe-1b-a400m"]
    first, second = trees
    order: dict = {a: [] for a in archs}  # (tree, median) in run order
    for r in range(args.rounds):
        for name in (first, second, second, first):
            for arch in archs:
                src = str((ROOT / trees[name]).resolve())
                run = subprocess.run(
                    [sys.executable, __file__, "--child", src, arch,
                     "--seed", str(args.seed), "--warm", str(args.warm)],
                    capture_output=True, text=True, check=False)
                if run.returncode != 0:
                    print(run.stdout, run.stderr, file=sys.stderr)
                    return 1
                line = json.loads(run.stdout.strip().splitlines()[-1])
                line.update(tree=name, round=r)
                print(json.dumps(line), flush=True)
                order[arch].append((name, line["warm_s"]))
    summary = {}
    for arch, runs in order.items():
        by = {name: [t for n, t in runs if n == name] for name in trees}
        # consecutive runs pair up: (A, B) then (B, A) in every round
        pairs = [dict(runs[i:i + 2]) for i in range(0, len(runs), 2)]
        q1, _, q3 = statistics.quantiles(by[first], n=4)
        summary[arch] = {
            **{name: statistics.median(v) for name, v in by.items()},
            f"{second}/{first}": statistics.median(by[second])
            / statistics.median(by[first]),
            f"{first}_iqr": q3 - q1,
            "pairs": len(pairs),
            f"{second}_faster_pairs": sum(p[second] < p[first] for p in pairs),
            "runs": by}
    print(json.dumps({"prefill_ab": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
