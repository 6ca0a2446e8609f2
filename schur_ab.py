#!/usr/bin/env python3
"""Device time of the port's Schur update in two source trees, alternated,
on one NVIDIA GPU.

    python3 schur_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--rounds 2] [--seed 0]

Each tree's run is a process of its own with that tree's `src` on its
path, so two checkouts of `repro_torch` never share one; each builds its
own kernels. A run times, by torch.profiler's device events (the mean
over REPS calls after a warm-up), the Schur update in f64, f32, bf16 and
f16 at lu_blocked's two shapes, the trailing 1024³ update and the inner
992 × 32 × 992 update (a view of a 1024² tile against fresh strips),
beside `torch.addmm` on the same operands (TF32 off); then
`lu_blocked(x, 1024)` on an n = 4096 dominant matrix in f64, f32, bf16
and f16 (and bf16 with acc_dtype=float32): the Schur kernels' device ms in
one profiled call, their launches, the call's device ms and the median
warm wall of WALLS calls. It prints one JSON line. The trees run in the
order A B B A in every round (A B C C B A for three), so that a drift of
the card's clock over the call weighs on all. The last line gives, for
each measurement, the median of the runs by tree and each later tree's
over the first's.
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
N, BLOCK, INNER = 4096, 1024, 32
REPS, WALLS = 50, 3


def child(src: str, seed: int) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, src)
    from repro_torch.core.lu import lu_blocked
    from repro_torch.kernels import build, ops

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    cuda = torch.autograd.DeviceType.CUDA

    def device_events(fn, reps):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return [e for e in prof.events() if e.device_type == cuda]

    def ms_per_call(fn) -> float:
        events = device_events(fn, REPS)
        return sum(e.time_range.elapsed_us() for e in events) / REPS / 1e3

    def draw(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32),
                        ("bf16", torch.bfloat16), ("f16", torch.float16)):
        tile = draw((BLOCK, BLOCK), dtype)
        w = BLOCK - INNER
        shapes = {"1024^3": [draw((BLOCK, BLOCK), dtype) for _ in range(3)],
                  "inner": [tile[INNER:, INNER:], draw((w, INNER), dtype),
                            draw((INNER, w), dtype)]}
        for label, (c, a, b) in shapes.items():
            out[f"schur {name} {label}"] = ms_per_call(
                lambda: ops.schur_update(c, a, b))
            out[f"addmm {name} {label}"] = ms_per_call(
                lambda: torch.addmm(c, a, b, alpha=-1))
        x = torch.from_numpy(rng.standard_normal((N, N)) + N * np.eye(N)).to(
            dev, dtype)
        accs = (None, torch.float32) if name == "bf16" else (None,)
        for acc in accs:
            key = f"lu_blocked {name}" + (" acc f32" if acc else "")
            call = lambda: lu_blocked(x, BLOCK, acc_dtype=acc)
            events = device_events(call, 1)
            schur = [e for e in events if "schur_" in e.name]
            out[f"{key} schur ms"] = sum(
                e.time_range.elapsed_us() for e in schur) / 1e3
            out[f"{key} schur launches"] = len(schur)
            out[f"{key} device ms"] = sum(
                e.time_range.elapsed_us() for e in events) / 1e3
            walls = []
            for _ in range(WALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[f"{key} warm wall s"] = statistics.median(walls)
    return out


def main(child=child, script: str = __file__, doc: str = __doc__) -> int:
    """Run `script`'s `child` in each tree, A B B A a round (A B C C B A
    for three), and print the runs and their summary (flash_ab.py and
    trsm_ab.py pass their own)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a tree's src directory; give two or more")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.seed)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print(f"{Path(script).stem}: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) < 2:
        ap.error("give two or more --tree NAME=PATH")
    order = [*trees.items(), *reversed(trees.items())]
    runs: dict[str, list[dict]] = {name: [] for name in trees}
    for _ in range(args.rounds):
        for name, src in order:
            proc = subprocess.run(
                [sys.executable, script, "--child", str(ROOT / src),
                 "--seed", str(args.seed)],
                capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[name].append(line)
            print(json.dumps({"tree": name, **line}), flush=True)
    first, *others = trees
    summary = {}
    keys = dict.fromkeys(k for r in runs.values() for line in r for k in line)
    for key in keys:
        if key in ("src", "card"):
            continue
        med = {name: statistics.median(line[key] for line in runs[name])
               for name in trees
               if all(line.get(key) is not None for line in runs[name])}
        summary[key] = {**med, **{
            f"{b}/{first}": med[b] / med[first] if med.get(first) else None
            for b in others if b in med}}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"summary": summary, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
