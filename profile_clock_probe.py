#!/usr/bin/env python3
"""Probe torch.profiler's device windows on one NVIDIA GPU.

    python3 profile_clock_probe.py [--windows 4] [--idle-s 120]

Profiles the f32 and f64 lower triangular solve at 1024³ (31 device
launches a call) and the trisolve leg L a = b at 4096² x 1024 (127), 10
calls a window as chip_smoke.py's kernels line times them, in windows
opened as chip_smoke.py opens them: right after the kernels are built,
after chip_smoke.py's gateway phase (on four socket daemons, which it
then stops), and every 30 s over an idle stretch. Each window's
device events are counted three ways: all of them; those that start on
the card after the timed range opened on the host, less half the pause
(a cut across the two clocks); and those whose launch the host made
after the timed range opened, less half the pause (by correlation id,
chip_smoke.py's device_events). Beside the counts, the least and the
median time from a launch on the host to its event's start on the card
(negative where the card's clock reads earlier than the host's), and
the launches whose device event the profiler lost. The plain version
and the library call of the f64 solve (torch ops, cuBLAS) are profiled
too, for their launches without an event.

One JSON line per stage, then {"ok": true} last. Needs a CUDA device
and the repository's src/ (chip_smoke.py beside this file).
"""
from __future__ import annotations

import argparse
import json
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

#: calls a window, as chip_smoke.py's kernels line times the solves
REPS = 10


def window(fn, reps: int) -> dict:
    everything, _ = cs.profiled(fn, reps)
    cuda = torch.autograd.DeviceType.CUDA
    opened = min(e.time_range.start for e in everything
                 if e.name == cs.TIMED_RANGE and e.device_type != cuda)
    device = [e for e in everything
              if e.device_type == cuda and e.name != cs.TIMED_RANGE]
    cut = opened - cs.WARM_PAUSE_S * 1e6 / 2
    kept, lost, launch_to_start = cs.timed_device_events(everything)
    return {"all": len(device),
            "time_cut": sum(e.time_range.start >= cut for e in device),
            "correlated": len(kept),
            "launch_to_start_us": {
                "min": min(launch_to_start, default=None),
                "median": (statistics.median(launch_to_start)
                           if launch_to_start else None)},
            "launches_without_event": lost}


def stage(name: str, cases: dict, windows: int, t0: float) -> dict:
    rows = {label: [window(fn, REPS) for _ in range(windows)]
            for label, (fn, _) in cases.items()}
    line = {"stage": name, "process_s": time.perf_counter() - t0,
            "expected_per_window": {
                label: per_call and REPS * per_call
                for label, (_, per_call) in cases.items()},
            "windows": rows}
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--windows", type=int, default=4)
    parser.add_argument("--idle-s", type=float, default=120.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_clock_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import ops, ref, trsm

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    dev = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(0)
    cases = {}
    for dtype in (torch.float32, torch.float64):
        lt, _ = cs.triangles(rng, dev, (), 1024, dtype)
        rhs = torch.from_numpy(rng.standard_normal((1024, 1024))).to(dev, dtype)
        cases[str(dtype).removeprefix("torch.")] = (
            lambda lt=lt, rhs=rhs: ops.trsm_lower(lt, rhs),
            trsm.cuda_launches(1024))
    # the linalg phase's left solve at its inverse round's chunk shape
    l4, _ = cs.triangles(rng, dev, (), 4096)
    r4 = torch.from_numpy(rng.standard_normal((4096, 1024))).to(dev)
    cases["trisolve_l"] = (lambda: ops.trsm_left(l4, r4, upper=False,
                                                 transpose_t=False),
                           trsm.cuda_launches(4096))
    l1, _ = cs.triangles(rng, dev, (), 1024)
    r1 = torch.from_numpy(rng.standard_normal((1024, 1024))).to(dev)
    cases["plain"] = (lambda: ref.trsm_lower_ref(l1, r1), None)
    cases["library"] = (lambda: torch.linalg.solve_triangular(
        l1, r1, upper=False, unitriangular=True), None)
    lines = [stage("start", cases, args.windows, t0)]
    root = tempfile.mkdtemp(prefix="clock-probe-sock-")
    procs = []
    try:
        addrs, procs, _ = cs.spawn_daemons(cs.N_SERVERS, root)
        cs.phase_gateway(np.random.default_rng([0, 4]), dev, addrs)
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)
    lines.append(stage("after_gateway", cases, args.windows, t0))
    idle_from = time.perf_counter()
    while time.perf_counter() - idle_from < args.idle_s:
        time.sleep(30.0)
        lines.append(stage("idle", cases, max(1, args.windows // 4), t0))
    cut_short: dict[str, int] = {}
    short = losing = 0
    for line in lines:
        for label, ws in line["windows"].items():
            losing += sum(w["launches_without_event"] > 0 for w in ws)
            want = line["expected_per_window"][label]
            if want is None:
                continue
            cut_short[line["stage"]] = cut_short.get(line["stage"], 0) + sum(
                w["time_cut"] < want for w in ws)
            short += sum(w["correlated"] != want for w in ws)
    print(json.dumps({"windows_short_by_time_cut": cut_short,
                      "windows_short_by_correlation": short,
                      "windows_losing_events": losing,
                      "card": cs.card_line()}), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
