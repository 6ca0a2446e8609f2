#!/usr/bin/env python3
"""What reading a profiler window costs, by the number of its events.

    python3 profile_parse_probe.py

On one CUDA card: a window of chip_smoke.py's kind (`cs.profiled`'s
fills, pause and timed range) around a short kernel and around the plain
triangular solves that chip_smoke.py's kernels line times (loops of
thousands of small launches). For each window, one JSON line: its
events, the seconds the profiler's exit took, the seconds `prof.events()`
took to build its events and the seconds `cs.window_events` took, and
whether both give `cs.timed_device_events` the same device events, lost
launches and launch-to-start times. Needs no kernel of the port: the
plain versions are PyTorch.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def window(fn, reps: int):
    """(the finished profile, exit seconds) of one chip_smoke window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    for _ in range(cs.WARM_LAUNCHES):
        pad.fill_(0.0)
    torch.cuda.synchronize()
    time.sleep(cs.WARM_PAUSE_S)
    with record_function(cs.TIMED_RANGE):
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    return prof, time.perf_counter() - t0


def kept(events) -> tuple:
    found, lost, launch_to_start = cs.timed_device_events(events)
    return (sorted((e.name, e.id, e.time_range.start, e.time_range.end)
                   for e in found), lost, sorted(launch_to_start))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_parse_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ref

    f64, dev = torch.float64, "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def upper(n, m):
        u = torch.triu(torch.randn(n, n, device=dev, dtype=f64, generator=gen))
        return (u + n * torch.eye(n, device=dev, dtype=f64),
                torch.randn(n, m, device=dev, dtype=f64, generator=gen))

    x = torch.zeros(1, device=dev)
    u1, b1 = upper(1024, 1024)
    u4, b4 = upper(4096, 1024)
    cases = [("add, 50 calls", lambda: x.add_(1), 50),
             ("trsm_upper_right_ref 1024², 3 calls",
              lambda: ref.trsm_upper_right_ref(u1, b1), 3),
             ("trsm_left_ref 4096 x 1024 upper, 2 calls",
              lambda: ref.trsm_left_ref(u4, b4, upper=True), 2)]
    window(cases[0][1], 1)  # the first window starts CUPTI
    for name, fn, reps in cases:
        prof, exit_s = window(fn, reps)
        t0 = time.perf_counter()
        light = cs.window_events(prof)
        light_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = prof.events()
        full_s = time.perf_counter() - t0
        print(json.dumps({
            "case": name, "events": len(full), "window_events": len(light),
            "kept": len(kept(light)[0]), "exit_s": exit_s,
            "prof_events_s": full_s, "window_events_s": light_s,
            "same_kept": kept(light) == kept(full)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
