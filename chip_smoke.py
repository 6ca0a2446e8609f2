#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printed as one JSON line:

1. build the port's CUDA kernels from src/repro_torch/kernels/csrc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (CED bit for bit; the LU panel and the
   triangular solves within 1e-12 of max|plain|: the same arithmetic
   with another FMA contraction and summation order);
3. `outsource_determinant` on one n = 4096 float64 matrix over N = 4
   servers (q3, then q1 and q2), checked against torch.linalg.slogdet;
4. a (16, 1024, 1024) float64 stack;
5. n = 4094, which the border pads to 4096;
6. tampered runs: q3 must reject the tampered matrix and only it.

Then it prints the kernels line (launches on phase 3, error from phase 2,
time per launch beside the plain version, the library call where one
computes the same function, and the least time the card could take),
the card's name and power limit, and last
{"ok": true, "device": {...}}. All inputs come from --seed through numpy.
Any failed check raises, so the script exits non-zero and prints no last
line; it does so too without a CUDA device or without the repository.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
N_SERVERS = 4
SINGLE_N = 4096
BATCH, BATCH_N = 16, 1024
PADDED_N = 4094
INNER = 32
RTOL = 1e-12
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s and the
#: f64 (tensor core) and f32 operation rates
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float64: 67e12, torch.float32: 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def dominant(rng: np.random.Generator, shape) -> np.ndarray:
    """standard_normal + n·I: diagonally dominant, so the no-pivot LU is
    stable."""
    n = shape[-1]
    return rng.standard_normal(shape) + n * np.eye(n)


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of one call by CUDA events around it. For a short
    kernel this includes the host's launch latency, because the card
    waits for the launch between the two events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def short_name(name: str) -> str:
    """A device event's kernel name without signature or namespaces."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1].strip()


def device_events(fn, reps: int):
    """(device events, host seconds) of `reps` calls under torch.profiler,
    after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return events, host_s


def device_ms(fn, reps: int) -> float:
    """Device time per call: the summed duration of every kernel and copy
    the call put on the card (torch.profiler), averaged over `reps`."""
    events, _ = device_events(fn, reps)
    check(bool(events), "the profiler recorded no device activity")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def timed(fn, reps: int) -> tuple[float, float]:
    """(device ms, event ms) per call."""
    return device_ms(fn, reps), event_ms(fn, reps)


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-300)


# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    per_source = build.build()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in build.SOURCES:
        log = Path(f"{build.target(name)}.log")
        lines = log.read_text().splitlines() if log.exists() else []
        ptxas[name] = [ln.replace("ptxas info    :", "").strip()
                       for ln in lines if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds, "per_source_s": per_source,
          "ptxas": ptxas})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def phase_kernels(rng, dev) -> dict:
    """Each kernel against its plain version; returns max errors."""
    from repro_torch.kernels import ops, ref

    errs = {}
    # CED: every k, both modes, growth-safe, both shapes, both dtypes
    worst = 0.0
    for shape in ((SINGLE_N, SINGLE_N), (BATCH, BATCH_N, BATCH_N)):
        m64 = torch.from_numpy(rng.standard_normal(shape)).to(dev)
        v64 = torch.from_numpy(rng.uniform(0.5, 2.0, shape[:-1])).to(dev)
        for dtype in (torch.float64, torch.float32):
            m, v = m64.to(dtype), v64.to(dtype)
            for k in range(4):
                for mode in ("ewd", "ewm"):
                    for gs in (False, True):
                        got = ops.ced(m, v, k, mode=mode, growth_safe=gs)
                        want = ref.ced_ref(m, v, k, mode=mode, growth_safe=gs)
                        torch.cuda.synchronize()
                        worst = max(worst, max_err(got, want)[0])
                        check(torch.equal(got, want),
                              f"ced {shape} {dtype} k={k} {mode} gs={gs}")
    errs["ced"] = worst
    emit({"phase": "kernel_vs_plain", "kernel": "ced", "cases": 64,
          "max_abs_err": worst, "tolerance": "bit-equal (torch.equal)"})

    # panel LU at the tiles of lu_diag_factor
    worst = 0.0
    for shape in ((INNER, INNER), (48, 48), (64, INNER, INNER),
                  (BATCH, INNER, INNER)):
        a = torch.from_numpy(dominant(rng, shape)).to(dev)
        abs_err, rel = max_err(ops.lu_panel(a), ref.lu_panel_ref(a))
        torch.cuda.synchronize()
        emit({"phase": "kernel_vs_plain", "kernel": "lu_panel",
              "shape": list(shape), "max_abs_err": abs_err,
              "max_rel_err": rel, "tolerance": RTOL})
        check(rel <= RTOL, f"lu_panel {shape}: {rel}")
        worst = max(worst, abs_err)
    errs["lu_panel"] = worst

    # triangular solves: the Algorithm-3 strips and the panel strips
    def triangles(lead, n):
        l = (torch.from_numpy(np.tril(rng.standard_normal((*lead, n, n)), -1)
                              / n + np.eye(n)).to(dev))
        u = (torch.from_numpy(np.triu(rng.standard_normal((*lead, n, n)))
                              + n * np.eye(n)).to(dev))
        return l, u

    worst_l = worst_u = 0.0
    b = SINGLE_N // N_SERVERS
    l, u = triangles((), b)
    tile = torch.from_numpy(dominant(rng, (b, b))).to(dev)
    lb, ub = triangles((BATCH,), BATCH_N // N_SERVERS)
    cases = [
        ("1024x1024 vs 1024x1024", l, u,
         torch.from_numpy(rng.standard_normal((b, b))).to(dev),
         torch.from_numpy(rng.standard_normal((b, b))).to(dev)),
        ("32x32 vs 32x992 strided view", tile[:INNER, :INNER],
         tile[:INNER, :INNER], tile[:INNER, INNER:], tile[INNER:, :INNER]),
        ("batched (16, 256, 256)", lb, ub,
         torch.from_numpy(rng.standard_normal(lb.shape)).to(dev),
         torch.from_numpy(rng.standard_normal(ub.shape)).to(dev)),
    ]
    for label, lt, ut, rhs_l, rhs_u in cases:
        abs_l, rel_l = max_err(ops.trsm_lower(lt, rhs_l),
                               ref.trsm_lower_ref(lt, rhs_l))
        abs_u, rel_u = max_err(ops.trsm_upper_right(ut, rhs_u),
                               ref.trsm_upper_right_ref(ut, rhs_u))
        torch.cuda.synchronize()
        emit({"phase": "kernel_vs_plain", "kernel": "trsm", "case": label,
              "trsm_lower": {"max_abs_err": abs_l, "max_rel_err": rel_l},
              "trsm_upper_right": {"max_abs_err": abs_u, "max_rel_err": rel_u},
              "tolerance": RTOL})
        check(rel_l <= RTOL and rel_u <= RTOL, f"trsm {label}: {rel_l} {rel_u}")
        worst_l, worst_u = max(worst_l, abs_l), max(worst_u, abs_u)
    errs["trsm_lower"], errs["trsm_upper_right"] = worst_l, worst_u
    return errs


# ---------------------------------------------------------------------------
def slogdet_det(m: torch.Tensor):
    from repro_torch.core.decipher import Determinant

    sign, logabs = torch.linalg.slogdet(m)
    if m.ndim == 2:
        return Determinant(float(sign), float(logabs))
    return [Determinant(float(s), float(la)) for s, la in zip(sign, logabs)]


def expected_launches(n: int, batch: int | None = None) -> dict:
    """Launches of one run, reckoned from the code: per server one
    Doolittle tile per 32-wide panel (one tile below b = 64), a
    triangular-solve pair between panels, and N(N-1)/2 outer strips of
    each kind; one CED launch per rotation degree in the stack."""
    b = n // N_SERVERS
    panels = math.ceil(b / INNER) if b >= 64 else 1
    outer = N_SERVERS * (N_SERVERS - 1) // 2
    inner = N_SERVERS * (panels - 1)
    return {"lu_panel": N_SERVERS * panels, "trsm_lower": inner + outer,
            "trsm_upper_right": inner + outer}


def run_counted(ops, fn):
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def timings(res) -> dict:
    t = res.report.timings
    return {"pmop_s": t.pmop_s, "dispatch_s": t.dispatch_s,
            "collect_s": t.collect_s, "total_s": t.total_s}


def phase_single(rng, dev) -> dict:
    import repro_torch
    from repro_torch.kernels import ops

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    res, launches = run_counted(
        ops, lambda: repro_torch.outsource_determinant(m, N_SERVERS))
    want = slogdet_det(torch.from_numpy(m).to(dev))
    check(res.verified, f"single n={SINGLE_N} verified")
    check(res.det.allclose(want), f"single det {res.det} vs {want}")
    want_counts = expected_launches(SINGLE_N)
    check(launches["ced"] == 1, f"ced launches {launches['ced']}")
    for name, count in want_counts.items():
        check(launches[name] == count, f"{name} launches {launches[name]} != {count}")
    others = {}
    for method in ("q1", "q2"):
        r = repro_torch.outsource_determinant(m, N_SERVERS, method=method)
        check(r.verified and r.det.allclose(want), f"single {method}")
        others[method] = {"residual": r.residual, "eps": r.report.verdict.eps}
    t0 = time.perf_counter()
    warm = repro_torch.outsource_determinant(m, N_SERVERS)
    wall = time.perf_counter() - t0
    check(warm.verified and warm.det.allclose(want), "single warm run")
    emit({"phase": "single", "n": SINGLE_N, "servers": N_SERVERS,
          "dtype": "float64", "method": "q3", "rotate_k": res.meta.rotate_k,
          "verified": res.verified, "residual": res.residual,
          "eps": res.report.verdict.eps,
          "logabs": res.det.logabs, "slogdet_logabs": want.logabs,
          "sign": res.det.sign, "launches": launches,
          "expected_launches": want_counts, "q1_q2": others,
          "warm_wall_s": wall, "warm_timings": timings(warm)})
    return launches


def phase_batch(rng, dev) -> dict:
    import repro_torch
    from repro_torch.kernels import ops

    m = dominant(rng, (BATCH, BATCH_N, BATCH_N))
    res, launches = run_counted(
        ops, lambda: repro_torch.outsource_determinant(m, N_SERVERS))
    want = slogdet_det(torch.from_numpy(m).to(dev))
    check(bool(res.verified.all()), f"batch verified {res.verified}")
    check(all(g.allclose(w) for g, w in zip(res.dets, want)), "batch dets")
    ks = sorted({mt.rotate_k for mt in res.metas})
    check(launches["ced"] == len(ks), f"batch ced launches {launches['ced']}")
    for name, count in expected_launches(BATCH_N).items():
        check(launches[name] == count, f"batch {name} launches {launches[name]}")
    t0 = time.perf_counter()
    warm = repro_torch.outsource_determinant(m, N_SERVERS)
    wall = time.perf_counter() - t0
    check(bool(warm.verified.all()), "batch warm run")
    emit({"phase": "batch", "shape": [BATCH, BATCH_N, BATCH_N],
          "servers": N_SERVERS, "dtype": "float64",
          "verified": int(res.verified.sum()), "rotate_ks": ks,
          "max_dlogabs": max(abs(g.logabs - w.logabs)
                             for g, w in zip(res.dets, want)),
          "launches": launches, "warm_wall_s": wall,
          "warm_timings": timings(warm)})
    return launches


def phase_padded(rng, dev) -> dict:
    import repro_torch
    from repro_torch.kernels import ops

    m = dominant(rng, (PADDED_N, PADDED_N))
    res, launches = run_counted(
        ops, lambda: repro_torch.outsource_determinant(m, N_SERVERS))
    want = slogdet_det(torch.from_numpy(m).to(dev))
    check(res.padding == SINGLE_N - PADDED_N, f"padding {res.padding}")
    check(res.verified and res.det.allclose(want), f"padded {res.det} vs {want}")
    emit({"phase": "padded", "n": PADDED_N, "padding": res.padding,
          "verified": res.verified, "dlogabs": res.det.logabs - want.logabs,
          "launches": launches})
    return launches


def phase_tamper(rng) -> dict:
    """Server 2 adds 1e-3·max|U| to one diagonal entry of its U strip."""
    import repro_torch
    from repro_torch.kernels import ops

    def tamper_at(row, matrix=None):
        def tamper(l, u):
            u = u.clone()
            target = u if matrix is None else u[matrix]
            target[row, row] += 1e-3 * target.abs().max()
            return l, u
        return tamper

    b = SINGLE_N // N_SERVERS
    m = dominant(rng, (SINGLE_N, SINGLE_N))
    res, launches = run_counted(ops, lambda: repro_torch.outsource_determinant(
        m, N_SERVERS, tamper=tamper_at(2 * b + 7)))
    check(not res.verified, "tampered single accepted")
    check(res.report.verdict.culprit == 2,
          f"culprit {res.report.verdict.culprit}")
    mb = dominant(rng, (BATCH, BATCH_N, BATCH_N))
    bad = BATCH // 3
    resb, launches_b = run_counted(ops, lambda: repro_torch.outsource_determinant(
        mb, N_SERVERS, tamper=tamper_at(2 * (BATCH_N // N_SERVERS) + 3, bad)))
    want = np.ones(BATCH, dtype=bool)
    want[bad] = False
    check(np.array_equal(resb.verified, want), f"tampered batch {resb.verified}")
    for name in launches:
        launches[name] += launches_b[name]
    emit({"phase": "tamper", "single_rejected": not res.verified,
          "single_culprit": int(res.report.verdict.culprit),
          "batch_rejected": np.nonzero(~resb.verified)[0].tolist(),
          "launches": launches})
    return launches


def phase_profile(rng) -> None:
    """One warm single-matrix run under torch.profiler: device time by
    kernel and the share of the wall time the card was busy."""
    import repro_torch

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    results = []
    events, host_s = device_events(
        lambda: results.append(repro_torch.outsource_determinant(m, N_SERVERS)), 1)
    check(bool(events), "the profiler recorded no device activity")
    check(results[-1].verified, "profiled run verified")
    by_kernel: dict[str, list] = {}
    for evt in events:
        entry = by_kernel.setdefault(short_name(evt.name), [0.0, 0])
        entry[0] += evt.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "profile", "n": SINGLE_N, "wall_ms": host_s * 1e3,
          "timings": timings(results[-1]), "device_ms": busy_ms,
          "device_busy_share": busy_ms / (host_s * 1e3),
          "device_launches": sum(c for _, c in by_kernel.values()),
          "top_device_ms": {k: {"ms": v[0], "count": v[1]} for k, v in top}})


# ---------------------------------------------------------------------------
def kernels_line(rng, dev, launches: dict, errs: dict) -> dict:
    """Time each kernel, its plain version and the library call at the
    phase-3 shapes, beside its bound."""
    from repro_torch.kernels import ops, ref

    f64 = torch.float64
    n, b = SINGLE_N, SINGLE_N // N_SERVERS
    entries: list[dict] = []

    def row(name, source, replaces, shape, kernel, plain, library, reps,
            plain_reps, nbytes, ops_count, **extra):
        bound, by = bound_ms(nbytes, ops_count, f64)
        ms, kernel_event = timed(kernel, reps)
        plain_ms, plain_event = timed(plain, plain_reps)
        lib_ms, lib_event = timed(library, reps) if library else (None, None)
        entries.append({
            "name": name, "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "shape": shape, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by,
            "event_ms": {"kernel": kernel_event, "plain": plain_event,
                         "library": lib_event},
            **extra,
        })

    m = torch.from_numpy(rng.standard_normal((n, n))).to(dev)
    v = torch.from_numpy(rng.uniform(0.5, 2.0, n)).to(dev)
    row("ced", "ced.cu", "src/repro/kernels/ced.py:69", [n, n],
        lambda: ops.ced(m, v, 1), lambda: ref.ced_ref(m, v, 1), None, 20, 10,
        (2 * n * n + n) * 8, n * n)

    tile = torch.from_numpy(dominant(rng, (INNER, INNER))).to(dev)
    w = np.arange(INNER)  # trailing widths b-k-1 of the elimination steps
    row("lu_panel", "lu_panel.cu", "src/repro/kernels/lu_panel.py:52",
        [INNER, INNER], lambda: ops.lu_panel(tile),
        lambda: ref.lu_panel_ref(tile),
        lambda: torch.linalg.lu_factor_ex(tile, pivot=False), 50, 10,
        2 * INNER * INNER * 8, float((w + 2 * w * w).sum()),
        note="latency-bound: a 32-step dependent chain")

    lt = (torch.from_numpy(np.tril(rng.standard_normal((b, b)), -1) / b
                           + np.eye(b)).to(dev))
    ut = (torch.from_numpy(np.triu(rng.standard_normal((b, b))) + b * np.eye(b))
          .to(dev))
    rhs = torch.from_numpy(rng.standard_normal((b, b))).to(dev)
    row("trsm_lower", "trsm.cu", "src/repro/kernels/trsm.py:74", [b, b, b],
        lambda: ops.trsm_lower(lt, rhs), lambda: ref.trsm_lower_ref(lt, rhs),
        lambda: torch.linalg.solve_triangular(lt, rhs, upper=False,
                                              unitriangular=True),
        10, 3, (b * (b - 1) / 2 + 2 * b * b) * 8, b * (b - 1) * b)
    row("trsm_upper_right", "trsm.cu", "src/repro/kernels/trsm.py:114",
        [b, b, b], lambda: ops.trsm_upper_right(ut, rhs),
        lambda: ref.trsm_upper_right_ref(ut, rhs),
        lambda: torch.linalg.solve_triangular(ut, rhs, upper=True, left=False),
        10, 3, (b * (b + 1) / 2 + 2 * b * b) * 8, b * b * b)

    # the panel loop's strips: 32 x 32 against 32 x (b - 32), strided
    a = torch.from_numpy(dominant(rng, (b, b))).to(dev)
    tri = a[:INNER, :INNER]
    emit({"phase": "inner_strip_times", "shape": [INNER, b - INNER],
          "trsm_lower_ms": timed(lambda: ops.trsm_lower(tri, a[:INNER, INNER:]), 20),
          "trsm_upper_right_ms": timed(
              lambda: ops.trsm_upper_right(tri, a[INNER:, :INNER]), 20),
          "units": "(device ms, event ms) per launch"})
    for e in entries:
        e.update(route="cuda", launches=launches[e["name"]],
                 max_abs_err=errs[e["name"]])
    return {"kernels": entries}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda", torch.cuda.current_device())

    phase_build()
    card = card_line()
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card})
    errs = phase_kernels(rng, dev)
    per_phase = {
        "single": phase_single(rng, dev),
        "batch": phase_batch(rng, dev),
        "padded": phase_padded(rng, dev),
        "tamper": phase_tamper(rng),
    }
    for phase, launches in per_phase.items():
        for name, count in launches.items():
            check(count > 0, f"{name} never launched in phase {phase}")
    phase_profile(rng)
    emit(kernels_line(rng, dev, per_phase["single"], errs))
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
