#!/usr/bin/env python3
"""Device time of the port's triangular solver (csrc/trsm.cu) in two or
more source trees, alternated, on one NVIDIA GPU.

    python3 trsm_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--tree older=.checkout/older/src] [--rounds 2] [--seed 0]

Each tree's run is a process of its own with that tree's `src` on its
path, so two checkouts of `repro_torch` never share one; each builds its
own kernels. A run times, by torch.profiler's device events (the mean
over REPS calls after a warm-up), every B3/B4 row of PERF.md's kernel
table at its shape and route, on the operands chip_smoke.py gives it:
  * trsm_lower (B3) and trsm_upper_right (B4) at 1024³ in every route the
    tree has (f64, f32, the mixed f32_f64, bf16_f32, f16_f32, bf16_f64,
    f16_f64, and the narrow bf16 and f16);
  * the panel loop's strips, 32² against 32 × 992 views of a 1024² tile;
  * the pipeline's block-row solve, L 1024² against (1024, 4096);
  * the four trisolve legs, 4096² against 4096 × 1024, reversed and
    transposed as ops.trsm_left runs them (trees that have it);
and, for the f64 and f32 rows, torch.linalg.solve_triangular on the same
operands in the same process (a yardstick the port never calls) and, from
one profiled 1024³ call, a leaf's mean device µs and the products' device
ms (the solver's kernels leaf_kernel and update_kernel). Each
case also gives its largest error against the plain version where that
is cheap (1024³ and the strips). Then the single n = 4096, N = 4 inline
`outsource_determinant` call: in one profiled call, the solver's leaves'
(leaf_kernel) and products' (update_kernel) device ms and launches; and
the median warm wall of WALLS calls. It prints one JSON line a run. The
trees run in the order A B B A in every round (A B C C B A for three), so
that a drift of the card's clock over the call weighs on all. The last
line gives, for each measurement, the median of the runs by tree, each
later tree's over the first's, and the card's name and power limit
(schur_ab.main runs the trees).
"""
from __future__ import annotations

import sys

import schur_ab

REPS, WALLS = 20, 3
B, INNER, ROW_N, LEG_N, LEG_M = 1024, 32, 4096, 4096, 1024
#: route name -> (storage dtype, acc_dtype) by torch attribute names
ROUTES = {"f64": ("float64", None), "f32": ("float32", None),
          "f32_f64": ("float32", "float64"), "bf16_f32": ("bfloat16", "float32"),
          "f16_f32": ("float16", "float32"), "bf16_f64": ("bfloat16", "float64"),
          "f16_f64": ("float16", "float64"), "bf16": ("bfloat16", None),
          "f16": ("float16", None)}
#: trisolve leg -> (upper, transpose_t), as chip_smoke.py's TRISOLVE_LEGS
LEGS = {"l": (False, False), "u": (True, False), "ut": (True, True),
        "lt": (False, True)}


def child(src: str, seed: int) -> dict:
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, src)
    import repro_torch
    from repro_torch.kernels import build, ops, ref

    if hasattr(build, "build"):
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

    def ms_per_call(fn, reps=REPS) -> float:
        events = device_events(fn, reps)
        return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3

    def err(got, want) -> float:
        return float((got.double() - want.double()).abs().max()
                     / want.double().abs().max())

    def host(a):
        return torch.from_numpy(a).to(dev)

    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    lt = np.tril(rng.standard_normal((B, B)), -1) / B + np.eye(B)
    ut = np.triu(rng.standard_normal((B, B))) + B * np.eye(B)
    rhs = rng.standard_normal((B, B))
    dom = rng.standard_normal((B, B)) + B * np.eye(B)
    for route, (st, acc) in ROUTES.items():
        dtype = getattr(torch, st)
        acc_dtype = getattr(torch, acc) if acc else None
        l, u, r, a = (host(x).to(dtype) for x in (lt, ut, rhs, dom))
        tri, right, below = a[:INNER, :INNER], a[:INNER, INNER:], a[INNER:, :INNER]
        cases = {"trsm_lower": ((l, r), (tri, right)),
                 "trsm_upper_right": ((u, r), (tri, below))}
        for kernel, ((t, bb), (st_, sb)) in cases.items():
            fn = getattr(ops, kernel)
            plain = getattr(ref, f"{kernel}_ref")
            try:
                got = fn(t, bb, acc_dtype=acc_dtype)
            except Exception:  # a route this tree does not have
                continue
            out[f"{kernel} {route} 1024^3 err"] = err(got, plain(t, bb, acc_dtype))
            out[f"{kernel} {route} 1024^3"] = ms_per_call(
                lambda: fn(t, bb, acc_dtype=acc_dtype))
            out[f"{kernel} {route} strip"] = ms_per_call(
                lambda: fn(st_, sb, acc_dtype=acc_dtype), 50)
            out[f"{kernel} {route} strip err"] = err(
                fn(st_, sb, acc_dtype=acc_dtype), plain(st_, sb, acc_dtype))
            if acc is None and st in ("float64", "float32"):
                # the call's parts: a leaf's device us, the products' ms
                # a call (REPS calls: a window may lose its first events)
                events = device_events(lambda: fn(t, bb), REPS)
                leaves = [e.time_range.elapsed_us() for e in events
                          if "leaf_kernel" in e.name]
                out[f"{kernel} {route} 1024^3 leaf us"] = (
                    sum(leaves) / max(len(leaves), 1))
                out[f"{kernel} {route} 1024^3 products ms"] = sum(
                    e.time_range.elapsed_us() for e in events
                    if "update_kernel" in e.name) / REPS / 1e3
                lower = kernel == "trsm_lower"
                lib = (lambda: torch.linalg.solve_triangular(
                    t, bb, upper=False, unitriangular=True)) if lower else (
                    lambda: torch.linalg.solve_triangular(t, bb, upper=True,
                                                          left=False))
                slib = (lambda: torch.linalg.solve_triangular(
                    st_, sb, upper=False, unitriangular=True)) if lower else (
                    lambda: torch.linalg.solve_triangular(st_, sb, upper=True,
                                                          left=False))
                out[f"solve_triangular {kernel} {route} 1024^3"] = ms_per_call(lib)
                out[f"solve_triangular {kernel} {route} strip"] = ms_per_call(slib, 50)
    # the pipeline's block-row solve
    lii = host(np.tril(rng.standard_normal((B, B)), -1) / B + np.eye(B))
    row = host(rng.standard_normal((B, ROW_N)))
    out["trsm_lower row_solve"] = ms_per_call(lambda: ops.trsm_lower(lii, row))
    out["solve_triangular row_solve"] = ms_per_call(
        lambda: torch.linalg.solve_triangular(lii, row, upper=False,
                                              unitriangular=True))
    # the trisolve legs (their factors as the LU gives them: L with its
    # stored unit diagonal)
    if hasattr(ops, "trsm_left"):
        lf = host(np.tril(rng.standard_normal((LEG_N, LEG_N)), -1) / LEG_N
                  + np.eye(LEG_N))
        uf = host(np.triu(rng.standard_normal((LEG_N, LEG_N)))
                  + LEG_N * np.eye(LEG_N))
        cols = host(rng.standard_normal((LEG_N, LEG_M)))
        for leg, (upper, trans) in LEGS.items():
            t = uf if upper else lf
            out[f"trsm_left {leg}"] = ms_per_call(
                lambda: ops.trsm_left(t, cols, upper=upper, transpose_t=trans), 10)
            out[f"solve_triangular leg {leg}"] = ms_per_call(
                lambda: torch.linalg.solve_triangular(
                    t.T if trans else t, cols, upper=upper != trans), 10)
    # the single n = 4096, N = 4 inline run
    m = rng.standard_normal((ROW_N, ROW_N)) + ROW_N * np.eye(ROW_N)
    call = lambda: repro_torch.outsource_determinant(m, 4)
    events = device_events(call, 1)
    for part in ("leaf_kernel", "update_kernel"):
        mine = [e for e in events if part in e.name]
        out[f"single {part} ms"] = sum(e.time_range.elapsed_us()
                                       for e in mine) / 1e3
        out[f"single {part} launches"] = len(mine)
    out["single device ms"] = sum(e.time_range.elapsed_us() for e in events) / 1e3
    walls = []
    for _ in range(WALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        assert res.verified
    out["single warm wall s"] = sorted(walls)[len(walls) // 2]
    return out


if __name__ == "__main__":
    sys.exit(schur_ab.main(child, __file__, __doc__))
