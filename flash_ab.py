#!/usr/bin/env python3
"""Device time of the port's f32 flash attention in two source trees,
alternated, on one NVIDIA GPU.

    python3 flash_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--rounds 2] [--seed 0]

Each tree's run is a process of its own with that tree's `src` on its
path, so two checkouts of `repro_torch` never share one; each builds its
own kernels. A run times, by torch.profiler's device events (the mean
over REPS calls after a warm-up), the f32 kernel at chip_smoke.py's
shapes: the serving prefill q (4, 32, 2048, 64) over kv (4, 4, 2048, 64),
causal, as (B, S, H, D) views; its decode, q (4, 32, 1, 64) over a
2048-key prefix of a 2176-slot cache; and gemma3's window shape, q (4, 4,
2048, 256) over one kv head, window 1024. Each case also gives its CUDA
launches a call and its largest error against the plain version
(ref.flash_attention_ref) on the same inputs. It prints one JSON line a
run. The trees run in the order A B B A in every round, so that a drift
of the card's clock over the call weighs on both. The last line gives,
for each measurement, the median of the runs by tree and the second
tree's over the first's, and the card's name and power limit
(schur_ab.main runs the trees).
"""
from __future__ import annotations

import sys

import schur_ab

REPS = 20
#: (label, b, hq, hkv, sq, sk, d, cache slots, flash keyword arguments)
CASES = (
    ("prefill", 4, 32, 4, 2048, 2048, 64, 2048, {"causal": True}),
    ("decode", 4, 32, 4, 1, 2048, 64, 2176, {"causal": True}),
    ("window d256", 4, 4, 1, 2048, 2048, 256, 2048,
     {"causal": True, "window": 1024}),
)


def child(src: str, seed: int) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, src)
    from repro_torch.kernels import build, ops, ref

    build.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    cuda = torch.autograd.DeviceType.CUDA

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    for label, b, hq, hkv, sq, sk, d, slots, kw in CASES:
        q = draw((b, sq, hq, d)).transpose(1, 2)
        k, v = (draw((b, slots, hkv, d))[:, :sk].transpose(1, 2) for _ in range(2))
        call = lambda: ops.flash_attention(q, k, v, **kw)
        got = call()
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        out[f"{label} ms"] = sum(e.time_range.elapsed_us()
                                 for e in events) / REPS / 1e3
        out[f"{label} launches"] = len(events) / REPS
        out[f"{label} max_abs_err"] = float((got - want).abs().max())
        out[f"{label} max_abs_v"] = float(v.abs().max())
        del q, k, v, got, want
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(schur_ab.main(child, __file__, __doc__))
