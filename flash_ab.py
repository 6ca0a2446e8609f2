#!/usr/bin/env python3
"""Device time of the port's flash attention in two source trees,
alternated, on one NVIDIA GPU.

    python3 flash_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--rounds 2] [--seed 0]

Each tree's run is a process of its own with that tree's `src` on its
path, so two checkouts of `repro_torch` never share one; each builds its
own kernels. A run times, by torch.profiler's device events (the mean
over REPS calls after a warm-up), the kernel at chip_smoke.py's shapes,
each operand a (B, H, S, D) view of a (B, S, H, D) tensor as the model
passes it: in bf16 the four prefill routes, causal q (4, 32, 2048, 64)
over kv (4, 4, 2048, 64) (tinyllama's serving prefill), non-causal
(4, 16, 2048, 80) (hubert), the chunk fold q (2, 40, 8192, 128) over
kv (2, 8, 8192, 128), causal (llama4), and the window q (4, 4, 2048,
256) over one kv head, window 1024 (gemma3), each beside
scaled_dot_product_attention on the same values in the same process
(K and V repeated to the query heads, the window as a boolean band; a
yardstick the port never calls), and the decode, q (4, 32, 1, 64) over
a 2048-key prefix of a 2176-slot cache; in f32 the prefill, the decode
and the window shape. Each case also gives its CUDA launches a call and
its largest error against the plain version (ref.flash_attention_ref)
on the same inputs (for the chunk fold, on one kv group of one chunk).
It prints one JSON line a run. The trees run in the order A B B A in
every round, so that a drift of the card's clock over the call weighs
on both. The last line gives, for each measurement, the median of the
runs by tree and the second tree's over the first's, and the card's
name and power limit (schur_ab.main runs the trees).
"""
from __future__ import annotations

import sys

import schur_ab

REPS = 20
#: (label, dtype, b, hq, hkv, sq, sk, d, cache slots, flash keyword
#: arguments)
CASES = (
    ("bf16 causal", "bfloat16", 4, 32, 4, 2048, 2048, 64, 2048,
     {"causal": True}),
    ("bf16 non-causal d80", "bfloat16", 4, 16, 16, 2048, 2048, 80, 2048,
     {"causal": False}),
    ("bf16 chunk fold", "bfloat16", 2, 40, 8, 8192, 8192, 128, 8192,
     {"causal": True}),
    ("bf16 window d256", "bfloat16", 4, 4, 1, 2048, 2048, 256, 2048,
     {"causal": True, "window": 1024}),
    ("bf16 decode", "bfloat16", 4, 32, 4, 1, 2048, 64, 2176,
     {"causal": True}),
    ("prefill", "float32", 4, 32, 4, 2048, 2048, 64, 2048, {"causal": True}),
    ("decode", "float32", 4, 32, 4, 1, 2048, 64, 2176, {"causal": True}),
    ("window d256", "float32", 4, 4, 1, 2048, 2048, 256, 2048,
     {"causal": True, "window": 1024}),
)


def child(src: str, seed: int) -> dict:
    import numpy as np
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, src)
    from repro_torch.kernels import build, ops, ref

    build.build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    cuda = torch.autograd.DeviceType.CUDA

    def draw(shape, dtype):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(dev, dtype)

    def device_ms(fn) -> tuple[float, float]:
        """(device ms, device events) per call, over REPS calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        return (sum(e.time_range.elapsed_us() for e in events) / REPS / 1e3,
                len(events) / REPS)

    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    for label, dtype, b, hq, hkv, sq, sk, d, slots, kw in CASES:
        dtype = getattr(torch, dtype)
        q = draw((b, sq, hq, d), dtype).transpose(1, 2)
        k, v = (draw((b, slots, hkv, d), dtype)[:, :sk].transpose(1, 2)
                for _ in range(2))
        call = lambda: ops.flash_attention(q, k, v, **kw)
        got = call()
        if label.endswith("chunk fold"):
            g = hq // hkv
            want = ref.flash_attention_ref(q[:1, :g], k[:1, :1], v[:1, :1],
                                           **kw)
            got = got[:1, :g]
        else:
            want = ref.flash_attention_ref(q, k, v, **kw)
        out[f"{label} max_abs_err"] = float((got.float() - want.float())
                                            .abs().max())
        del got, want
        torch.cuda.synchronize()
        out[f"{label} ms"], out[f"{label} launches"] = device_ms(call)
        if dtype == torch.bfloat16 and sq > 1:
            kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
            if "window" in kw:
                i = torch.arange(sq, device=dev)
                band = ((i[None, :] <= i[:, None])
                        & (i[None, :] > i[:, None] - kw["window"]))
                lib = lambda: sdpa(q, kr, vr, attn_mask=band)
            else:
                lib = lambda: sdpa(q, kr, vr, is_causal=kw["causal"])
            out[f"{label} sdpa ms"] = device_ms(lib)[0]
            del kr, vr
        out[f"{label} max_abs_v"] = float(v.float().abs().max())
        del q, k, v
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(schur_ab.main(child, __file__, __doc__))
