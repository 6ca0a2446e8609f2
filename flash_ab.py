#!/usr/bin/env python3
"""Device time of the port's flash attention in two source trees,
alternated, on one NVIDIA GPU.

    python3 flash_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--rounds 2] [--seed 0]

Each tree's run is a process of its own with that tree's `src` on its
path, so two checkouts of `repro_torch` never share one; each builds its
own kernels. A run times, by torch.profiler's device events (the mean
over REPS calls after a warm-up, the events kept by their launches'
correlation ids), the kernel at chip_smoke.py's shapes,
each operand a (B, H, S, D) view of a (B, S, H, D) tensor as the model
passes it: in bf16 the four prefill routes, causal q (4, 32, 2048, 64)
over kv (4, 4, 2048, 64) (tinyllama's serving prefill), non-causal
(4, 16, 2048, 80) (hubert), the chunk fold q (2, 40, 8192, 128) over
kv (2, 8, 8192, 128), causal (llama4), and the window q (4, 4, 2048,
256) over one kv head, window 1024 (gemma3), each beside
scaled_dot_product_attention on the same values in the same process
(K and V repeated to the query heads, the window as a boolean band; a
yardstick the port never calls), and the decodes: q (4, 32, 1, 64)
over a 2048-key prefix of a 2176-slot cache in bf16 and f16 and over
8192 keys in bf16, gemma3's ring decode q (4, 4, 1, 256) over a full
1024-slot ring in bf16, each beside SDPA (no mask, since one row sees
every key: GQA by enable_gqa=True, the ring's K and V repeated), and
the split decode's halves in bf16, the partial over the first 1024 of
the 2048 keys (8 chunks) and the merge of both halves' 16 chunks; in
f32 the prefill, the decode and the window shape. Each case also gives
its CUDA launches a call, its largest error against the plain version
(ref.flash_attention_ref, the partial's and merge's own plain versions)
on the same inputs (for the chunk fold, on one kv group of one chunk),
and the host µs a wrapper call takes to return (the median of
HOST_CALLS calls timed one by one). Then the backward of
ops.flash_attention under autograd at tinyllama's training shape, q (4,
32, 2048, 64) over kv (4, 4, 2048, 64), causal, in bf16 and f32: in a
tree with B6's gradient kernels their three launches, in one without,
autograd through the plain version; beside SDPA's backward (K and V
repeated), with its launches and its largest error against the plain
autograd over each gradient's max|g|. Each child builds csrc/flash_attn.cu
alone. It prints one JSON line a run. The trees run in the order A B B A in
every round, so that a drift of the card's clock over the call weighs
on both. The last line gives, for each measurement, the median of the
runs by tree and the second tree's over the first's, and the card's
name and power limit (schur_ab.main runs the trees).
"""
from __future__ import annotations

import re
import statistics
import sys
import time

import schur_ab

REPS = 20
HOST_CALLS = 100
#: B6's backward under autograd at tinyllama's training shape: (label,
#: dtype)
BACKWARD_CASES = (("bf16 causal backward", "bfloat16"),
                  ("f32 causal backward", "float32"))
#: (label, dtype, b, hq, hkv, sq, sk, d, cache slots, flash keyword
#: arguments); "partial" and "combine" label the split decode's halves
#: over the first half and both halves of the keys
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
    ("f16 decode", "float16", 4, 32, 4, 1, 2048, 64, 2176, {"causal": True}),
    ("bf16 decode 8192", "bfloat16", 4, 32, 4, 1, 8192, 64, 8192,
     {"causal": True}),
    ("bf16 ring decode", "bfloat16", 4, 4, 1, 1, 1024, 256, 1024,
     {"causal": True}),
    ("bf16 partial", "bfloat16", 4, 32, 4, 1, 2048, 64, 2176, {}),
    ("bf16 combine", "bfloat16", 4, 32, 4, 1, 2048, 64, 2176, {}),
    ("prefill", "float32", 4, 32, 4, 2048, 2048, 64, 2048, {"causal": True}),
    ("decode", "float32", 4, 32, 4, 1, 2048, 64, 2176, {"causal": True}),
    ("window d256", "float32", 4, 4, 1, 2048, 2048, 256, 2048,
     {"causal": True, "window": 1024}),
)


def child(src: str, seed: int) -> dict:
    import numpy as np
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, src)
    from repro_torch.kernels import build, flash_grad, ops, ref

    build.build(("flash_attn",))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    cuda = torch.autograd.DeviceType.CUDA

    def draw(shape, dtype):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(dev, dtype)

    def device_ms(fn) -> tuple[float, float]:
        """(device ms, device events) per call, over REPS calls. Started
        cold, the profiler can miss a window's first launches, so the
        window opens with 64 one-element fills, and only the device events
        of launches made inside the timed range count (matched by their
        correlation ids); a window that lost the event of a launch it
        recorded is profiled again, up to three windows."""
        pad = torch.empty(1, device=dev)
        for _ in range(3):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(64):
                    pad.fill_(0.0)
                torch.cuda.synchronize()
                with record_function("timed"):
                    for _ in range(REPS):
                        fn()
                    torch.cuda.synchronize()
            host = [e for e in prof.events() if e.device_type != cuda]
            opened = min(e.time_range.start for e in host
                         if e.name == "timed")
            launched = {e.id for e in host
                        if re.match(r"cu(da)?(Launch|Memcpy|Memset)", e.name)
                        and e.time_range.start >= opened}
            events = [e for e in prof.events() if e.device_type == cuda
                      and e.name != "timed" and e.id in launched]
            if len({e.id for e in events}) == len(launched):
                break
        return (sum(e.time_range.elapsed_us() for e in events) / REPS / 1e3,
                len(events) / REPS)

    def host_us(fn) -> float:
        """Host µs a call takes to return: the median of HOST_CALLS calls
        timed one by one, back to back (the card's queue never fills)."""
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(HOST_CALLS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return statistics.median(times) * 1e6

    out = {"src": src, "card": torch.cuda.get_device_name(0)}
    for label, dtype, b, hq, hkv, sq, sk, d, slots, kw in CASES:
        dtype = getattr(torch, dtype)
        q = draw((b, sq, hq, d), dtype).transpose(1, 2)
        k, v = (draw((b, slots, hkv, d), dtype)[:, :sk].transpose(1, 2)
                for _ in range(2))
        half = sk // 2
        if label.endswith("partial"):
            kh, vh = k[:, :, :half], v[:, :, :half]
            call = lambda: ops.flash_decode_partial(q, kh, vh)
            want_fn = lambda: ref.flash_decode_partial_ref(
                q, kh, vh, chunks=-(-half // 128))
        elif label.endswith("combine"):
            part = torch.cat([ops.flash_decode_partial(
                q, k[:, :, lo:lo + half], v[:, :, lo:lo + half])
                for lo in (0, half)])
            call = lambda: ops.flash_combine(part, dtype)
            want_fn = lambda: ref.flash_combine_ref(part, dtype)
        else:
            call = lambda: ops.flash_attention(q, k, v, **kw)
            want_fn = lambda: ref.flash_attention_ref(q, k, v, **kw)
        got = call()
        if label.endswith("chunk fold"):
            g = hq // hkv
            want = ref.flash_attention_ref(q[:1, :g], k[:1, :1], v[:1, :1],
                                           **kw)
            got = got[:1, :g]
        else:
            want = want_fn()
        out[f"{label} max_abs_err"] = float((got.float() - want.float())
                                            .abs().max())
        del got, want
        torch.cuda.synchronize()
        out[f"{label} ms"], out[f"{label} launches"] = device_ms(call)
        out[f"{label} host_us"] = host_us(call)
        if dtype != torch.float32 and "partial" not in label \
                and "combine" not in label:
            if sq == 1 and "ring" not in label:
                lib = lambda: sdpa(q, k, v, enable_gqa=True)
            else:
                kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
                if "window" in kw:
                    i = torch.arange(sq, device=dev)
                    band = ((i[None, :] <= i[:, None])
                            & (i[None, :] > i[:, None] - kw["window"]))
                    lib = lambda: sdpa(q, kr, vr, attn_mask=band)
                else:
                    lib = lambda: sdpa(q, kr, vr, is_causal=sq > 1 and kw["causal"])
            out[f"{label} sdpa ms"] = device_ms(lib)[0]
        out[f"{label} max_abs_v"] = float(v.float().abs().max())
        del q, k, v
        torch.cuda.empty_cache()
    for label, dtype in BACKWARD_CASES:
        dtype = getattr(torch, dtype)
        b, hq, hkv, s, d = 4, 32, 4, 2048, 64
        q, k, v = (draw((b, s, h, d), dtype).transpose(1, 2).detach()
                   .requires_grad_() for h in (hq, hkv, hkv))
        g = draw((b, s, hq, d), dtype).transpose(1, 2)
        o = ops.flash_attention(q, k, v, causal=True)
        call = lambda: torch.autograd.grad(o, (q, k, v), g, retain_graph=True)
        want = flash_grad.flash_attention_backward(q, k, v, g, True)
        out[f"{label} max_err_of_max"] = max(
            float((a.float() - c.float()).abs().max() / c.float().abs().max())
            for a, c in zip(call(), want))
        del want
        out[f"{label} ms"], out[f"{label} launches"] = device_ms(call)
        kr, vr = (t.detach().repeat_interleave(hq // hkv, dim=1).requires_grad_()
                  for t in (k, v))
        lib_o = sdpa(q, kr, vr, is_causal=True)
        out[f"{label} sdpa ms"] = device_ms(lambda: torch.autograd.grad(
            lib_o, (q, kr, vr), g, retain_graph=True))[0]
        del q, k, v, g, o, kr, vr, lib_o
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(schur_ab.main(child, __file__, __doc__))
