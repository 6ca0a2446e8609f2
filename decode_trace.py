#!/usr/bin/env python3
"""Where a block of B6's bf16 decode kernel spends its time, on one NVIDIA
GPU: clock64 stamps at the phase boundaries of flash_decode_kernel.

    python3 decode_trace.py [--seed 0]

The committed kernel carries no instrumentation. This script copies
`src` into `.checkout/decode_trace/src` (ignored by git), inserts the
stamps into the copy's csrc/flash_attn.cu at fixed places (it stops if
one is missing, as after an edit of the kernel), builds that library and
runs, twice each and stamping the second run, the decode at
chip_smoke.py's shapes: q (4, 32, 1, 64) over 2048 keys (16 chunks, two
a block of the 8-block cluster), its partial over 1024 keys (a block a
chunk) and gemma3's ring q (4, 4, 1, 256) over 1024 slots (a block a
chunk, D = 256). Block (x, 0, 0) writes its stamps; one JSON line a
case gives, for blocks 0 and 5, the SM clock cycles from the block's
start at which consumer warp 0 and the producer warp reached each
phase: synced (barriers set up), issued0/issued1 (the producer has
issued chunk 0's or 1's copies), q (Q in shared memory), full0/full1
(warp 0's keys of chunk 0 or 1 landed), pv0/pv1 (its S, softmax and
P V done), merged0/merged1 (the four warps' partials in shared memory),
done0/done1 (the chunk's partial or output stored), cluster_wait and
cluster (before and after the cluster barrier) and end. The card's SM
clock and power limit go on the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
COPY = ROOT / ".checkout" / "decode_trace"
#: phase names by stamp slot, of a consumer warp and of the producer
CONSUMER = {0: "start", 1: "synced", 3: "q", 4: "full0", 5: "pv0",
            6: "merged0", 7: "done0", 8: "full1", 9: "pv1", 10: "merged1",
            11: "done1", 12: "cluster_wait", 13: "cluster", 14: "end"}
PRODUCER = {0: "start", 1: "synced", 2: "issued0", 3: "issued1",
            12: "cluster_wait", 13: "cluster", 14: "end"}

STAMP = (
    "__device__ unsigned long long dc_trace[64 * 5 * 16];\n"
    "#define TR(slot) do { if (blockIdx.y == 0 && blockIdx.z == 0 && "
    "threadIdx.x % 32 == 0 && blockIdx.x < 64) "
    "dc_trace[(blockIdx.x * 5 + threadIdx.x / 32) * 16 + (slot)] = "
    "clock64(); } while (0)\n")
#: (text the stamp goes after, the stamp); each text must occur in the
#: decode kernel's part of the source
EDITS = (
    ("  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n",
     "  TR(0);\n"),
    ("  __syncthreads();\n", "  TR(1);\n"),
    ("        } else if (tma != 3) {\n          mbar_arrive(full(st, w));\n"
     "        }\n      }\n", "      if (j < 2) TR(2 + j);\n"),
    ("    consumer_sync(0);\n", "    TR(3);\n"),
    ("      mbar_wait(full(st, warp), (j / STAGES) & 1);\n",
     "      if (j < 2) TR(4 + 4 * j);\n"),
    ("        __syncwarp();\n", "        if (j < 2) TR(5 + 4 * j);\n"),
    ("      consumer_sync(0);\n      // the chunk's partial",
     "      if (j < 2) TR(6 + 4 * j);\n"),
    ("          part[p.d + 1] = lc;\n        }\n      }\n",
     "      if (j < 2) TR(7 + 4 * j);\n"),
    ("  if (!p.partial && p.nchunks > 1) {\n", "    TR(12);\n"),
    ("    cluster_sync();\n", "    TR(13);\n"),
)


def instrument(src: str) -> str:
    """The source with the stamps in flash_decode_kernel and an entry
    point, dc_trace_read, that copies them to the host."""
    start = src.index("flash_decode_kernel(const __grid_constant__")
    head = src.rindex("template <typename T, int DT>", 0, start)
    end = src.index("\n}\n", src.index("merge_row<T, 1>(", start))
    body = src[head:end]
    for after, stamp in EDITS:
        at = body.find(after)
        if at < 0:
            sys.exit(f"decode_trace: {after!r} is not in the decode kernel")
        # "merged" goes after the barrier, before the comment that names it
        if after.startswith("      consumer_sync(0);\n      // the chunk"):
            at += len("      consumer_sync(0);\n")
            body = body[:at] + stamp + body[at:]
            continue
        at += len(after)
        body = body[:at] + stamp + body[at:]
    body += "\n  TR(14);"
    read = ("int dc_trace_read(unsigned long long* host) {\n"
            "  return static_cast<int>(cudaMemcpyFromSymbol(host, dc_trace, "
            "sizeof(dc_trace)));\n}\n\n")
    tail = src[end:].replace("const char* spdc_error_string(int code) {",
                             read + "const char* spdc_error_string(int code) {")
    return src[:head] + STAMP + body + tail


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_trace: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = COPY / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attn.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(COPY / "src"))
    from repro_torch.kernels import build, flash_attn, ops

    signatures = dict(flash_attn._SIGNATURES)
    signatures["dc_trace_read"] = (ctypes.c_int, (ctypes.c_void_p,))
    build.build(("flash_attn",))
    lib = build.library("flash_attn", signatures)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    def draw(*shape):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
        return x.to(dev, torch.bfloat16)

    def stamps(fn) -> np.ndarray:
        fn()
        torch.cuda.synchronize()
        buf = np.zeros(64 * 5 * 16, dtype=np.uint64)
        fn()
        torch.cuda.synchronize()
        lib.dc_trace_read(buf.ctypes.data)
        return buf.reshape(64, 5, 16).astype(np.int64)

    q, k, v = draw(4, 32, 1, 64), draw(4, 4, 2048, 64), draw(4, 4, 2048, 64)
    qr, kr, vr = draw(4, 4, 1, 256), draw(4, 1, 1024, 256), draw(4, 1, 1024, 256)
    cases = {
        "decode 2048": lambda: ops.flash_attention(q, k, v),
        "partial 1024": lambda: ops.flash_decode_partial(
            q, k[:, :, :1024], v[:, :, :1024]),
        "ring 1024 d256": lambda: ops.flash_attention(qr, kr, vr),
    }
    for label, fn in cases.items():
        t = stamps(fn)
        out = {"case": label}
        for x in (0, 5):
            base = t[x, 0, 0]
            for w, role, names in ((0, "consumer0", CONSUMER),
                                   (4, "producer", PRODUCER)):
                # a slot this run did not reach keeps the previous run's
                # stamp, far off this block's start
                out[f"block{x} {role}"] = {
                    name: int(t[x, w, s] - base) for s, name in names.items()
                    if t[x, w, s] and abs(int(t[x, w, s] - base)) < 10**6}
        print(json.dumps(out), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": card.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
