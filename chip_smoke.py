#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printed as one JSON line:

1. build the port's CUDA kernels from src/repro_torch/kernels/csrc;
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (CED bit for bit; the LU panel and the
   triangular solves within 1e-12 of max|plain|: the same arithmetic
   with another FMA contraction and summation order; a stack's last
   panel tile bit-equal to the same tile alone);
3. `outsource_determinant` on one n = 4096 float64 matrix over N = 4
   servers (q3, then q1 and q2), checked against torch.linalg.slogdet,
   with Q3's cost on its factors (compensated against a working-precision
   sum, `q3_cost`);
4. a (16, 1024, 1024) float64 stack;
5. n = 4094, which the border pads to 4096;
6. tampered runs: q3 must reject the tampered matrix and only it;
7. the Schur kernel against its plain version: 1024³, strided blocks of a
   4096² matrix and a (16, 256, 256, 256) stack, in f64, f32, bf16 and
   f16: f64 and f32 within tol · (max|C| + K·max|A|·max|B|), tol 1e-12 /
   1e-4, bf16 and f16 within 2e-2 · max|plain|;
8. sequential: `lu_blocked(x, 1024)` on a 4096² f64 matrix against
   `lu_nserver(x, 4)` (rtol 1e-10) and `torch.linalg.slogdet`, with its
   launch counts (the Schur kernel on the trailing updates and on the
   diagonal tiles' inner updates) and both warm wall times;
9. role split, n = 4096, N = 4: `Session.tasks()` through the wire, a
   manual relay through `EdgeServer`s, `collect`, then the thread pool —
   factors bit-equal to the inline sweep's, launches equal to its
   launches; then a 16 × 1024 stack through the thread pool;
10. worker processes (`MultiprocessTransport`) on the card, n = 1024,
   N = 4: verified, factors bit-equal to the inline sweep's, the spawn
   and first sweep timed apart from a warm run;
11. faults: a block tamper by server 1 through the thread pool (q3) and
   an in-band single-element tamper by server 2 in the inline sweep (q1,
   sized from ε) must be rejected with the right culprit; the in-band
   tamper at its default magnitude, under q3 and q1, must get the verdict
   and culprit the JAX reference gives on the same matrix
   (reference_fault_witness.py, WITNESS_REFERENCE);
12. the flash-attention kernel against its plain version: the serving
   path's prefill, q (4, 32, 2048, 64) and kv (4, 4, 2048, 64) as
   (B, S, H, D) views, causal, and its decode, q (4, 32, 1, 64) over a
   2048-long cache prefix, in bf16 and f32 (decode packs each GQA group
   into a block and splits the keys into chunks; in bf16 one launch,
   whose thread block cluster merges the chunks, in f32 a second launch
   merges them),
   decode with a 40-key window inside the last chunk in both, gemma3's
   sliding prefill (q (4, 4, 2048, 256), window 1024) in f32, then small
   window, non-causal, ragged (50 / 77) and fully-masked (Sq > Sk) cases:
   within
   1e-5 · max|v| in f32, and in bf16 every element within
   2 eps |want| + eps/8 · max|v| and the whole within eps of ||want||
   (FLASH_TOL says why); then the split decode's halves (decode under a
   mesh) on the 2048-key decode case in bf16 and f32 (SPLIT_CUTS): the
   decode partial over each of M = 2 and M = 4 key ranges and the merge
   of their chunks, bit-equal to the unsplit decode where every range
   starts on a multiple of the 128-key chunk, and within FLASH_TOL of
   the plain version on ragged ranges and with one empty range;
13. serve: tinyllama-1.1b at full width and depth in bf16, weights from
   --seed on the card: `build_prefill_step` on 4 × 2048 prompts (finite
   logits, 22 flash launches per call, warm time); 128 decode steps
   against the prefill of the same 128 tokens in bf16 and in f32
   (SERVE_TOL); the f32 card prefill (B = 1, S = 64) against the CPU's
   plain prefill with the same weights; `greedy_generate` at the
   launcher's defaults (4 × 16 prompts, 32 new tokens), the path's own
   run, whose launches the kernels line reports; one warm prefill under
   torch.profiler. Then each other model family at full width in bf16
   (SERVE_MODELS: gemma3-1b, granite-moe-1b-a400m, mamba2-370m, llama4
   at 4 layers, qwen2-vl at 2 layers, hubert-xlarge), counts set to 0
   before each: prefill of 4 × 2048 (llama4: 1 × 16384, two chunks
   folded into the batch) with a flash launch per attention layer, one
   profiled; decode against prefill in bf16 and in f32 (local windows
   cut to F32_WINDOW, so gemma3's rings wrap), on the dense MoE; the
   f32 card prefill against the CPU's; greedy generation for the token decoders; the flash launches
   by route (FlashRoutes), and the kernel against its plain version at
   the families' shapes (models_vs_plain).

14. train, from a seventh random stream, within TRAIN_BUDGET_S: the flash
   kernel under autograd at tinyllama's prefill shape (q (4, 32, 2048, 64),
   kv (4, 4, 2048, 64), causal) in bf16 and f32, its forward within
   FLASH_TOL of the plain version and dq, dk, dv from the gradient
   kernels (csrc/flash_bwd.cu) within GRAD_ULPS's rule of autograd
   through the plain version and bit-equal from call to call, with the
   forward's device ms, the gradient kernels' by kernel, the plain
   backward's and SDPA's backward's; the same checks at small shapes on
   every route (GRAD_ROUTES: gemma3's window at D = 256, hubert's
   non-causal D = 80, causal D = 128 as llama4's chunk fold runs it,
   Sq < Sk, fully masked rows with Sq > Sk, a grad whose rows start off
   16 bytes, Sq <= 16) in bf16 and f32; tinyllama at full width with 2 layers in f32,
   batch 2 x 256, on the same seeded weights on the card and the CPU: the
   loss, every gradient leaf (none zero, wq/wk/wv included) and the
   parameters after one AdamW step (TRAIN_TOL); tinyllama-1.1b at full
   width and depth in its config's dtypes (bf16, f32 AdamW state, remat
   "nothing"), batch 4 x 2048: every leaf's gradient nonzero and
   finite, then, the counts set to 0, a warm step and 4 timed steps on
   one batch with AdamWConfig(lr=1e-3, warmup_steps=1): each step's
   wall, tokens/s, the loss (it must fall), the grad norm (finite),
   torch.cuda.max_memory_allocated, 44 flash launches a step (22
   forwards, 22 remat recomputes) and 22 calls of the gradient kernels,
   and one step under torch.profiler split into forward, the flash
   kernel, its gradient kernels (3 CUDA launches a call; no plain
   attention backward left), the rest of the backward and the
   optimizer, with the busy share; the
   launcher in process (`repro_torch.launch.train.main`, repro-100m,
   batch 8 x 256, SDC on, a checkpoint every 20 steps) to 40 steps, then
   again to 50, which must resume from step 40, with no SDC rejection
   and the checkpoint writes' walls; the checkpoints are removed.
15. mesh: the launcher in process with --mesh smoke (a process group of
   one rank, mesh (1, 1), repro-100m, batch 8 x 256, MESH_STEPS steps),
   then with --mesh none at the same seed: every parameter a DTensor,
   the flash kernel launched through local_map, the losses equal within
   MESH_RTOL; then the first step's gradient of every parameter both
   ways (none zero), each within MESH_RTOL; the later grad norms and the
   final checkpoint's leaves are read. Then decode under the mesh
   (mesh_decode): tinyllama-1.1b at full width and depth in bf16,
   weights from --seed, caches of 4 rows whose first 512 slots hold k
   and v drawn from --seed, then MESH_DECODE_STEPS greedy steps from
   copies of those caches without rules and, with the
   counts set to 0, under the smoke rules on the (1, 1) mesh (the
   parameters and caches DTensors): equal tokens and bit-equal logits,
   one decode partial and one merge a layer a step, no other flash
   launch.

Then, from a random stream of their own (so the phases above keep their
inputs), the f32 and mixed-precision slice and recovery, before phase 12:

- routes: the mixed routes (the reference's acc_dtype: f32 stored with
  f64 arithmetic, bf16 and f16 with f32 or f64) of the panel, both
  triangular solves and the Schur update, the f32 routes and the narrow
  bf16 and f16 routes (every operation in the half type, no acc_dtype)
  of the panel and the solves, against their plain versions at
  lu_blocked's shapes (MIXED_ULPS, F32_RTOL; the narrow routes bit for
  bit);
- f32 protocol: TF32 off and an f32 matmul within K·2^-24·max|A·B| of
  the f64 product; n = 4096 and a 16 × 1024 stack in float32, inline,
  verified with exact signs and |Δlog|det|| <= 1e-4 against the card's
  f64 slogdet;
- sequential routes: `lu_blocked(x32, 1024)` plain and with
  acc_dtype=float64 at n = 4096: launches, the device kernels' template
  names (f32 and mixed; the Schur update's from its wrapper's table
  `schur.KERNELS`), the Schur kernels' device ms per call, warm wall, and
  the mixed factors nearer the f64 factorization than the plain ones;
  then the same in bf16 and in f16, narrow (no acc_dtype), with
  acc_dtype=float32 and wide (acc_dtype=float64): launches, template
  names, Schur device ms, and the wide route's normwise residual and
  distance from the f64 factors below the narrow route's (the float32
  route's are read, not gated);
- recovery: n = 4096 f64, N = 4, standby 1: server 2's block tamper
  healed inline (factors bit-equal to the honest run's), through the
  thread pool and through worker processes (n = 1024, on phase 10's
  workers), server 2's in-band single-element tamper of 1e-3·max|U|
  healed inline under q1 (bit-equal again), and a 16 × 1024 f32 stack
  with one matrix's strip dropped, only that matrix spliced; each healed
  determinant equal to the honest one at rtol 1e-10, collect_s beside
  the honest dispatch_s.

Then, from a sixth random stream, the pipeline phase (distributed=True:
the shardmap transport, N = 4 server slots on the card, each computing
on a CUDA stream of its own, the relay a device copy a hop), within
PIPELINE_BUDGET_S:

- n = 4096 f64 through the protocol: verified, with the inline run's
  verdict and its determinant at rtol 1e-10 (and slogdet's gate), the
  launches of each kernel at expected_pipeline_launches;
- each relay program (baseline, exact, stream) on the session's
  ciphertext: Authenticate (q3) accepts its factors, their determinant
  within the gate of slogdet, its launches, warm wall beside the inline
  sweep's, and one sweep under torch.profiler: the relay's device copies
  equal to the mesh's hop log in count and bytes, each on its
  receiver's stream, no device copy but the relay's and the scatter of
  X's block rows, each slot's kernels on one stream of its own, the
  hops' device ms and the card's busy share; on the plaintext, whose LU
  has no growth, its factors within 1e-10 of max|F| of the inline
  sweep's;
- a 16 x 1024 stack (baseline), n = 4096 in f32 within 1e-4 of the f64
  slogdet, and server 2's dropout healed (recover=True, standby 1);
- the panel and both solves against their plain versions on every
  operand shape the single and the stack runs gave them (1e-12 of
  max|plain|), the block-row solve 1024² against 1024 x 4096 among them.

Then, from a third random stream, the socket and rateless phases, on four
port WorkerDaemons spawned (never forked, after this process built the
kernels) on Unix sockets, each computing on the card and serving any
worker id:

- socket: n = 4096 f64, N = 4, q3 through `SocketTransport(addresses)`:
  verified, factors bit-equal to the inline sweep's, the determinant
  equal to the inline one, no server kernel launched in this process;
  the daemons' spawn and the first sweep timed apart from a warm run by
  a second SocketTransport, whose HELLO counters (connections,
  frames_served) show the same daemons served both; per task the frame
  sizes and the daemon round trip beside the same task run in process;
- rateless on the same daemons: n = 4096 f64 with RatelessConfig() (F = 8
  strips of 512 rows) bit-equal to `lu_nserver(x_aug, 8)` on the card with
  no strip computed inline, the strips each worker served; a 16 x 1024
  stack in four lanes; the reference's acceptance case on a 5 x 1024
  stack (worker 1 a Pareto straggler, worker 2 a block tamperer):
  verified, determinants equal to the honest run's at rtol 1e-10, the
  streamed factors passing Q2 and Q3, worker 2 quarantined, worker 1
  serving fewer strips than each healthy worker.

Then, from a fifth random stream, the gateway phase (on the same
daemons; the GATEWAY_* sizes), within GATEWAY_BUDGET_S:

- a saturating swarm of 384 requests, n drawn from (200, 480, 1000) (the
  buckets 256, 512 and 1024), 8 of them submitted again in the swarm
  (single flight), then the 8 latest-served matrices again (cache hits:
  the LRU keeps the 256 latest) and one n = 1500 request served
  direct, through AsyncSPDCGateway(SPDC_GATEWAY_DEFAULT: N = 4,
  max_batch 32, inline) on the card: every request verified with no
  error, every determinant within rtol 1e-10 of torch.linalg.slogdet in
  f64 (the sign exact), the 1024 bucket's first flush held against each
  matrix's own outsource_determinant (Determinant.allclose); sustained
  dets/s, p50/p99 latency, flushes by reason, cache hits, coalesced
  requests and breaker opens;
- one full 32 x 1024 flush (n = 1000, cache off): its wall, the same
  stack's SessionTimings split, SeedGen's and KeyGen's share of the
  PMOP, the boundary screen's time, the launches of each kernel (32 CED,
  the panel and both TRSMs), the card's busy share under torch.profiler
  and no library trsm/getrf/getrs kernel; then a 17-request flush padded
  to 32 against the same flush unpadded (what the dummies cost);
- an f32 bucket, a solve bucket (relative residual under 1e-10), the
  hardened gateway with server 2 tampering in the 512 bucket (healed
  alone; the 256 bucket's determinants bit-equal to an honest run's),
  the breaker opening on a poisoned bucket while another bucket serves,
  one SPDC_GATEWAY_SOCKET flush on the daemons bit-equal to inline, one
  rateless flush (SPDC_EDGE_RATELESS, F = 8) on the daemons bit-equal to
  lu_nserver(x_aug, 8) of the same stack, and one SPDC_GATEWAY_BULK
  flush of 128 x 1024 (dets/s);
- each kernel of the flushes against its plain version at the shapes
  they gave it: CED on one swarm request of each size and the direct
  one, with its own blinding vector and rotation (bit-equal); the panel
  tiles (32, 32, 32), the panel's strips (32, 32, 224) and (32, 224, 32)
  and the outer strips (32, 256, 256), cut from the full flush's stack
  (1e-12 of max|plain|);
- `python -m repro_torch.launch.serve_spdc --smoke --device cuda` as a
  subprocess, which must exit 0 and print its check line.

Then, from a fourth random stream, the linalg phase (on the same
daemons before they stop): a `LinalgSession` on one n = 4096 f64
dominant matrix over N = 4, inline, its slogdet, solve (b of 4096 x 8),
adjoint solve and inverse against torch.linalg at the reference tests'
1e-9, with one factorization, every op verified and each round's
residual under its tolerance; each trisolve leg launched (24 wrapper
calls over the three rounds); the inverse round under torch.profiler:
8 wrapper calls of 2⌈4096/128⌉ − 1 = 63 CUDA launches each and no trsm
kernel of a library; its four chunks bit-equal to one wide call of the
same legs; server 1's block tamper of its strip and its chunk healed,
the inverse bit-equal to the honest one; the inverse through the thread
pool and through the daemons bit-equal to inline; `outsource_inverse`
verified under its eps; a 1024² f32 session's inverse within 2e-3 of
max|inverse| of the card's f64 one; the GP objective of
examples/gp_loglik.py at n = 4096 (value at rtol 1e-9 and gradient
within 1e-6 of max|grad| against torch autograd, one factorization).

The daemons' kernel launches happen in their processes and are not
counted here; bit-equality with the inline sweep shows they ran the
kernels' arithmetic on the card. The client's CED launch is counted.

The kernels line then has a row per route besides the default f64 rows:
"trsm:trisolve_<leg>" (the linalg phase's four left solves, l, u, ut
and lt, at its inverse round's chunk shape on its factors, launches from
its op plan), "trsm_lower:row_solve" (the pipeline's block-row solve on
the operands the pipeline phase gave it, launches from its single run), "<kernel>:f32" (the f32 routes the f32 paths run), "<kernel>:f32_f64",
:bf16_f32", ":f16_f32", ":bf16_f64" and ":f16_f64" (the mixed routes
mixed and half lu_blocked run; bf16/f16 -> f32 is the Schur update's
default half route, launches from lu_blocked with acc_dtype=float32),
"<kernel>:bf16" and ":f16" (the panel's and the solves' narrow routes,
which half lu_blocked runs), each with the device kernels' template
names the profiler reports, "flash_attention:f32" (the f32 kernel at
the prefill and decode shapes, launched by phase 13's f32 runs; the
flash_attention row also carries phase 14's launches, `launches_train`,
and its autograd case), "flash_attention_backward" and ":f32" (B6's
gradient kernels at the training shape on the forward kernel's output
and lse, beside their plain version and SDPA's backward, each kernel's
device ms in kernels_ms, launches from phase 14: tinyllama's steps in
bf16, the card-against-CPU step in f32) and "flash_attention:f32_sliding" (the f32
kernel's D = 256 configuration at gemma3's window shape; its launches
are the f32 route's on phase 13, no run of which has that shape), then
"flash_attention:sliding", ":ring_decode", ":chunk_fold" and
":non_causal" at the model families' shapes, with the launches of
each route over phase 13's family runs (each bf16 prefill row, and the
flash_attention row, names its device kernel by the profiler,
device_kernels, and the run fails unless that is flash_wgmma_kernel
alone; the bf16 decode rows, the flash_attention row's decode_case,
":ring_decode" and ":decode_partial", likewise hold their one launch
to flash_decode_kernel alone), and "flash_attention:decode_partial"
and ":combine" (the split decode's halves at half the bf16 decode case's
keys and at both halves' chunks, launches from phase 15's decode under
the mesh; the merge's device kernel is flash_combine_kernel). Each timing names the
profiler windows it took (profile_windows); the run line counts the
timings that needed more than one and names their rows, counts the
windows that lost a device event (each profiled again), and gives the
least and largest time from a launch on the host to its event's start
on the card (device_events keeps the events by their launches'
correlation ids, so the card clock's offset shows there and moves no
event out of a window).

Each phase is driven with the launch counts set to 0 just before it and
read just after, and fails if a kernel of its path never launched. Then
it prints the whole run's wall time and the kernels line (launches on
phase 3 — the Schur kernel's on phase 8, flash attention's on phase 13
and, as launches_train, on phase 14's timed steps —
error from phases 2, 7 and 12 and the gateway's, time per launch
beside the plain version, the library call where one computes the same function, and the
least time the card could take; the CUDA launches one wrapper call
made, counted from the profiler's device events and, for the panel, the
triangular solves, the Schur update and flash attention, checked against
the wrappers' own formulas; the panel loop's 32 x 992 strips as the trsm
rows' strip_case, with the strip calls counted on phase 3, which the
inner_strip_times line prints first; the batch phase's (16, 32, 32)
panel stack as the lu_panel row's batch_case; lu_blocked's K = 32 inner
update, 992 x 32 x 992, as the Schur row's inner_case), the card's name
and power limit, and
last {"ok": true, "device": {...}}. All inputs come from --seed through
numpy. Any failed check raises, so the script exits non-zero and prints
no last line; it does so too without a CUDA device or without the
repository.
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
from typing import NamedTuple

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"
N_SERVERS = 4
SINGLE_N = 4096
BATCH, BATCH_N = 16, 1024
PADDED_N = 4094
INNER = 32
RTOL = 1e-12
SEQ_BLOCK = 1024
#: Schur kernel tolerance by dtype: f64 and f32 on the scale
#: max|C| + K·max|A|·max|B| of the K products both sides sum in different
#: orders; bf16 and f16 on max|plain|, because both sides sum in f32 and
#: differ by the stored output's rounding
SCHUR_TOL = {torch.float64: 1e-12, torch.float32: 1e-4, torch.bfloat16: 2e-2,
             torch.float16: 2e-2}
#: the kernels each path launches in this process
CLIENT_PATH = ("ced",)
SERVER_PATH = ("lu_panel", "trsm_lower", "trsm_upper_right")
MAIN_PATH = CLIENT_PATH + SERVER_PATH
SEQUENTIAL_PATH = SERVER_PATH + ("schur_update",)
SERVE_PATH = ("flash_attention",)
TRAIN_PATH = ("flash_attention", "flash_attention_backward")
#: decode under a mesh: B6's split decode, its two halves apart
MESH_DECODE_PATH = ("flash_decode_partial", "flash_combine")
#: the faults phase's witness case: witness_matrix(WITNESS_SEED, 4096)
#: over N = 4 with server 2's in-band single tamper at its default
#: magnitude, and per method the JAX reference's (verified, culprit) and
#: ciphertext digest on it, from `reference_fault_witness.py` on the CPU
WITNESS_SEED = 0
WITNESS_REFERENCE = {"q3": (True, -1), "q1": (True, -1)}
WITNESS_X_AUG_SHA256 = (
    "25a2211c34be8f432df7a5980931f47993e3b3c2d3d82f0cb56ab52930e29589")
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s and the
#: f64 (tensor core), f32 and bf16/f16 (tensor core, dense) operation rates
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float64: 67e12, torch.float32: 67e12,
              torch.bfloat16: 989e12, torch.float16: 989e12}
#: flash attention against its plain version. Both sides accumulate in
#: f32; they differ in summation order, in P where it is rounded to V's
#: dtype (the kernel rounds exp(s - m) against the running max of each key
#: tile, the plain version against the row's final max) and in the output's
#: rounding. f32: max|err| <= 1e-5 * max|v|. bf16, with eps its machine
#: epsilon 2^-7: every element within 2 eps |want| (two ulps of the
#: output's rounding) + eps/8 * max|v| (P's rounding), and
#: ||err|| <= eps ||want|| over the whole output, so an error in a large
#: share of the outputs fails even where each is small. On the card the
#: bf16 prefill read max|err| 0.0039, one ulp of an output in [0.5, 1).
FLASH_TOL = {torch.float32: 1e-5}
#: B6's gradient (csrc/flash_bwd.cu) against autograd through the plain
#: forward, leaf by leaf. f32: max|err| <= 1e-5 * max|g| (summation order,
#: exp2 of base-2 scores against exp, the lse's rounding). bf16/f16, eps
#: the machine epsilon: every element within GRAD_ULPS eps max|g| and
#: ||err|| <= eps ||want|| over the leaf. Each side rounds its output once
#: (eps/2 |g| each: one eps of max|g| together); the kernels round the
#: normalised P to T before dV = P^T dO, where the plain version rounds
#: the unnormalised exp(s - max), and dS to T before dQ and dK, where the
#: plain version's autograd keeps it in f32: u = eps/2 relative a term of
#: each f32 sum, about u ||want|| normwise. The plain version of the
#: kernels (ref.flash_attention_backward_ref) against the oracle read
#: at most 0.97 eps max|g| elementwise and 0.57 eps normwise on the CPU's
#: test shapes.
GRAD_ULPS = 2
#: the serving path: the reference launcher's default model, the prefill
#: batch, the decode-against-prefill length and the launcher's defaults
SERVE_ARCH = "tinyllama-1.1b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
#: tinyllama-1.1b's query heads, kv heads and head dimension
FLASH_HEADS = (32, 4, 64)
CONSISTENCY_LEN = 128
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 16, 32
CPU_CHECK_LEN = 64
#: last logits of two computations, on max|logits|. decode vs prefill in
#: bf16: activations are rounded to 8 bits after every operation, and the
#: two reach cuBLAS at other shapes (4 rows against 512), so they round
#: differently and the difference passes through 22 residual layers; in
#: f32 only summation order differs, so the bound is tight; the card's f32
#: prefill against the CPU's plain one: summation order again
SERVE_TOL = {"decode_vs_prefill_bf16": 5e-2, "decode_vs_prefill_f32": 1e-4,
             "card_vs_cpu_f32": 1e-4}
#: the bf16 decode-against-prefill bound of an arch whose depth and mixer
#: take bf16's rounding past SERVE_TOL's: mamba2-370m's 48 SSD layers,
#: whose chunked prefill rounds each layer's output to bf16 once more
#: than the decode's recurrence (the reference's _ssd_chunked returns
#: its input's dtype). The reference's own gap at full width is 0.0572,
#: the port's 0.0593 on the same weights, the two packages' bf16 prefills
#: 0.0551 apart (reference_serve_gap.py, CPU, 4 × 128 tokens)
SERVE_TOL_BF16 = {"mamba2-370m": 1e-1}
#: the model families the serve phase runs beside SERVE_ARCH, at full
#: width, with their depth cut (None: full depth): qwen2-vl's 80 layers
#: of width 8192 (72B parameters) and llama4's 48 (109B) do not fit the
#: card, so they run a few layers
SERVE_MODELS = (("gemma3-1b", None), ("granite-moe-1b-a400m", None),
                ("mamba2-370m", None), ("llama4-scout-17b-a16e", 4),
                ("qwen2-vl-72b", 2), ("hubert-xlarge", None))
#: the window the decode against prefill in bf16 and f32 (CONSISTENCY_LEN
#: tokens) and the card-against-CPU prefill (CPU_CHECK_LEN tokens) cut
#: local layers to, so that each runs the local prefill and wraps the
#: rings (gemma3 at its own 1024-token window needed 1088 decode steps,
#: about 70 s of the run; the ring decode at 1024 slots is the kernels
#: line's ring_decode row); llama4's 8192-token chunks are cut the same
F32_WINDOW, CPU_WINDOW = 64, 16
#: a prefill of one row past llama4's 8192-token chunk: two chunks,
#: folded into the batch
CHUNK_PREFILL = (1, 16384)
#: the card-against-CPU check copies the f32 model to the host: models
#: above this many parameters skip it (llama4's 4 layers hold 10.4B)
CPU_CHECK_MAX_PARAMS = 2e9
#: the train phase. The card-against-CPU step: tinyllama at full width
#: with TRAIN_CPU_LAYERS layers in f32, batch TRAIN_CPU_SHAPE, and its
#: bars: the loss relative, each gradient leaf on its own max|g|, and the
#: parameters after one AdamW step absolute. Summation order alone
#: differs, so loss and gradients sit near f32 rounding; the step moves
#: a parameter by lr·m̂/(√v̂ + eps), ≈ ±lr₁ at step 1 for ANY gradient
#: above eps, so an element whose gradient is rounding noise may move
#: the other way on the other device: AdamWConfig()'s lr₁ = 3e-4/100
#: bounds that at 6e-6. The full model: batch TRAIN_SHAPE, a warm step
#: and TRAIN_STEPS timed ones. The launcher: TRAIN_LAUNCH to each of
#: TRAIN_LAUNCH_STEPS (the second resumes from the first's checkpoint).
TRAIN_CPU_LAYERS, TRAIN_CPU_SHAPE = 2, (2, 256)
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "params": 1e-5}
TRAIN_SHAPE, TRAIN_STEPS = (4, 2048), 4
TRAIN_LAUNCH = ["--arch", "repro-100m", "--batch", "8", "--seq", "256",
                "--ckpt-every", "20", "--sdc"]
TRAIN_LAUNCH_STEPS = (40, 50)
TRAIN_BUDGET_S = 150.0


#: the mixed routes (the reference's acc_dtype): (route, storage type,
#: arithmetic type, the template arguments the panel's and the solves'
#: device kernels' names begin with). A mixed route and its plain version
#: round once to the storage type from wide values that differ in
#: summation order only, so they agree within MIXED_ULPS storage ulps of
#: max|plain|.
MIXED_ROUTES = (
    ("f32_f64", torch.float32, torch.float64, "float, double"),
    ("bf16_f32", torch.bfloat16, torch.float32, "__nv_bfloat16, float"),
    ("f16_f32", torch.float16, torch.float32, "__half, float"),
    ("bf16_f64", torch.bfloat16, torch.float64, "__nv_bfloat16, double"),
    ("f16_f64", torch.float16, torch.float64, "__half, double"),
)
#: the narrow routes of the panel and the solves (bf16 or f16 with no
#: acc_dtype: every operation rounded to the half type, in the plain
#: version's order), held to their plain versions bit for bit; their
#: Schur update is the bf16/f16 -> f32 default route
NARROW_ROUTES = (
    ("bf16", torch.bfloat16, None, "__nv_bfloat16, __nv_bfloat16"),
    ("f16", torch.float16, None, "__half, __half"),
)
#: the storage and arithmetic (None: the default route) of each route name
ROUTE_TYPES = {name: (st, acc) for name, st, acc, _ in (
    *MIXED_ROUTES, *NARROW_ROUTES, ("f32", torch.float32, None, None))}


def schur_kernel(route: str) -> str:
    """The Schur update's device kernel on a route, from the wrapper's
    table (bf16/f16 -> f32 is the half types' default route, which the
    narrow routes' lu_blocked runs too)."""
    from repro_torch.kernels import schur

    return schur.device_kernel(*ROUTE_TYPES[route])


#: lu_blocked's half routes at n = 4096: (storage, the narrow route's, the
#: f32-arithmetic route's and the f64-arithmetic route's names)
HALF_SEQUENTIAL = ((torch.bfloat16, "bf16", "bf16_f32", "bf16_f64"),
                   (torch.float16, "f16", "f16_f32", "f16_f64"))
#: the mesh phase: launcher steps and the bars of --mesh smoke against
#: --mesh none (relative): its losses; the first step's loss; the first
#: step's gradient of each parameter, at the same weights and batch (a
#: leaf's distance over its norm). repro-100m computes in f32; under the
#: (1, 1) mesh its products run as batched products (cuBLAS picks other
#: algorithms, so f32 sums run in another order). On an H100 the gaps
#: read 4.11e-6, 0 and 4.18e-6 (stack.7.mixer.wq), so the bars are 5x
#: those. The later grad norms and the final checkpoint leaves drift
#: apart (7.4e-3 and 3.7e-2 after 8 steps): AdamW's first updates are
#: about lr * sign(g) for every weight, so a weight whose gradient lies
#: within rounding of zero moves either way, and the next gradients
#: follow. They are read, not gated; a gradient lost by the sharded
#: path shows in the first step's gradients instead.
MESH_STEPS = 8
#: the mesh phase's decode: (batch, slots) of the caches filled from
#: --seed, then the greedy steps each way
MESH_DECODE_PREFIX, MESH_DECODE_STEPS = (4, 512), 16
#: phase 12's split decodes: the 2048-key decode case's keys cut into
#: ranges laid end to end, as M model ranks hold a cache's slots; M = 2
#: and 4 on multiples of the 128-key chunk, then ragged cuts, one with an
#: empty last range
SPLIT_CUTS = {"2 ranks": (0, 1024, 2048), "4 ranks": (0, 512, 1024, 1536, 2048),
              "2 ranks, ragged": (0, 700, 2048),
              "4 ranks, ragged, one empty": (0, 600, 1300, 2048, 2048)}
MESH_RTOL = {"losses": 2e-5, "first_loss": 1e-6, "first_gradients": 2e-5}
MESH_SHAPE = (8, 256)  # batch, sequence
MESH_LAUNCH = ["--arch", "repro-100m", "--batch", str(MESH_SHAPE[0]),
               "--seq", str(MESH_SHAPE[1]), "--lr", "1e-3"]
MIXED_ULPS = 4
#: the f32 default routes of the panel and the triangular solves against
#: their plain versions: f32 arithmetic in another order and FMA
#: contraction, within 1e-5 of max|plain|
F32_RTOL = 1e-5
#: the f32 protocol's bar on log|det| against the card's f64 slogdet
F32_DLOG = 1e-4
#: the recovery phase's reported tamper: server 2 scales its strip by
#: 1.3 (report-level on the inline sweep, relayed downstream on the
#: message transports); the default 5 % single-element tamper can pass
#: verification (ROADMAP §C), and recovery starts only from a rejection
REPORTED_TAMPER_KW = {"server": 2, "mode": "block", "magnitude": 0.3}
#: the recovery phase's worker-process case: n (the honest relay through
#: four worker processes takes seconds a pass at n = 4096)
MP_RECOVERY_N = 1024
#: the multiprocess phase's n: each task and result crosses a pipe as
#: wire frames, so n = 4096 spent about 90 s of the run on pipe trips
MP_N = 1024
#: the rateless phase's stacks of BATCH_N matrices: the stack run in
#: lanes, and the reference's acceptance case (tests/test_rateless.py
#: runs it on 5 x 32)
RATELESS_STACK, ACCEPT_STACK = 16, 5
#: seconds a socket daemon may take to bind (torch import, the kernels'
#: load, the CUDA context), and a connection to come up
DAEMON_BIND_S = 300.0

#: the linalg phase: the right-hand side's columns of `solve`, the f32
#: session's n, and the bars of the reference's linalg tests on results
#: against the card's own solve/inv (tests/test_linalg.py's TOL, f64 and
#: f32) and the GP objective's against torch autograd
LINALG_RHS, LINALG_F32_N = 8, 1024
LINALG_TOL = {torch.float64: 1e-9, torch.float32: 2e-3}
GP_VALUE_RTOL, GP_GRAD_TOL = 1e-9, 1e-6
#: the linalg phase's tamper: server 1 scales its LU strip and its solve
#: chunk by 1.3
LINALG_TAMPER_KW = {"server": 1, "mode": "block", "magnitude": 0.3}
#: the trisolve legs by their ops.TRSM_LEFT_LEGS key: (upper, transpose_t,
#: the TPU kernel of the triangle the leg reads)
TRISOLVE_LEGS = {"l": (False, False, "src/repro/kernels/trsm.py:74"),
                 "u": (True, False, "src/repro/kernels/trsm.py:114"),
                 "ut": (True, True, "src/repro/kernels/trsm.py:114"),
                 "lt": (False, True, "src/repro/kernels/trsm.py:74")}
LINALG_PATH = MAIN_PATH + ("trsm_left",)

#: the gateway phase (SPDC_GATEWAY_DEFAULT: buckets 64..1024, N = 4,
#: max_batch 32, inline): a saturating swarm of GATEWAY_SWARM requests
#: with sizes from GATEWAY_SIZES (buckets 256, 512 and 1024), each matrix
#: standard_normal + n·I as serve_spdc draws them, GATEWAY_REPEATS of
#: them submitted again in the swarm (single flight), the latest served
#: GATEWAY_REPEATS again after it (the cache) and one
#: GATEWAY_DIRECT_N request beyond every bucket; the full flush is 32
#: requests of GATEWAY_FULL_N, the bulk flush GATEWAY_BULK
#: (SPDC_GATEWAY_BULK's max_batch);
#: the f32, solve, tamper, socket and rateless flushes GATEWAY_SMALL
#: requests each. The phase must end within GATEWAY_BUDGET_S.
GATEWAY_SIZES = (200, 480, 1000)
GATEWAY_SWARM, GATEWAY_REPEATS, GATEWAY_DIRECT_N = 384, 8, 1500
GATEWAY_FULL_N, GATEWAY_BULK, GATEWAY_SMALL = 1000, 128, 8
#: the padded flush's requests, below max_batch (32) so that 15 dummies
#: fill it
GATEWAY_PAD_REQUESTS = 17
GATEWAY_BUDGET_S = 120.0
GATEWAY_PATH = MAIN_PATH + ("trsm_left",)
#: device kernels of a library's triangular solve or LU, none of which
#: may run in a gateway flush (its LU and strips are the port's kernels)
LIBRARY_LU_KERNELS = re.compile(r"trsm|getrf|getrs", re.IGNORECASE)

#: the pipeline phase (distributed=True, N slots on the card): its relay
#: programs, their factors' bar against the inline sweep's on a matrix
#: whose LU has no growth (the Schur terms' shapes differ by program and
#: from lu_nserver's, so cuBLAS rounds them otherwise; DESIGN.md §1.2's
#: bar between LU implementations) and the phase's time budget
PIPELINE_PROGRAMS = ("baseline", "exact", "stream")
PIPELINE_RTOL = 1e-10
PIPELINE_BUDGET_S = 60.0

#: calls a timing of a plain triangular solve takes: each is a loop of
#: one to four thousand steps, whose launches the profiler records one
#: by one (seconds a window at 2 or 3 calls)
SOLVE_PLAIN_REPS = 1
#: device_events' padding before a timed loop: launches and seconds
WARM_LAUNCHES, WARM_PAUSE_S = 64, 0.01
TIMED_RANGE = "chip_smoke.timed"


#: perf_counter at the start of main(); each phase line carries its
#: seconds since then as "at_s", so a run cut at its time limit still
#: says where its time went
STARTED = [time.perf_counter()]


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - STARTED[0]}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def dominant(rng: np.random.Generator, shape) -> np.ndarray:
    """standard_normal + n·I: diagonally dominant, so the no-pivot LU is
    stable."""
    n = shape[-1]
    return rng.standard_normal(shape) + n * np.eye(n)


def triangles(rng, dev, lead, n, dtype=torch.float64):
    """A well-conditioned unit-lower and an upper triangle, as LU gives
    them."""
    l = np.tril(rng.standard_normal((*lead, n, n)), -1) / n + np.eye(n)
    u = np.triu(rng.standard_normal((*lead, n, n))) + n * np.eye(n)
    return (torch.from_numpy(l).to(dev, dtype),
            torch.from_numpy(u).to(dev, dtype))


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


def template_name(name: str) -> str:
    """A device event's kernel name with its template arguments, without
    the signature: "leaf_kernel<float, double, float, true>"."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0].strip()


#: the device kernels of the panel and the triangular solves, whose
#: template arguments name their route, as the Schur update's do (those
#: come from its wrapper's table, schur.KERNELS)
ROUTED_KERNELS = ("lu_warp_kernel", "lu_panel_kernel", "leaf_kernel",
                  "update_kernel")


def kernel_names(fn) -> list:
    """The device kernels (template names) one call of fn puts on the
    card, from the profiler's device events."""
    events, _, _ = device_events(fn, 1)
    return sorted({template_name(e.name) for e in events})


def prefill_kernels(fn, q) -> list:
    """The device kernels of one bf16/f16 prefill call, held to the
    wgmma prefill kernel the wrapper names for q (flash_wgmma_kernel)
    alone: never the decode's flash_decode_kernel."""
    from repro_torch.kernels import flash_attn

    names = kernel_names(fn)
    check(names == [flash_attn.device_kernel(q)],
          f"a prefill ran {names}, not {flash_attn.device_kernel(q)}")
    return names


def decode_kernels(fn, want: str) -> list:
    """The device kernels of one bf16/f16 decode call (or one of its
    halves), held to `want` alone: the decode kernel the wrapper names
    (flash_decode_kernel, which merges its chunks in the same launch),
    or the split decode's merge, flash_combine_kernel."""
    names = kernel_names(fn)
    check(names == [want], f"a decode ran {names}, not {want}")
    return names


def route_profile(fn) -> tuple[list, float]:
    """The routed kernels (by template name) that one call of fn put on
    the card, from the profiler's device events, and the device ms of its
    Schur kernels."""
    from repro_torch.kernels import schur

    schur_names = {k.split("<")[0] for k in schur.KERNELS.values()}
    events, _, _ = device_events(fn, 1)
    names = {template_name(e.name) for e in events}
    schur_us = sum(e.time_range.elapsed_us() for e in events
                   if template_name(e.name).split("<")[0] in schur_names)
    routed = sorted(n for n in names
                    if n.split("<")[0] in (*ROUTED_KERNELS, *schur_names))
    return routed, schur_us / 1e3


def device_events(fn, reps: int):
    """(device events, host seconds, windows profiled) of `reps` calls
    under torch.profiler, after one warm-up call. Started cold, CUDA
    activity tracing misses the first launches of a window (1 or 2, and
    57 of 100 short ones, on an H100), which would read as a shorter
    call: so the window opens with WARM_LAUNCHES one-element fills and a
    pause. The device events kept are those whose launch (the CUDA
    runtime or driver call of the same correlation id) the host made
    after the timed range opened, less half the pause: host times on
    both sides, so the card's clock, whose offset from the host's jumps
    by milliseconds between windows, moves no event out. Rarely the
    profiler loses the device event of a launch it recorded (4 of a
    window's 310, 12 of 1270, on an H100): such a window, or one with no
    device event at all, is profiled again, up to PROFILE_ATTEMPTS
    windows, and the last one is returned."""
    for windows in range(1, PROFILE_ATTEMPTS + 1):
        everything, host_s = profiled(fn, reps)
        events, lost, launch_to_start = timed_device_events(everything)
        PROFILE_WINDOWS["windows_losing_events"] += lost > 0
        if launch_to_start:
            lo, hi = PROFILE_WINDOWS["launch_to_start_us"] or (math.inf,
                                                               -math.inf)
            PROFILE_WINDOWS["launch_to_start_us"] = [
                min(lo, *launch_to_start), max(hi, *launch_to_start)]
        if events and not lost:
            break
    PROFILE_WINDOWS["timings"] += 1
    PROFILE_WINDOWS["retried"] += windows > 1
    return events, host_s, windows


def profiled(fn, reps: int, trace: Path | None = None):
    """(every profiler event, host seconds) of one window: a warm-up
    call, WARM_LAUNCHES fills, a pause, then `reps` calls in TIMED_RANGE;
    the window's Chrome trace written to `trace` where given."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(WARM_LAUNCHES):
            pad.fill_(0.0)
        torch.cuda.synchronize()
        time.sleep(WARM_PAUSE_S)
        with record_function(TIMED_RANGE):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    if trace is not None:
        prof.export_chrome_trace(str(trace))
    return window_events(prof), host_s


class WindowEvent(NamedTuple):
    """What this script reads of a profiler event: its name (demangled,
    as prof.events() gives it), device type, correlation id, time range
    (µs from the trace's start) and stream (device_resource_id)."""
    name: str
    device_type: object
    id: int
    time_range: object
    device_resource_id: int


def window_events(prof) -> list:
    """The events of a finished profile that this script reads, as
    WindowEvents: every device event and every host event but PyTorch's
    operators (aten::, which nothing here reads; the launch calls and the
    record_function ranges stay), read straight from the profiler's
    results, with the names prof.events() drops left out. prof.events()
    builds every event's full record and a tree of them first, which
    for a plain version's loop of small launches took seconds a window
    (profile_parse_probe.py)."""
    from torch.autograd.profiler_util import Interval, StringTable, _filter_name

    cuda = torch.autograd.DeviceType.CUDA
    result = prof.profiler.kineto_results
    start = result.trace_start_ns()
    names = StringTable()
    out = []
    for e in result.events():
        name = e.name()
        if name.startswith("aten::") and e.device_type() != cuda:
            continue
        hidden = getattr(e, "is_hidden_event", lambda: False)()
        if _filter_name(name) or hidden:
            continue
        out.append(WindowEvent(
            names[name], e.device_type(), e.correlation_id(),
            Interval((e.start_ns() - start) / 1e3, (e.end_ns() - start) / 1e3),
            e.device_resource_id()))
    return out


def timed_device_events(everything) -> tuple[list, int, list]:
    """The device events of a profile whose launch the host made after
    TIMED_RANGE opened, less half the pause (the fills' launches end a
    whole pause before it opens); how many of those launches have no
    device event; and each kept event's µs from its launch to its start
    on the card (negative where the card's clock reads early)."""
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in everything if e.device_type != cuda]
    opened = min(e.time_range.start for e in host if e.name == TIMED_RANGE)
    after = opened - WARM_PAUSE_S * 1e6 / 2
    calls = {e.id: e.time_range.start for e in host
             if LAUNCH_CALL.match(e.name) and e.time_range.start >= after}
    events = [e for e in everything if e.device_type == cuda
              and e.name != TIMED_RANGE and e.id in calls]
    lost = len(calls) - len({e.id for e in events})
    return events, lost, [e.time_range.start - calls[e.id] for e in events]


#: windows profiled before one that lost events, or kept none, is used
#: as it is (and an empty one fails the run); three windows of one row in
#: a row have each lost two thirds of their events on an H100, so six.
#: PROFILE_WINDOWS counts the timings profiled, those that needed more
#: than one window (kernels_line names their rows) and the windows that
#: lost events, and keeps the least and largest time from a launch to its
#: event's start, for the run line.
PROFILE_ATTEMPTS = 6
PROFILE_WINDOWS = {"timings": 0, "retried": 0, "retried_rows": [],
                   "windows_losing_events": 0, "launch_to_start_us": []}
#: the host's CUDA runtime and driver calls that put work on the card,
#: each sharing a correlation id with its device event (cudaLaunchKernel,
#: cuLaunchKernel, cudaMemcpyAsync, cudaMemsetAsync, ...)
LAUNCH_CALL = re.compile(r"cu(da)?(Launch|Memcpy|Memset)")


def device_profile(fn, reps: int) -> tuple[float, int, float, int]:
    """(device ms, device launches, device events, windows profiled) per
    call over `reps` calls under torch.profiler; the events are every
    kernel and copy the calls put on the card. Should the profiler still
    miss an event, the launches are the events per call rounded, and the
    ms the mean event's duration times the launches, so the call does
    not look faster."""
    events, _, windows = device_events(fn, reps)
    check(bool(events), "the profiler recorded no device activity")
    per_call = len(events) / reps
    launches = max(1, round(per_call))
    mean_us = sum(e.time_range.elapsed_us() for e in events) / len(events)
    return mean_us * launches / 1e3, launches, per_call, windows


def timed(fn, reps: int) -> tuple[float, float, int]:
    """(device ms, event ms, windows profiled) per call."""
    ms, _, _, windows = device_profile(fn, reps)
    return ms, event_ms(fn, reps), windows


def counted(ops, fn):
    """(result, launches of the call) without resetting the counts, so a
    phase's totals keep accumulating."""
    before = dict(ops.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in ops.LAUNCHES.items()}


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
    from repro_torch.kernels import lu_panel, ops, ref

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

    # panel LU at the tiles of lu_diag_factor (the warp kernel up to 32
    # wide, the block kernel above); a stack's tiles keep the bits they
    # get alone
    worst = 0.0
    for shape in ((INNER, INNER), (48, 48), (64, INNER, INNER),
                  (BATCH, INNER, INNER)):
        a = torch.from_numpy(dominant(rng, shape)).to(dev)
        got = ops.lu_panel(a)
        abs_err, rel = max_err(got, ref.lu_panel_ref(a))
        alone = a.ndim == 2 or torch.equal(got[-1], ops.lu_panel(a[-1]))
        torch.cuda.synchronize()
        emit({"phase": "kernel_vs_plain", "kernel": "lu_panel",
              "shape": list(shape), "route": lu_panel.route(shape[-1], a.dtype),
              "max_abs_err": abs_err, "max_rel_err": rel,
              "last_tile_bit_equal_alone": alone, "tolerance": RTOL})
        check(rel <= RTOL, f"lu_panel {shape}: {rel}")
        check(alone, f"lu_panel {shape}: a tile's bits differ alone")
        worst = max(worst, abs_err)
    errs["lu_panel"] = worst

    # triangular solves: the Algorithm-3 strips and the panel strips
    worst_l = worst_u = 0.0
    b = SINGLE_N // N_SERVERS
    l, u = triangles(rng, dev, (), b)
    tile = torch.from_numpy(dominant(rng, (b, b))).to(dev)
    lb, ub = triangles(rng, dev, (BATCH,), BATCH_N // N_SERVERS)
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


def trsm_launches_by_rows(ops, fn):
    """(fn's result, {wrapper: {triangle rows: launches}}): the two TRSM
    wrappers' launches during fn, keyed by the size of their triangle.
    The wrappers are swapped for counting ones for the call only."""
    tally: dict[str, dict[int, int]] = {}
    saved = {name: getattr(ops, name) for name in ("trsm_lower", "trsm_upper_right")}

    def counting(name, wrapper):
        def call(tri, rhs, **kw):
            before = ops.LAUNCHES[name]
            out = wrapper(tri, rhs, **kw)
            rows = tally.setdefault(name, {})
            rows[tri.shape[-1]] = (rows.get(tri.shape[-1], 0)
                                   + ops.LAUNCHES[name] - before)
            return out
        return call

    for name, wrapper in saved.items():
        setattr(ops, name, counting(name, wrapper))
    try:
        return fn(), tally
    finally:
        for name, wrapper in saved.items():
            setattr(ops, name, wrapper)


def timings(res) -> dict:
    t = res.report.timings
    return {"pmop_s": t.pmop_s, "dispatch_s": t.dispatch_s,
            "collect_s": t.collect_s, "total_s": t.total_s}


def phase_single(rng, dev) -> tuple[dict, dict]:
    """Launches of the main path's run, and the TRSM wrappers' launches
    on the panel loop's INNER-row triangles (the strips)."""
    import repro_torch
    from repro_torch.kernels import ops

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    (res, by_rows), launches = run_counted(ops, lambda: trsm_launches_by_rows(
        ops, lambda: repro_torch.outsource_determinant(m, N_SERVERS)))
    want = slogdet_det(torch.from_numpy(m).to(dev))
    check(res.verified, f"single n={SINGLE_N} verified")
    check(res.det.allclose(want), f"single det {res.det} vs {want}")
    want_counts = expected_launches(SINGLE_N)
    check(launches["ced"] == 1, f"ced launches {launches['ced']}")
    for name, count in want_counts.items():
        check(launches[name] == count, f"{name} launches {launches[name]} != {count}")
    strips = {}
    for name, rows in by_rows.items():
        check(sum(rows.values()) == launches[name], f"{name} by rows {rows}")
        strips[name] = rows.get(INNER, 0)
        check(strips[name] == N_SERVERS * (SINGLE_N // N_SERVERS // INNER - 1),
              f"{name} strips {strips[name]}")
    others = {}
    for method in ("q1", "q2"):
        r = repro_torch.outsource_determinant(m, N_SERVERS, method=method)
        check(r.verified and r.det.allclose(want), f"single {method}")
        others[method] = {"residual": r.residual, "eps": r.report.verdict.eps}
    t0 = time.perf_counter()
    warm = repro_torch.outsource_determinant(m, N_SERVERS)
    wall = time.perf_counter() - t0
    check(warm.verified and warm.det.allclose(want), "single warm run")
    q3_cost = verify_cost(m)
    emit({"phase": "single", "n": SINGLE_N, "servers": N_SERVERS,
          "dtype": "float64", "method": "q3", "rotate_k": res.meta.rotate_k,
          "verified": res.verified, "residual": res.residual,
          "eps": res.report.verdict.eps,
          "logabs": res.det.logabs, "slogdet_logabs": want.logabs,
          "sign": res.det.sign, "launches": launches,
          "expected_launches": want_counts,
          "trsm_launches_by_triangle_rows": by_rows, "q1_q2": others,
          "warm_wall_s": wall, "warm_timings": timings(warm),
          "q3_cost": q3_cost})
    return launches, strips


def verify_cost(m: np.ndarray) -> dict:
    """Authenticate's Q3 on the card at the single phase's shape: the
    compensated sums (CUDA-event ms) against the working-precision sum
    that Q3 used before them, on the same factors, with both residuals."""
    from repro_torch.api import SPDCClient
    from repro_torch.core.lu import lu_nserver
    from repro_torch.core.verify import q3

    x = SPDCClient().open_session(m, N_SERVERS).x_aug
    l, u, _ = lu_nserver(x, N_SERVERS)

    def working_precision():
        diag = torch.einsum("...ij,...ji->...i", torch.tril(l), torch.triu(u))
        return torch.abs(diag - torch.diagonal(x, dim1=-2, dim2=-1)).sum(dim=-1)

    return {"n": x.shape[-1], "q3_ms": event_ms(lambda: q3(l, u, x), 10),
            "working_precision_ms": event_ms(working_precision, 10),
            "residual": float(q3(l, u, x)),
            "working_precision_residual": float(working_precision())}


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


def schur_scale(c, a, b) -> float:
    """max|C| + K·max|A|·max|B|: the size of what the update sums."""
    return (float(c.abs().max().float()) + a.shape[-1]
            * float(a.abs().max().float()) * float(b.abs().max().float()))


def phase_schur(rng, dev) -> dict:
    """The Schur kernel against its plain version; returns the max error
    by dtype."""
    from repro_torch.kernels import ops, ref

    big = torch.from_numpy(rng.standard_normal((SINGLE_N, SINGLE_N))).to(dev)
    b = SEQ_BLOCK
    worst = {dtype: 0.0 for dtype in SCHUR_TOL}
    for dtype, tol in SCHUR_TOL.items():
        def draw(shape):
            return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

        mat = big.to(dtype)
        cases = {
            "1024^3": (draw((b, b)), draw((b, b)), draw((b, b))),
            "views of 4096^2": (mat[b:2 * b, 2 * b:3 * b], mat[b:2 * b, :b],
                                mat[:b, 2 * b:3 * b]),
            "(16, 256, 256, 256)": tuple(draw((BATCH, 256, 256))
                                         for _ in range(3)),
        }
        for label, (c, a, bm) in cases.items():
            got = ops.schur_update(c, a, bm)
            want = ref.schur_update_ref(c, a, bm)
            torch.cuda.synchronize()
            abs_err = float((got.double() - want.double()).abs().max())
            if dtype in (torch.bfloat16, torch.float16):
                scale = float(want.double().abs().max())
                rule = f"{tol} * max|plain|"
            else:
                scale = schur_scale(c, a, bm)
                rule = f"{tol} * (max|C| + K*max|A|*max|B|)"
            emit({"phase": "kernel_vs_plain", "kernel": "schur_update",
                  "case": label, "dtype": str(dtype), "max_abs_err": abs_err,
                  "scale": scale, "tolerance": rule})
            check(abs_err <= tol * scale, f"schur {label} {dtype}: {abs_err}")
            worst[dtype] = max(worst[dtype], abs_err)
    return worst


def wall(fn) -> tuple[object, float]:
    """(result, seconds) of one call closed by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sequential(rng, dev) -> dict:
    """lu_blocked, the one-server baseline, beside lu_nserver at the same
    block granularity (the reference's fig_scaling pairing)."""
    from repro_torch.core.decipher import Determinant
    from repro_torch.core.lu import lu_blocked, lu_nserver, slogdet_from_lu
    from repro_torch.kernels import ops

    x = torch.from_numpy(dominant(rng, (SINGLE_N, SINGLE_N))).to(dev)
    (l, u), launches = run_counted(ops, lambda: lu_blocked(x, SEQ_BLOCK))
    nb = SINGLE_N // SEQ_BLOCK
    panels = SEQ_BLOCK // INNER
    outer = nb * (nb - 1) // 2
    # each diagonal tile: `panels` Doolittle panels, and beside each but
    # the last two strips and one inner update
    want_counts = {"ced": 0, "lu_panel": nb * panels,
                   "trsm_lower": nb * (panels - 1) + outer,
                   "trsm_upper_right": nb * (panels - 1) + outer,
                   "schur_update": sum(k * k for k in range(nb))
                   + nb * (panels - 1), "trsm_left": 0,
                   "flash_attention": 0, "flash_attention_backward": 0,
                   "flash_decode_partial": 0, "flash_combine": 0}
    check(launches == want_counts, f"sequential launches {launches}")
    ln, un, _ = lu_nserver(x, N_SERVERS)
    dl = float((l - ln).abs().max())
    du = float((u - un).abs().max())
    check(torch.allclose(l, ln, rtol=1e-10, atol=1e-12)
          and torch.allclose(u, un, rtol=1e-10, atol=1e-12),
          f"lu_blocked vs lu_nserver: {dl} {du}")
    sign, logabs = slogdet_from_lu(l, u)
    got = Determinant(float(sign), float(logabs))
    want = slogdet_det(x)
    check(got.allclose(want), f"sequential det {got} vs {want}")
    _, blocked_s = wall(lambda: lu_blocked(x, SEQ_BLOCK))
    _, nserver_s = wall(lambda: lu_nserver(x, N_SERVERS))
    emit({"phase": "sequential", "n": SINGLE_N, "block": SEQ_BLOCK,
          "dtype": "float64", "launches": launches,
          "expected_launches": want_counts,
          "max_abs_diff_vs_nserver": {"l": dl, "u": du},
          "logabs": got.logabs, "slogdet_logabs": want.logabs,
          "warm_wall_s": {"lu_blocked": blocked_s, "lu_nserver": nserver_s}})
    return launches


def relay(session, edges):
    """The one-way relay by hand: each task through the wire, run by its
    EdgeServer, each result back through the wire."""
    from repro_torch.api import ShardResult, ShardTask

    results, u_rows = [], []
    for task in session.tasks():
        task = ShardTask.from_bytes(task.to_bytes())
        if task.server:
            task = task.with_upstream(np.concatenate(u_rows, axis=-2))
        res = ShardResult.from_bytes(edges[task.server].run(task).to_bytes())
        results.append(res)
        u_rows.append(res.u_row)
    return results


def same_factors(pair, inline) -> bool:
    return all(torch.equal(g, w) for g, w in zip(pair, inline))


def phase_role_split(rng, dev) -> dict:
    """Session.tasks → wire → EdgeServers → collect, then the thread pool,
    against the inline sweep of the same session."""
    import repro_torch
    from repro_torch.api import (EdgeServer, InlineTransport, SPDCClient,
                                 ThreadPoolTransport)
    from repro_torch.kernels import ops

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    client = SPDCClient()
    session, pmop = run_counted(ops, lambda: client.open_session(m, N_SERVERS))
    inline, inline_launches = run_counted(
        ops, lambda: InlineTransport().sweep(session.x_aug, N_SERVERS))
    tasks, tasks_s = wall(session.tasks)
    frames_t0 = time.perf_counter()
    frames = [t.to_bytes() for t in tasks]
    encode_s = time.perf_counter() - frames_t0
    edges = [EdgeServer(i) for i in range(N_SERVERS)]
    results, manual_launches = run_counted(ops, lambda: relay(session, edges))
    manual = session._assemble(results)
    check(same_factors(manual, inline),
          "manual relay factors differ from the inline sweep's")
    check(manual_launches == inline_launches,
          f"manual launches {manual_launches} vs inline {inline_launches}")
    out = session.collect(results)
    check(out.verified, "manual relay verified")
    with ThreadPoolTransport() as tp:
        tp_results, tp_launches = run_counted(
            ops, lambda: tp.factor(session.tasks()))
        check(same_factors(session._assemble(tp_results), inline),
              "thread-pool factors differ from the inline sweep's")
        check(tp_launches == inline_launches,
              f"thread-pool launches {tp_launches} vs inline {inline_launches}")
        tp_out = session.collect(tp_results)
        check(tp_out.verified and tp_out.det == out.det, "thread pool det")
        warm, warm_s = wall(lambda: client.open_session(m, N_SERVERS).run(tp))
        check(warm.verified, "thread-pool warm run")
        want = slogdet_det(torch.from_numpy(m).to(dev))
        check(out.det.allclose(want), f"role split det {out.det} vs {want}")
        stack = dominant(rng, (BATCH, BATCH_N, BATCH_N))
        bsession = client.open_session(stack, N_SERVERS)
        binline = InlineTransport().sweep(bsession.x_aug, N_SERVERS)
        bres, batch_launches = run_counted(
            ops, lambda: tp.factor(bsession.tasks()))
        check(same_factors(bsession._assemble(bres), binline),
              "thread-pool stack factors differ from the inline sweep's")
        bout = bsession.collect(bres)
        bwant = slogdet_det(torch.from_numpy(stack).to(dev))
        check(bool(bout.verified.all()), f"stack verified {bout.verified}")
        check(all(g.allclose(w) for g, w in zip(bout.dets, bwant)), "stack dets")
        bwarm, bwarm_s = wall(lambda: repro_torch.outsource_determinant(
            stack, N_SERVERS, transport=tp))
        check(bool(bwarm.verified.all()), "stack warm run")
    emit({"phase": "role_split", "n": SINGLE_N, "servers": N_SERVERS,
          "dtype": "float64", "method": "q3", "verified": out.verified,
          "bit_equal_to_inline": {"manual": True, "threadpool": True,
                                  "stack_threadpool": True},
          "launches": {"open_session": pmop, "inline": inline_launches,
                       "manual": manual_launches, "threadpool": tp_launches,
                       "stack_threadpool": batch_launches},
          "frame_bytes": [len(f) for f in frames],
          "tasks_s": tasks_s, "encode_s": encode_s,
          "threadpool_warm_wall_s": warm_s,
          "threadpool_warm_timings": timings(warm),
          "stack": {"shape": [BATCH, BATCH_N, BATCH_N],
                    "verified": int(bout.verified.sum()),
                    "warm_wall_s": bwarm_s,
                    "warm_timings": timings(bwarm)}})
    for name, count in pmop.items():
        tp_launches[name] += count
    return tp_launches


def request_costs(session, transport, edge_cls) -> list[dict]:
    """Per task of one relay: the frame sizes, the worker round trip
    (encode, pipe, worker, pipe, decode) and the same task run in this
    process, so the difference is what the process boundary costs."""
    out, u_rows = [], []
    for task in session.tasks():
        if task.server:
            task = task.with_upstream(np.concatenate(u_rows, axis=-2))
        res, remote_s = wall(lambda: transport.submit(task, task.server))
        local, local_s = wall(lambda: edge_cls(task.server).run(task))
        check(np.array_equal(res.u_row, local.u_row), "worker strip differs")
        out.append({"server": task.server, "task_bytes": len(task.to_bytes()),
                    "result_bytes": len(res.to_bytes()),
                    "worker_round_trip_s": remote_s,
                    "in_process_s": local_s})
        u_rows.append(res.u_row)
    return out


def recovery_case(res, honest, transport: str) -> dict:
    """The recovery gates of one healed run: verified, healed, server 2
    blamed first, the honest determinant at rtol 1e-10."""
    rep = res.report.recovery
    check(bool(np.all(res.verified)) and rep is not None and rep.ok,
          f"{transport} recovery: verified {res.verified}")
    check(rep.events[0].server == 2,
          f"{transport} recovery blamed {rep.events[0].server}")
    check(res.det.sign == honest.det.sign
          and math.isclose(res.det.logabs, honest.det.logabs, rel_tol=1e-10,
                           abs_tol=0.0),
          f"{transport} healed det {res.det} vs honest {honest.det}")
    return {"verified": bool(res.verified), "rounds": rep.rounds,
            "servers_replaced": list(rep.servers_replaced),
            "replacements": [e.replacement for e in rep.events],
            "comm_elements": [e.comm_elements for e in rep.events],
            "standby_used": rep.standby_used,
            "dlogabs_vs_honest": res.det.logabs - honest.det.logabs,
            "collect_s": res.report.timings.collect_s,
            "honest_dispatch_s": honest.report.timings.dispatch_s,
            "dispatch_s": res.report.timings.dispatch_s}


def phase_multiprocess(rng, dev, rng_new) -> tuple[dict, dict]:
    """Spawned worker processes computing on the card; every task and
    result crosses a pipe as wire frames. Then, on the same workers, the
    recovery phase's worker-process case (rng_new's matrix): a reported
    tamper by server 2 healed on a standby process. Returns the client's
    launches and that case."""
    from repro_torch import ServerFault
    from repro_torch.api import (EdgeServer, InlineTransport,
                                 MultiprocessTransport, SPDCClient)
    from repro_torch.kernels import ops

    # drawn at SINGLE_N, so the later phases keep their inputs; its
    # leading MP_N block is as dominant
    m = np.ascontiguousarray(dominant(rng, (SINGLE_N, SINGLE_N))[:MP_N, :MP_N])
    client = SPDCClient()
    session, pmop = run_counted(ops, lambda: client.open_session(m, N_SERVERS))
    inline = InlineTransport().sweep(session.x_aug, N_SERVERS)
    inline_out = session.collect(inline)
    with MultiprocessTransport() as mp:
        results, first_s = wall(lambda: mp.factor(session.tasks()))
        check(len(mp.workers) == N_SERVERS, f"workers {mp.workers}")
        pair = session._assemble(results)
        diff = max(float((g - w).abs().max()) for g, w in zip(pair, inline))
        check(same_factors(pair, inline),
              f"worker-process factors differ from the inline sweep's by {diff}")
        out = session.collect(results)
        check(out.verified and out.det == inline_out.det,
              f"multiprocess det {out.det} vs inline {inline_out.det}")
        warm, warm_s = wall(lambda: client.open_session(m, N_SERVERS).run(mp))
        check(warm.verified and warm.det == inline_out.det, "multiprocess warm")
        per_task = request_costs(session, mp, EdgeServer)
        small = dominant(rng_new, (MP_RECOVERY_N, MP_RECOVERY_N))
        tamper = ServerFault(**REPORTED_TAMPER_KW)
        honest = client.open_session(small, N_SERVERS).run(mp)
        healer = SPDCClient(recover=True, standby=1)
        healed, healed_s = wall(lambda: healer.open_session(
            small, N_SERVERS, faults=tamper).run(mp))
        recovery = recovery_case(healed, honest, "multiprocess")
        check(N_SERVERS in mp.workers, f"no standby process: {mp.workers}")
        recovery.update(n=MP_RECOVERY_N, wall_s=healed_s,
                        workers=list(mp.workers))
    emit({"phase": "multiprocess", "n": MP_N, "servers": N_SERVERS,
          "dtype": "float64", "verified": out.verified,
          "bit_equal_to_inline": True, "max_abs_diff": diff,
          "spawn_and_first_sweep_s": first_s, "warm_wall_s": warm_s,
          "warm_timings": timings(warm), "per_task": per_task,
          "client_launches": pmop})
    return pmop, recovery


def spawn_daemons(count: int, root: str) -> tuple[list, list, float]:
    """`count` port WorkerDaemons on Unix sockets under `root`, each in a
    spawned process on the card, serving any worker id. Returns the
    addresses, the processes and the seconds until all had bound (a
    daemon binds once it has loaded the kernels this process built and
    created its CUDA context)."""
    import multiprocessing as mp

    from repro_torch.api.socket_transport import _daemon_main

    ctx = mp.get_context("spawn")
    addrs = [f"unix://{root}/w{i}.sock" for i in range(count)]
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_daemon_main, args=(a, None, "cuda"),
                         daemon=True, name=f"chip-smoke-sockd-{i}")
             for i, a in enumerate(addrs)]
    for proc in procs:
        proc.start()
    deadline = t0 + DAEMON_BIND_S
    for a, proc in zip(addrs, procs):
        path = a.removeprefix("unix://")
        while not Path(path).exists():
            check(proc.is_alive(), f"daemon {a} exited ({proc.exitcode})")
            check(time.perf_counter() < deadline, f"daemon {a} never bound")
            time.sleep(0.05)
    return addrs, procs, time.perf_counter() - t0


def hellos(transport) -> list:
    """Each worker's daemon counters, as its connection's HELLO read
    them."""
    return [{k: transport.hello(w)[k] for k in ("connections", "frames_served")}
            for w in range(N_SERVERS)]


def phase_socket(rng, dev, addrs, spawn_s) -> dict:
    """The warm daemons through SocketTransport: n = 4096, N = 4, q3.
    Returns the client's launches of the first sweep."""
    from repro_torch.api import EdgeServer, InlineTransport, SPDCClient
    from repro_torch.api.socket_transport import SocketTransport
    from repro_torch.kernels import ops

    phase_t0 = time.perf_counter()
    m = dominant(rng, (SINGLE_N, SINGLE_N))
    client = SPDCClient()
    inline_session = client.open_session(m, N_SERVERS)
    inline = InlineTransport().sweep(inline_session.x_aug, N_SERVERS)
    inline_out = inline_session.collect(inline)
    with SocketTransport(addrs, connect_timeout=DAEMON_BIND_S) as t1:
        def first_run():
            session = client.open_session(m, N_SERVERS)
            results, seconds = wall(lambda: t1.factor(session.tasks()))
            return session, results, seconds

        (session, results, first_s), launches = counted(ops, first_run)
        for name in SERVER_PATH:
            check(launches[name] == 0,
                  f"the client launched {name} on the socket sweep")
        check(same_factors(session._assemble(results), inline),
              "socket factors differ from the inline sweep's")
        out = session.collect(results)
        check(out.verified and out.det == inline_out.det,
              f"socket det {out.det} vs inline {inline_out.det}")
        first = hellos(t1)
        per_task = request_costs(session, t1, EdgeServer)
    with SocketTransport(addrs, connect_timeout=DAEMON_BIND_S) as t2:
        warm, warm_s = wall(lambda: client.open_session(m, N_SERVERS).run(t2))
        check(warm.verified and warm.det == inline_out.det, "socket warm run")
        second = hellos(t2)
    for w, (a, b) in enumerate(zip(first, second)):
        check(b["connections"] > a["connections"] and b["frames_served"] > 0,
              f"worker {w}: a second client reached other daemons: {a} {b}")
    want = slogdet_det(torch.from_numpy(m).to(dev))
    check(out.det.allclose(want), f"socket det {out.det} vs {want}")
    emit({"phase": "socket", "n": SINGLE_N, "servers": N_SERVERS,
          "daemons": len(addrs), "dtype": "float64", "method": "q3",
          "verified": out.verified, "bit_equal_to_inline": True,
          "det_equal_to_inline": True, "spawn_s": spawn_s,
          "first_sweep_s": first_s, "warm_wall_s": warm_s,
          "warm_timings": timings(warm),
          "hello_first_client": first, "hello_second_client": second,
          "per_task": per_task, "client_launches": launches,
          "phase_s": time.perf_counter() - phase_t0})
    return launches


def phase_rateless(rng, dev, addrs) -> dict:
    """Rateless dispatch on the socket phase's daemons: an honest n = 4096
    run (F = 8 strips of 512 rows) bit-equal to lu_nserver(x_aug, 8), a
    16 x 1024 stack in lanes, and the reference's acceptance case on a
    5 x 1024 stack (a Pareto straggler and a block tamperer). Returns the
    client's launches of the honest run."""
    import repro_torch
    from repro_torch import ServerFault
    from repro_torch.api import SPDCClient
    from repro_torch.api.socket_transport import SocketTransport
    from repro_torch.configs import RatelessConfig
    from repro_torch.core.lu import lu_nserver
    from repro_torch.core.verify import authenticate
    from repro_torch.distrib.rateless import run_rateless
    from repro_torch.kernels import ops

    def per_worker(rpt, key="completed"):
        return {w: h[key] for w, h in sorted(rpt.workers.items())}

    phase_t0 = time.perf_counter()
    m = dominant(rng, (SINGLE_N, SINGLE_N))
    client = SPDCClient(rateless=RatelessConfig())
    with SocketTransport(addrs, connect_timeout=DAEMON_BIND_S) as t:
        def honest_run():
            session = client.open_session(m, N_SERVERS)
            factors, session._dispatch_s = wall(lambda: session._rateless(t))
            return session, factors

        ((session, (l, u)), wall_s), launches = counted(
            ops, lambda: wall(honest_run))
        rpt = session.fleet_report
        out = session.collect((l, u), transport=t)
        strips = session.partitions
        check(strips == 2 * N_SERVERS and session.strip_block == SINGLE_N // strips,
              f"rateless grid {strips} x {session.strip_block}")
        check(rpt.inline_strips == 0, f"inline strips {rpt.inline_strips}")
        for name in SERVER_PATH:
            check(launches[name] == 0,
                  f"the client launched {name} on the honest rateless run")
        wl, wu, _ = lu_nserver(session.x_aug, strips)
        check(same_factors((l, u), (wl, wu)),
              "rateless factors differ from lu_nserver(x_aug, F)")
        want = slogdet_det(torch.from_numpy(m).to(dev))
        check(out.verified and out.det.allclose(want),
              f"rateless det {out.det} vs {want}")
        honest = {"n": SINGLE_N, "strips": strips,
                  "strip_rows": session.strip_block, "verified": out.verified,
                  "bit_equal_to_lu_nserver": True, "wall_s": wall_s,
                  "timings": timings(out), "dispatches": rpt.dispatches,
                  "retries": rpt.retries, "inline_strips": rpt.inline_strips,
                  "strips_by_worker": per_worker(rpt),
                  "ewma_latency_s": per_worker(rpt, "ewma_latency_s")}

        stack = dominant(rng, (RATELESS_STACK, BATCH_N, BATCH_N))
        res, stack_s = wall(lambda: repro_torch.outsource_determinant(
            stack, N_SERVERS, rateless=True, transport=t))
        swant = slogdet_det(torch.from_numpy(stack).to(dev))
        check(bool(res.verified.all()), f"rateless stack {res.verified}")
        check(all(g.allclose(w) for g, w in zip(res.dets, swant)),
              "rateless stack dets")
        srpt = res.report.fleet
        check(srpt.lanes == min(RATELESS_STACK, N_SERVERS), f"lanes {srpt.lanes}")
        lanes = {"shape": [RATELESS_STACK, BATCH_N, BATCH_N],
                 "verified": int(res.verified.sum()), "lanes": srpt.lanes,
                 "wall_s": stack_s, "timings": timings(res),
                 "dispatches": srpt.dispatches,
                 "inline_strips": srpt.inline_strips,
                 "strips_by_worker": per_worker(srpt)}

        # the reference's acceptance case (tests/test_rateless.py)
        acc = dominant(rng, (ACCEPT_STACK, BATCH_N, BATCH_N))
        clean = repro_torch.outsource_determinant(acc, N_SERVERS, rateless=True,
                                                  transport=t)
        check(bool(clean.verified.all()), "acceptance stack, honest run")
        cfg = RatelessConfig(request_timeout_s=0.35, probation_cooldown_s=60.0)
        plan = (ServerFault(server=1, kind="delay", delay_s=0.25,
                            delay_dist="pareto", delay_alpha=2.5),
                ServerFault(server=2, kind="tamper", mode="block",
                            magnitude=0.5))
        healer = SPDCClient(rateless=cfg, recover=True)
        asession = healer.open_session(acc, N_SERVERS, faults=plan)
        (al, au, arpt), acc_s = wall(lambda: run_rateless(
            asession, t, cfg, healer.fleet, faults=asession.plan))
        lt, ut = asession._on_device(al, au)
        for method in ("q2", "q3"):
            v = authenticate(lt, ut, asession.x_aug,
                             num_servers=asession.partitions, method=method)
            check(bool(np.all(v.ok)), f"acceptance factors fail {method}")
        asession.fleet_report = arpt
        aout = asession.collect((lt, ut), transport=t)
        check(bool(aout.verified.all()), f"acceptance {aout.verified}")
        check(all(g.sign == w.sign and math.isclose(
            g.logabs, w.logabs, rel_tol=1e-10, abs_tol=0.0)
            for g, w in zip(aout.dets, clean.dets)), "acceptance dets")
        done = per_worker(arpt)
        tamperer = arpt.workers[2]
        check(tamperer["quarantined"] and tamperer["completed"] == 0,
              f"tamperer {tamperer}")
        check(done[1] < min(done[0], done[3]), f"straggler served {done}")
        check(sum(done.values()) + arpt.inline_strips
              == arpt.num_strips * arpt.lanes, f"strips {done}")
        acceptance = {"shape": [ACCEPT_STACK, BATCH_N, BATCH_N],
                      "verified": int(aout.verified.sum()), "wall_s": acc_s,
                      "q2_q3_pass_on_streamed_factors": True,
                      "max_dlogabs_vs_honest": max(
                          abs(g.logabs - w.logabs)
                          for g, w in zip(aout.dets, clean.dets)),
                      "strips_by_worker": done,
                      "quarantined": [w for w, h in sorted(arpt.workers.items())
                                      if h["quarantined"]],
                      "dispatches": arpt.dispatches, "retries": arpt.retries,
                      "timeouts": arpt.timeouts,
                      "tampered_strips": arpt.tampered_strips,
                      "inline_strips": arpt.inline_strips}
    emit({"phase": "rateless", "servers": N_SERVERS, "daemons": len(addrs),
          "dtype": "float64", "honest": honest, "stack": lanes,
          "acceptance": acceptance, "client_launches": launches,
          "phase_s": time.perf_counter() - phase_t0})
    return launches


def gateway_checks(results, mats, dev, what: str) -> float:
    """Every result verified with no error, its determinant within rtol
    1e-10 of torch.linalg.slogdet in f64 on the card (the sign exact);
    same-size matrices go to slogdet as one stack. Returns the largest
    |Δlog|det||."""
    from repro_torch.core.decipher import Determinant

    by_n: dict[int, list[int]] = {}
    for i, m in enumerate(mats):
        by_n.setdefault(m.shape[0], []).append(i)
    worst = 0.0
    for idx in by_n.values():
        stack = torch.from_numpy(np.stack([mats[i] for i in idx])).to(dev)
        signs, logabs = torch.linalg.slogdet(stack)
        for i, s, la in zip(idx, signs.tolist(), logabs.tolist()):
            r = results[i]
            check(r is not None and r.error is None and r.verified,
                  f"{what}: request {i} {r}")
            check(r.det.sign == s and math.isclose(
                r.det.logabs, la, rel_tol=1e-10, abs_tol=0.0),
                f"{what}: det {r.det} vs {Determinant(s, la)}")
            worst = max(worst, abs(r.det.logabs - la))
    return worst


def gateway_swarm(rng, dev) -> tuple[dict, dict]:
    """The saturating swarm through AsyncSPDCGateway(SPDC_GATEWAY_DEFAULT),
    its repeats, the cache wave and the direct request; every answer
    checked. Returns the phase's numbers and one request's matrix of
    each size, the direct one's too, by size."""
    import asyncio

    import repro_torch
    from repro_torch import AsyncSPDCGateway
    from repro_torch.configs import SPDC_GATEWAY_DEFAULT
    from repro_torch.serve import bucket_size_for

    sizes = rng.choice(GATEWAY_SIZES, size=GATEWAY_SWARM)
    mats = [dominant(rng, (int(n), int(n))) for n in sizes]
    repeat_idx = [int(i) for i in rng.choice(len(mats), GATEWAY_REPEATS,
                                             replace=False)]
    big = dominant(rng, (GATEWAY_DIRECT_N, GATEWAY_DIRECT_N))
    offered = mats + [mats[i] for i in repeat_idx]

    async def drive():
        async with AsyncSPDCGateway(SPDC_GATEWAY_DEFAULT, device=dev) as gw:
            t0 = time.perf_counter()
            primed = await gw.warmup((SPDC_GATEWAY_DEFAULT.max_batch,))
            warmup_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            swarm = await asyncio.gather(*(gw.submit(m) for m in offered),
                                         return_exceptions=True)
            swarm_s = time.perf_counter() - t0
            stats = gw.stats.as_dict()
            # the cache holds the 256 latest verified results (LRU): ask
            # again for the latest leaders' matrices
            leaders = [i for i, r in enumerate(swarm[:len(mats)])
                       if not isinstance(r, BaseException)
                       and r.flush_reason not in ("coalesced", "cache")]
            latest = sorted(leaders, key=lambda i: swarm[i].completed_at)[
                -GATEWAY_REPEATS:]
            wave = await asyncio.gather(*(gw.submit(mats[i])
                                          for i in latest))
            t0 = time.perf_counter()
            direct = await gw.submit(big)
            direct_s = time.perf_counter() - t0
            return (primed, warmup_s, swarm, swarm_s, stats, latest, wave,
                    direct, direct_s, gw.stats.as_dict(), gw.healthz())

    (primed, warmup_s, swarm, swarm_s, swarm_stats, latest, wave, direct,
     direct_s, stats, health) = asyncio.run(drive())
    shed = [r for r in swarm if isinstance(r, BaseException)]
    check(not shed, f"swarm requests raised: {shed[:3]}")
    worst = gateway_checks(swarm, offered, dev, "swarm")
    for i, r in zip(latest, wave):
        check(r.cache_hit and r.det == swarm[i].det, f"cache wave {r}")
    for k, i in enumerate(repeat_idx):
        check(swarm[len(mats) + k].det == swarm[i].det, "a repeat's det")
    worst = max(worst, gateway_checks([direct], [big], dev, "direct"))
    check(direct.flush_reason == "direct", f"direct {direct.flush_reason}")
    check(stats["failed"] == 0 and stats["rejected"] == 0
          and stats["rejected_admission"] == 0
          and stats["rejected_breaker"] == 0, f"swarm stats {stats}")
    check(stats["cache_hits"] >= GATEWAY_REPEATS, f"cache hits {stats}")
    # each matrix of the top bucket's (1024's) first flush against its
    # own call at its raw size
    top = bucket_size_for(max(GATEWAY_SIZES), SPDC_GATEWAY_DEFAULT.buckets,
                          N_SERVERS)
    first = min((r.completed_at for r in swarm if r.pad_to == top),
                default=None)
    check(first is not None, f"no flush of the {top} bucket")
    own = [i for i, r in enumerate(swarm[:len(mats)])
           if r.pad_to == top and r.completed_at == first
           and not r.cache_hit and r.flush_reason != "coalesced"]
    for i in own:
        ref = repro_torch.outsource_determinant(mats[i], N_SERVERS,
                                                device=dev)
        check(ref.verified and ref.det.allclose(swarm[i].det),
              f"first {top} flush: {swarm[i].det} vs its own {ref.det}")
    lat = np.asarray([r.latency_s for r in swarm])
    served = len(swarm)
    reasons = {k.removeprefix("flushes_"): swarm_stats[k] for k in
               ("flushes_full", "flushes_timeout", "flushes_drain")}
    return {"requests": len(offered), "sizes": list(GATEWAY_SIZES),
            "buckets": sorted({r.pad_to for r in swarm}),
            "warmup_shapes": primed, "warmup_s": warmup_s,
            "wall_s": swarm_s, "dets_per_s": served / swarm_s,
            "latency_ms": {"p50": float(np.percentile(lat, 50) * 1e3),
                           "p99": float(np.percentile(lat, 99) * 1e3),
                           "max": float(lat.max() * 1e3)},
            "flushes": swarm_stats["flushes"], "flushes_by_reason": reasons,
            "batches_by_bucket": {
                str(b): sorted({r.batch for r in swarm if r.pad_to == b})
                for b in sorted({r.pad_to for r in swarm})},
            "top_bucket": top, "top_first_flush_own_calls": len(own),
            "cache_hits": stats["cache_hits"],
            "coalesced": stats["coalesced"],
            "breaker_opens": stats["breaker_opens"],
            "health": health["status"],
            "direct": {"n": GATEWAY_DIRECT_N, "s": direct_s,
                       "pad_to": direct.pad_to},
            "max_dlogabs": worst, "stats": stats}, {
                **{m.shape[0]: m for m in reversed(mats)},
                GATEWAY_DIRECT_N: big}


def gateway_full_flush(rng, dev) -> tuple[dict, torch.Tensor]:
    """One full 32 x 1024 flush of SPDC_GATEWAY_DEFAULT (cache off, so
    each call sweeps): its wall, the same stack's SessionTimings split,
    SeedGen's and KeyGen's host share, the boundary screen, the launches
    of each kernel, the card's busy share under torch.profiler and no
    library LU or triangular solve; then a 17-request flush padded to 32
    against the same flush unpadded. Returns the numbers and the flush's
    (B, n', n') stack."""
    from dataclasses import replace

    from repro_torch import SPDCGateway
    from repro_torch.api import SPDCClient
    from repro_torch.configs import CACHE_OFF, SPDC_GATEWAY_DEFAULT
    from repro_torch.core.keygen import keygen
    from repro_torch.core.protocol import outsource_determinant_mixed
    from repro_torch.core.seed import seedgen
    from repro_torch.kernels import ops

    cfg = replace(SPDC_GATEWAY_DEFAULT, cache=CACHE_OFF)
    n, batch = GATEWAY_FULL_N, cfg.max_batch
    mats = [dominant(rng, (n, n)) for _ in range(batch)]
    flushes = []
    gw = SPDCGateway(cfg, device=dev, on_flush=flushes.append)

    def one_flush():
        rids = [gw.submit(m) for m in mats]
        return [gw.take(r) for r in rids]

    results, launches = counted(ops, one_flush)
    pad_to = results[0].pad_to
    check(all(r.batch == batch and r.flush_reason == "full" for r in results),
          "the full flush's batch")
    worst = gateway_checks(results, mats, dev, "full flush")
    check(launches["ced"] == batch, f"full flush ced launches {launches}")
    for name in SERVER_PATH:
        check(launches[name] > 0, f"{name} never launched in the flush")
    events, host_s, _ = device_events(one_flush, 1)
    check(bool(events), "the profiler recorded no device activity")
    library = sorted({short_name(e.name) for e in events
                      if LIBRARY_LU_KERNELS.search(e.name)})
    check(not library, f"library LU / trsm kernels in a flush: {library}")
    by_kernel: dict[str, list] = {}
    for evt in events:
        entry = by_kernel.setdefault(short_name(evt.name), [0.0, 0])
        entry[0] += evt.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    res, direct_s = wall(lambda: outsource_determinant_mixed(
        mats, N_SERVERS, pad_to=pad_to, device=dev))
    check(bool(res.verified.all()), "the full stack's direct call")
    t0 = time.perf_counter()
    seeds = [seedgen(128, m) for m in mats]
    seedgen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for m, sd in zip(mats, seeds):
        keygen(128, sd, m.shape[0])
    keygen_s = time.perf_counter() - t0
    from repro_torch.api.client import _FULL_CHECK_ELEMS

    session = SPDCClient(device=dev).open_session(mats, N_SERVERS,
                                                  pad_to=pad_to)
    tasks = session.tasks(check_boundary=False)
    t0 = time.perf_counter()
    session._assert_boundary(tasks, None)
    screen_s = time.perf_counter() - t0
    payload = sum(t.x_row.size for t in tasks)
    # what the dummies cost: 17 requests padded to 32 against unpadded
    extra = [dominant(rng, (n, n)) for _ in range(GATEWAY_PAD_REQUESTS)]
    pad_sweeps = {"padded": [], "unpadded": []}
    for label in ("padded", "unpadded", "unpadded", "padded"):
        g = SPDCGateway(replace(cfg, pad_batches=label == "padded"),
                        device=dev, on_flush=flushes.append)
        rids = [g.submit(m) for m in extra]
        g.drain()
        out = [g.take(r) for r in rids]
        check(all(r.verified and r.batch == len(extra) for r in out),
              f"{label} 17-request flush")
        want = batch if label == "padded" else len(extra)
        check(flushes[-1].padded_batch == want, f"{label} padded batch")
        pad_sweeps[label].append(flushes[-1].sweep_s)
    t = res.report.timings
    host_pmop = seedgen_s + keygen_s
    return {"batch": batch, "n": n, "pad_to": pad_to,
            "flush_wall_s": flushes[0].sweep_s,
            "direct_call_wall_s": direct_s,
            "timings": timings(res),
            "pmop_share": t.pmop_s / t.total_s,
            "sweep_share": t.dispatch_s / t.total_s,
            "pmop_host_seedgen_s": seedgen_s, "pmop_host_keygen_s": keygen_s,
            "pmop_seedgen_keygen_share_of_pmop": host_pmop / t.pmop_s,
            "boundary_screen_s": screen_s,
            "boundary_screen": "full" if payload <= _FULL_CHECK_ELEMS
            else f"structural ({payload} payload elements above "
                 f"_FULL_CHECK_ELEMS = {_FULL_CHECK_ELEMS})",
            "launches": launches, "profiled_wall_ms": host_s * 1e3,
            "device_ms": busy_ms, "device_busy_share": busy_ms / (host_s * 1e3),
            "device_launches": len(events),
            "top_device_ms": {k: {"ms": v[0], "count": v[1]} for k, v in top},
            "library_lu_kernels": library, "max_dlogabs": worst,
            "pad_17_to_32_sweep_s": pad_sweeps}, session.x_aug


def gateway_vs_plain(dev, samples: dict, stack: torch.Tensor) -> dict:
    """Each kernel of a gateway flush against its plain version at the
    shapes the flushes gave it: CED on one request of each size the swarm
    served (and the direct request's) with that request's own blinding
    vector and rotation, bit-equal; the panel tiles, the panel's strips
    and lu_nserver's outer strips cut from the full flush's (B, n', n')
    stack at b = n'/N, at RTOL. Returns each kernel's max abs error."""
    from repro_torch.api import SPDCClient
    from repro_torch.core.cipher import _blinding
    from repro_torch.core.keygen import keygen
    from repro_torch.core.lu import lu_diag_factor
    from repro_torch.core.prt import rotate_degree
    from repro_torch.core.seed import seedgen
    from repro_torch.kernels import ops, ref

    client = SPDCClient(device=dev)
    worst = 0.0
    cases = []
    for n, m in sorted(samples.items()):
        seed = seedgen(client.lambda1, m)
        key = keygen(client.lambda2, seed, n)
        mt = torch.from_numpy(m).to(dev)
        v, k = _blinding(key.v, mt), rotate_degree(seed.psi)
        kw = {"mode": client.mode, "growth_safe": client.growth_safe}
        got, want = ops.ced(mt, v, k, **kw), ref.ced_ref(mt, v, k, **kw)
        torch.cuda.synchronize()
        worst = max(worst, max_err(got, want)[0])
        check(torch.equal(got, want), f"gateway ced n={n} k={k}")
        cases.append({"n": n, "k": k})
    errs = {"ced": worst}
    emit({"phase": "kernel_vs_plain", "kernel": "ced", "where": "gateway",
          "cases": cases, "max_abs_err": worst,
          "tolerance": "bit-equal (torch.equal)"})

    b = stack.shape[-1] // N_SERVERS
    diag = stack[:, :b, :b]
    tile = diag[:, :INNER, :INNER]
    got = ops.lu_panel(tile)
    abs_err, rel = max_err(got, ref.lu_panel_ref(tile))
    alone = torch.equal(got[-1], ops.lu_panel(tile[-1]))
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "kernel": "lu_panel", "where": "gateway",
          "shape": list(tile.shape), "max_abs_err": abs_err,
          "max_rel_err": rel, "last_tile_bit_equal_alone": alone,
          "tolerance": RTOL})
    check(rel <= RTOL, f"gateway lu_panel {list(tile.shape)}: {rel}")
    check(alone, "gateway lu_panel: a tile's bits differ alone")
    errs["lu_panel"] = abs_err
    # the panel's strips beside and below its first tile (strided views
    # of the diagonal block), then server 0's outer strips: U_01 and L_10
    l00, u00 = lu_diag_factor(diag)
    cases = [
        (f"panel strips ({stack.shape[0]}, {INNER}, {b - INNER})", got, got,
         diag[:, :INNER, INNER:], diag[:, INNER:, :INNER]),
        (f"outer strips ({stack.shape[0]}, {b}, {b})", l00, u00,
         stack[:, :b, b:2 * b], stack[:, b:2 * b, :b]),
    ]
    errs["trsm_lower"] = errs["trsm_upper_right"] = 0.0
    for label, lt, ut, rhs_l, rhs_u in cases:
        abs_l, rel_l = max_err(ops.trsm_lower(lt, rhs_l),
                               ref.trsm_lower_ref(lt, rhs_l))
        abs_u, rel_u = max_err(ops.trsm_upper_right(ut, rhs_u),
                               ref.trsm_upper_right_ref(ut, rhs_u))
        torch.cuda.synchronize()
        emit({"phase": "kernel_vs_plain", "kernel": "trsm", "where": "gateway",
              "case": label,
              "trsm_lower": {"max_abs_err": abs_l, "max_rel_err": rel_l},
              "trsm_upper_right": {"max_abs_err": abs_u, "max_rel_err": rel_u},
              "tolerance": RTOL})
        check(rel_l <= RTOL and rel_u <= RTOL,
              f"gateway trsm {label}: {rel_l} {rel_u}")
        errs["trsm_lower"] = max(errs["trsm_lower"], abs_l)
        errs["trsm_upper_right"] = max(errs["trsm_upper_right"], abs_u)
    return errs


def gateway_small_flushes(rng, dev, addrs) -> dict:
    """The f32 bucket, a solve bucket, the hardened gateway's tamperer
    bucket beside a clean one, the breaker on a poisoned bucket, one
    socket flush on the daemons against inline and one rateless flush on
    them against lu_nserver(x_aug, 8), and the bulk flush."""
    from dataclasses import replace

    from repro_torch import ServerFault, SPDCGateway
    from repro_torch.api import SPDCClient, TransportConfig
    from repro_torch.api.socket_transport import SocketTransport
    from repro_torch.configs import (
        CACHE_OFF, SPDC_EDGE_RATELESS, SPDC_EDGE_SOCKET, SPDC_GATEWAY_BULK,
        SPDC_GATEWAY_DEFAULT, SPDC_GATEWAY_HARDENED, SPDC_GATEWAY_SOCKET,
        BreakerConfig,
    )
    from repro_torch.core.lu import lu_nserver
    from repro_torch.serve import BreakerOpen, bucket_size_for

    k = GATEWAY_SMALL
    n_lo, n_mid, n_hi = GATEWAY_SIZES
    out = {}

    def flush_all(cfg, mats, **kw):
        gw = SPDCGateway(cfg, device=dev, **kw)
        try:
            rids = [gw.submit(m, **sub) for m, sub in mats]
            gw.drain()
            return [gw.take(r) for r in rids], gw.stats.as_dict()
        finally:
            gw.close()

    # f32 bucket
    m32 = [dominant(rng, (n_lo, n_lo)) for _ in range(k)]
    r32, st = flush_all(SPDC_GATEWAY_DEFAULT,
                        [(m, {"dtype": "float32"}) for m in m32])
    want = [slogdet_det(torch.from_numpy(m).to(dev)) for m in m32]
    check(all(r.verified and r.det.dtype == "float32" and r.det.allclose(w)
              for r, w in zip(r32, want)), "f32 bucket")
    out["f32"] = {"requests": k, "n": n_lo, "pad_to": r32[0].pad_to,
                  "flushes": st["flushes"],
                  "max_dlogabs": max(abs(r.det.logabs - w.logabs)
                                     for r, w in zip(r32, want))}

    # solve bucket
    ms = [dominant(rng, (n_mid, n_mid)) for _ in range(4)]
    bs = [rng.standard_normal((n_mid, 2)) for _ in ms]
    rs, st = flush_all(SPDC_GATEWAY_DEFAULT,
                       [(m, {"op": "solve", "rhs": b}) for m, b in zip(ms, bs)])
    resid = []
    for r, m, b in zip(rs, ms, bs):
        check(r.verified and r.error is None and r.op == "solve", "solve")
        a = torch.from_numpy(m).to(dev)
        y = torch.as_tensor(r.solution, dtype=torch.float64, device=dev)
        bt = torch.from_numpy(b).to(dev)
        resid.append(float(torch.linalg.norm(a @ y - bt)
                           / (torch.linalg.norm(a) * torch.linalg.norm(y))))
    check(max(resid) < 1e-10, f"solve residuals {resid}")
    out["solve"] = {"requests": len(ms), "n": n_mid, "rhs_cols": 2,
                    "flushes": st["flushes"], "max_rel_residual": max(resid),
                    "session_residuals": [r.residual for r in rs]}

    # the hardened gateway: server 2 tampers in the n_mid bucket only
    mixed = ([dominant(rng, (n_mid, n_mid)) for _ in range(k)]
             + [dominant(rng, (n_lo, n_lo)) for _ in range(k)])
    tampered = bucket_size_for(n_mid, SPDC_GATEWAY_HARDENED.buckets,
                               N_SERVERS)

    def faults_for(key):
        if key.pad_to == tampered:
            return ServerFault(**REPORTED_TAMPER_KW)
        return None

    cfg_h = replace(SPDC_GATEWAY_HARDENED, cache=CACHE_OFF)
    healed, hst = flush_all(cfg_h, [(m, {}) for m in mixed],
                            faults_for=faults_for)
    honest, _ = flush_all(cfg_h, [(m, {}) for m in mixed])
    worst = gateway_checks(healed, mixed, dev, "tamper")
    for r, h in zip(healed, honest):
        if r.pad_to == tampered:
            check(r.recovery is not None and r.recovery.ok
                  and r.recovery.servers_replaced == (2,),
                  f"tampered bucket {r.recovery}")
            check(r.det.allclose(h.det, rtol=1e-10), "healed det")
        else:
            check(r.recovery is None and r.det == h.det,
                  "a co-batched bucket paid for the tamper")
    out["tamper"] = {
        "preset": SPDC_GATEWAY_HARDENED.name, "tampered_bucket": tampered,
        "fault": REPORTED_TAMPER_KW,
        "recovered_flushes": hst["recovered_flushes"],
        "healed_dets_bit_equal_to_honest": all(
            r.det == h.det for r, h in zip(healed, honest)
            if r.pad_to == tampered),
        "clean_bucket_bit_equal_to_honest": True, "max_dlogabs": worst}

    # the breaker: the n_lo bucket's sweeps fail until it opens
    cfg_b = replace(SPDC_GATEWAY_DEFAULT, max_batch=1, pad_batches=False,
                    cache=CACHE_OFF,
                    breaker=BreakerConfig(failure_threshold=3,
                                          probe_jitter=0.0))
    poisoned = bucket_size_for(n_lo, cfg_b.buckets, N_SERVERS)

    def poison(key):
        if key.pad_to == poisoned:
            raise RuntimeError("poisoned bucket")
        return None

    gw = SPDCGateway(cfg_b, device=dev, faults_for=poison)
    errors = [gw.take(gw.submit(dominant(rng, (n_lo, n_lo)))).error
              for _ in range(3)]
    check(all(e and "poisoned" in e for e in errors), f"poisoned {errors}")
    try:
        gw.submit(dominant(rng, (n_lo, n_lo)))
        opened = False
    except BreakerOpen:
        opened = True
    check(opened, "the breaker did not open")
    clean = dominant(rng, (n_hi, n_hi))
    other = gw.take(gw.submit(clean))
    gateway_checks([other], [clean], dev, "beside an open breaker")
    out["breaker"] = {"poisoned_bucket": poisoned, "failed_flushes": 3,
                      "breaker_opens": gw.stats.breaker_opens,
                      "rejected_breaker": gw.stats.rejected_breaker,
                      "health": gw.healthz()["status"],
                      "other_bucket_served": other.verified}
    check(gw.stats.breaker_opens == 1 and gw.healthz()["status"] == "degraded",
          "breaker stats")

    # one socket flush on the daemons, bit-equal to inline
    sock_cfg = TransportConfig("socket", addresses=tuple(addrs),
                               timeout=DAEMON_BIND_S)
    sm = [dominant(rng, (n_mid, n_mid)) for _ in range(k)]
    cfg_s = replace(SPDC_GATEWAY_SOCKET,
                    spdc=replace(SPDC_EDGE_SOCKET, transport=sock_cfg))
    cfg_i = replace(SPDC_GATEWAY_SOCKET,
                    spdc=replace(SPDC_EDGE_SOCKET, transport="inline"))
    (rsock, sst), sock_s = wall(lambda: flush_all(cfg_s, [(m, {}) for m in sm]))
    (rinl, _), inl_s = wall(lambda: flush_all(cfg_i, [(m, {}) for m in sm]))
    gateway_checks(rsock, sm, dev, "socket flush")
    check(all(a.det == b.det for a, b in zip(rsock, rinl)),
          "socket flush differs from inline")
    out["socket"] = {"preset": SPDC_GATEWAY_SOCKET.name, "requests": k,
                     "n": n_mid, "flushes": sst["flushes"],
                     "dets_bit_equal_to_inline": True, "wall_s": sock_s,
                     "inline_wall_s": inl_s}

    # one rateless flush on the daemons, bit-equal to lu_nserver(x_aug, F)
    rm = [dominant(rng, (n_mid, n_mid)) for _ in range(4)]
    cfg_r = replace(SPDC_GATEWAY_DEFAULT, cache=CACHE_OFF,
                    spdc=replace(SPDC_EDGE_RATELESS, transport=sock_cfg))
    (rrl, rst), rl_s = wall(lambda: flush_all(cfg_r, [(m, {}) for m in rm]))
    gateway_checks(rrl, rm, dev, "rateless flush")
    pad_to = rrl[0].pad_to
    check(rrl[0].batch == 4, "rateless batch")
    client = SPDCClient(rateless=True, recover=True, device=dev)
    session = client.open_session(rm, N_SERVERS, pad_to=pad_to)
    strips = session.partitions
    check(strips == 2 * N_SERVERS, f"rateless strips {strips}")
    wl, wu, _ = lu_nserver(session.x_aug, strips)
    want = session.collect((wl, wu))
    check(all(r.det == w for r, w in zip(rrl, want.dets)),
          "the rateless flush differs from lu_nserver(x_aug, F)")
    with SocketTransport(addrs, connect_timeout=DAEMON_BIND_S) as t:
        again = client.open_session(rm, N_SERVERS, pad_to=pad_to)
        l, u = again._rateless(t)
    check(same_factors((l, u), (wl, wu)),
          "rateless factors differ from lu_nserver(x_aug, F)")
    out["rateless"] = {"spdc": SPDC_EDGE_RATELESS.name, "requests": 4,
                       "n": n_mid, "pad_to": pad_to, "strips": strips,
                       "flushes": rst["flushes"], "wall_s": rl_s,
                       "bit_equal_to_lu_nserver": True,
                       "inline_strips": again.fleet_report.inline_strips}

    # the bulk flush: SPDC_GATEWAY_BULK's 128 requests in one sweep
    n = GATEWAY_FULL_N
    bulk = [dominant(rng, (n, n)) for _ in range(GATEWAY_BULK)]
    flushes = []
    gw = SPDCGateway(SPDC_GATEWAY_BULK, device=dev, on_flush=flushes.append)
    rids, submit_s = wall(lambda: [gw.submit(m) for m in bulk])
    rb = [gw.take(r) for r in rids]
    check(len(flushes) == 1 and flushes[0].batch == GATEWAY_BULK,
          "one bulk flush")
    worst = gateway_checks(rb, bulk, dev, "bulk flush")
    out["bulk"] = {"preset": SPDC_GATEWAY_BULK.name, "requests": len(bulk),
                   "n": n, "pad_to": rb[0].pad_to,
                   "flush_wall_s": flushes[0].sweep_s,
                   "dets_per_s": len(bulk) / flushes[0].sweep_s,
                   "submit_loop_s": submit_s, "max_dlogabs": worst,
                   "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def gateway_launcher() -> dict:
    """`python -m repro_torch.launch.serve_spdc --smoke --device cuda` as
    a subprocess: exit 0 and its check line."""
    import os

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_spdc", "--smoke",
         "--device", "cuda"], capture_output=True, text=True, env=env,
        timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0,
          f"serve_spdc --smoke exited {proc.returncode}: {proc.stderr[-2000:]}")
    check_line = [ln.strip() for ln in lines if "check: all" in ln]
    check(bool(check_line) and "dets match" in check_line[0],
          f"serve_spdc --smoke printed no check line: {lines}")
    return {"command": "python -m repro_torch.launch.serve_spdc --smoke "
                       "--device cuda",
            "seconds": time.perf_counter() - t0, "output": lines}


def phase_gateway(rng, dev, addrs) -> dict:
    """The SPDC gateway on the card (see the GATEWAY_* sizes). Returns
    the phase's launches, the full flush's and each kernel's max abs
    error against its plain version at the flushes' shapes."""
    from repro_torch.kernels import ops

    phase_t0 = time.perf_counter()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    swarm, samples = gateway_swarm(rng, dev)
    full, stack = gateway_full_flush(rng, dev)
    small = gateway_small_flushes(rng, dev, addrs)
    launches = dict(ops.LAUNCHES)
    # after the counts are read: these launches only compare
    errs = gateway_vs_plain(dev, samples, stack)
    del stack
    launcher = gateway_launcher()
    phase_s = time.perf_counter() - phase_t0
    emit({"phase": "gateway", "servers": N_SERVERS, "dtype": "float64",
          "preset": "spdc-gateway", "swarm": swarm, "full_flush": full,
          **small, "launcher": launcher, "launches": launches,
          "phase_s": phase_s})
    check(phase_s <= GATEWAY_BUDGET_S,
          f"the gateway phase took {phase_s:.1f} s")
    return {"launches": launches, "flush": full["launches"], "errs": errs}


def phase_daemons(rng, dev, rng_linalg, rng_gateway) -> tuple[dict, ...]:
    """Spawn the socket phases' daemons, run both phases on them, the
    gateway phase and the linalg phase (each from its own stream), stop
    them. Returns the socket and rateless phases' client launches and
    the gateway and linalg phases' results."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip-smoke-sock-")
    procs = []
    try:
        addrs, procs, spawn_s = spawn_daemons(N_SERVERS, root)
        socket_launches = phase_socket(rng, dev, addrs, spawn_s)
        rateless_launches = phase_rateless(rng, dev, addrs)
        gateway = phase_gateway(rng_gateway, dev, addrs)
        linalg = phase_linalg(rng_linalg, dev, addrs)
    finally:
        for proc in procs:
            proc.terminate()
        for proc in procs:
            proc.join(timeout=10)
        shutil.rmtree(root, ignore_errors=True)
    return socket_launches, rateless_launches, gateway, linalg


def gp_objectives(x: torch.Tensor, y: torch.Tensor, ctx):
    """The negative log marginal likelihood of examples/gp_loglik.py, RBF
    Σ(θ) on x, through the secure ops on `ctx` and through torch.linalg:
    (secure, plain) functions of θ = (log ℓ, log σf, log σn)."""
    from repro_torch.linalg import secure_slogdet, secure_solve

    n = x.shape[0]

    def objective(slogdet, solve):
        def nll(theta):
            d2 = (x[:, None] - x[None, :]) ** 2
            k = torch.exp(2 * theta[1]) * torch.exp(
                -0.5 * d2 / torch.exp(2 * theta[0]))
            cov = k + torch.exp(2 * theta[2]) * torch.eye(
                n, dtype=x.dtype, device=x.device)
            _, logdet = slogdet(cov)
            return 0.5 * (logdet + y @ solve(cov, y) + n * math.log(2 * math.pi))
        return nll

    return (objective(lambda c: secure_slogdet(c, linalg=ctx),
                      lambda c, v: secure_solve(c, v, linalg=ctx)),
            objective(torch.linalg.slogdet, torch.linalg.solve))


def value_and_grad(fn, theta0) -> tuple[float, torch.Tensor]:
    theta = theta0.clone().requires_grad_(True)
    value = fn(theta)
    value.backward()
    return float(value.detach()), theta.grad


def phase_linalg(rng, dev, addrs) -> dict:
    """The secure linalg slice at n = 4096 f64, N = 4: one LinalgSession's
    slogdet, solve, adjoint solve and inverse on one factorization,
    inline; the inverse round profiled (its legs' launches, no library
    trsm) and its chunks against one wide call; a tamper healed; the
    inverse round through the thread pool and the socket daemons at
    `addrs`; outsource_inverse; an f32 session; the GP objective's value
    and gradient against torch autograd. Returns the path's launches, the
    legs' launches and errors, and the legs' operands for the kernels
    line."""
    import dataclasses

    from repro_torch import ServerFault, ThreadPoolTransport, outsource_inverse
    from repro_torch.api import EdgeServer, InlineTransport
    from repro_torch.api.server import _to_device
    from repro_torch.api.socket_transport import SocketTransport
    from repro_torch.kernels import ops, ref, trsm
    from repro_torch.linalg import LinalgSession, SecureLinalg

    class Recording(InlineTransport):
        """The inline transport, keeping each round's tasks and results."""

        def __init__(self):
            super().__init__()
            self.rounds = []

        def solve_shards(self, tasks, faults=(), timeout=None):
            out = super().solve_shards(tasks, faults=faults, timeout=timeout)
            self.rounds.append((tasks, out))
            return out

    phase_t0 = time.perf_counter()
    n, f64 = SINGLE_N, torch.float64
    m = dominant(rng, (n, n))
    b = rng.standard_normal((n, LINALG_RHS))
    md, bd = torch.from_numpy(m).to(dev), torch.from_numpy(b).to(dev)
    recorder = Recording()

    def op_plan():
        s = LinalgSession(m, N_SERVERS, transport=recorder)
        return s, s.slogdet(), s.solve(b), s.solve(b, transpose=True), s.inv()

    (s, (sign, logabs), y, yt, inv), launches = run_counted(ops, op_plan)
    legs = dict(ops.TRSM_LEFT_LEGS)
    tol = LINALG_TOL[f64]
    want_sign, want_logabs = (float(v) for v in torch.linalg.slogdet(md))
    check(sign == want_sign and abs(logabs - want_logabs)
          <= tol * abs(want_logabs), f"slogdet {sign} {logabs} vs "
          f"{want_sign} {want_logabs}")
    against = {}
    for name, got, want in (("solve", y, torch.linalg.solve(md, bd)),
                            ("solve_t", yt, torch.linalg.solve(md.T, bd)),
                            ("inv", inv, torch.linalg.inv(md))):
        err, rel = max_err(got, want)
        check(err <= tol, f"{name}: max|err| {err} against torch.linalg")
        against[name] = {"max_abs_err": err, "rel": rel}
    records = {o.op: o for o in s.report.ops}
    check(s.factorizations == 1, f"{s.factorizations} factorizations")
    check(all(o.verified for o in s.report.ops), "an op is not verified")
    check(all(records[o].residual <= s._tolerance()
              for o in ("solve", "solve_t", "inv")), "a round's residual")
    rounds = 3 * N_SERVERS
    check(all(legs[k] > 0 for k in TRISOLVE_LEGS)
          and sum(legs.values()) == 2 * rounds == launches["trsm_left"],
          f"leg launches {legs}")
    # the inverse round under the profiler: 8 wrapper calls, each
    # trsm.cuda_launches(n') kernels of csrc/trsm.cu, and no trsm of a
    # library
    def inverse_round():
        s._inv_cache = None
        return s.inv()

    before = dict(ops.TRSM_LEFT_LEGS)
    events, round_host_s, _ = device_events(inverse_round, 1)
    calls = sum(ops.TRSM_LEFT_LEGS.values()) - sum(before.values())
    n_aug = s._x_aug.shape[-1]
    solver = [e for e in events
              if short_name(e.name) in ("leaf_kernel", "update_kernel")]
    library = sorted({e.name for e in events if "trsm" in e.name.lower()})
    check(calls == 2 * 2 * N_SERVERS, f"{calls} leg calls in two rounds")
    check(len(solver) == 2 * N_SERVERS * trsm.cuda_launches(n_aug),
          f"{len(solver)} solver launches in the inverse round")
    check(not library, f"library trsm kernels in the round: {library}")
    check(torch.equal(s.inv(), inv), "the re-run inverse round differs")
    solver_ms = sum(e.time_range.elapsed_us() for e in solver) / 1e3
    # the split property: the round's chunks are one wide call's columns
    tasks, results = recorder.rounds[-1]
    wide_task = dataclasses.replace(
        tasks[0], rhs=np.concatenate([t.rhs for t in tasks], axis=1))
    wide = EdgeServer(0, device=dev).run(wide_task)
    check(np.array_equal(wide.y, np.concatenate([r.y for r in results], axis=1)),
          "the inverse round's chunks differ from one wide call")
    # what a chunk's factors cost to reach the server's card (pageable)
    _, upload_s = wall(lambda: (_to_device(tasks[0].l, dev),
                                _to_device(tasks[0].u, dev)))
    # server 1 tampers with its strip and its chunk: both healed
    bad = LinalgSession(m, N_SERVERS, faults=ServerFault(**LINALG_TAMPER_KW))
    healed_inv, healed_s = wall(bad.inv)
    bad_ops = {o.op: o for o in bad.report.ops}
    check(bad_ops["inv"].healed >= 1 and bad_ops["inv"].verified,
          f"tampered inverse round healed {bad_ops['inv'].healed}")
    check(bad.report.recovery is not None
          and bad.report.recovery.servers_replaced == (1,),
          "the tampered factorization was not healed from server 1")
    check(torch.equal(healed_inv, inv), "healed inverse differs")
    with ThreadPoolTransport() as tp:
        pooled = LinalgSession(m, N_SERVERS, transport=tp)
        pooled_inv, pooled_s = wall(pooled.inv)
    check(torch.equal(pooled_inv, inv), "thread-pool inverse differs")
    with SocketTransport(addrs, connect_timeout=DAEMON_BIND_S) as st:
        sock = LinalgSession(m, N_SERVERS, transport=st)
        sock_inv, sock_s = wall(sock.inv)
    check(torch.equal(sock_inv, inv), "socket inverse differs")
    facade, facade_s = wall(lambda: outsource_inverse(m, N_SERVERS))
    check(facade.verified and facade.residual < 1e-6,
          f"outsource_inverse {facade.verified} {facade.residual}")
    # f32 against the card's f64 inverse of the same matrix
    m32 = dominant(rng, (LINALG_F32_N, LINALG_F32_N)).astype(np.float32)
    s32 = LinalgSession(m32, N_SERVERS)
    inv32 = s32.inv()
    err32, rel32 = max_err(inv32.double(), torch.linalg.inv(
        torch.from_numpy(m32.astype(np.float64)).to(dev)))
    check(inv32.dtype == torch.float32 and rel32 <= LINALG_TOL[torch.float32],
          f"f32 inverse rel err {rel32}")
    # the GP objective at n = 4096, examples/gp_loglik.py's data
    gx = np.sort(rng.uniform(-3.0, 3.0, n))
    gy = np.sin(2.0 * gx) + 0.5 * gx + 0.1 * rng.standard_normal(n)
    ctx = SecureLinalg(N_SERVERS)
    secure, plain = gp_objectives(torch.from_numpy(gx).to(dev),
                                  torch.from_numpy(gy).to(dev), ctx)
    theta = torch.tensor([math.log(0.8), 0.0, math.log(0.2)], dtype=f64,
                         device=dev)
    ((val, grad), gp_launches), gp_s = wall(
        lambda: counted(ops, lambda: value_and_grad(secure, theta)))
    (pval, pgrad), plain_s = wall(lambda: value_and_grad(plain, theta))
    gerr = float((grad - pgrad).abs().max() / pgrad.abs().max())
    gp_sessions = list(ctx._sessions.values())
    check(abs(val - pval) <= GP_VALUE_RTOL * abs(pval), f"GP {val} vs {pval}")
    check(gerr <= GP_GRAD_TOL, f"GP gradient error {gerr}")
    check(len(gp_sessions) == 1 and gp_sessions[0].factorizations == 1
          and all(o.verified for o in gp_sessions[0].report.ops),
          "GP sessions")
    # each leg on these factors against its plain version, at both chunk
    # shapes of the op plan: the inverse round's (n' x n'/N) and the
    # narrow rounds' (n' x LINALG_RHS/N)
    l_f, u_f = s._factors
    rhs = torch.from_numpy(rng.standard_normal((n_aug, n_aug // N_SERVERS))
                           ).to(dev)
    narrow = torch.from_numpy(
        rng.standard_normal((n_aug, LINALG_RHS // N_SERVERS))).to(dev)
    leg_errs, narrow_errs = {}, {}
    for leg, (upper, trans, _) in TRISOLVE_LEGS.items():
        t = u_f if upper else l_f
        for cols, errs in ((rhs, leg_errs), (narrow, narrow_errs)):
            err, rel = max_err(
                ops.trsm_left(t, cols, upper=upper, transpose_t=trans),
                ref.trsm_left_ref(t, cols, upper=upper, transpose_t=trans))
            check(rel <= RTOL, f"trisolve leg {leg} at {tuple(cols.shape)}: "
                  f"{rel} of max|plain|")
            errs[f"trsm:trisolve_{leg}"] = err
    wall_of = {o.op: o.wall_s for o in s.report.ops}
    emit({"phase": "linalg", "n": n, "servers": N_SERVERS, "dtype": "float64",
          "rhs_cols": LINALG_RHS, "transport": "inline",
          "factorizations": s.factorizations,
          "factor_s": wall_of["factor"],
          "round_wall_s": {k: wall_of[k] for k in ("solve", "solve_t", "inv")},
          "round_residual": {k: records[k].residual
                             for k in ("solve", "solve_t", "inv")},
          "round_tolerance": s._tolerance(),
          "slogdet": [sign, logabs], "slogdet_torch": [want_sign, want_logabs],
          "against_torch": against, "launches": launches, "leg_calls": legs,
          "inverse_round": {
              "leg_calls": calls // 2,
              "solver_launches": len(solver),
              "solver_device_ms": solver_ms,
              "leg_device_ms_per_call": solver_ms / (2 * N_SERVERS),
              "host_s": round_host_s, "library_trsm_events": library,
              "chunks_bit_equal_to_one_wide_call": True,
              "factor_upload_s_per_chunk": upload_s,
              "transpose": tasks[0].transpose},
          "tamper_server1": {"healed": bad_ops["inv"].healed,
                             "factor_servers_replaced": list(
                                 bad.report.recovery.servers_replaced),
                             "bit_equal_to_honest": True, "wall_s": healed_s},
          "threadpool": {"bit_equal_to_inline": True, "wall_s": pooled_s},
          "socket": {"daemons": len(addrs), "bit_equal_to_inline": True,
                     "wall_s": sock_s},
          "outsource_inverse": {"verified": facade.verified,
                                "residual": facade.residual, "eps": 1e-6,
                                "wall_s": facade_s},
          "f32": {"n": LINALG_F32_N, "max_abs_err": err32, "rel": rel32,
                  "bar": LINALG_TOL[torch.float32]},
          "gp": {"n": n, "value": val, "plain_value": pval,
                 "value_rel": abs(val - pval) / abs(pval), "grad_err": gerr,
                 "factorizations": gp_sessions[0].factorizations,
                 "secure_s": gp_s, "plain_s": plain_s,
                 "launches": gp_launches},
          "legs_vs_plain": leg_errs, "legs_vs_plain_narrow": {
              "shape": list(narrow.shape), "max_abs_err": narrow_errs},
          "phase_s": time.perf_counter() - phase_t0})
    return {"launches": launches, "legs": legs, "errs": leg_errs,
            "operands": (l_f, u_f, rhs)}


def witness_matrix(seed: int, n: int) -> np.ndarray:
    """standard_normal rounded to multiples of 2^-16, plus n·I. Every
    partial sum of its entries is exact in float64, so SeedGen's mean, and
    with it the keys and the ciphertext, are the same on every machine;
    numpy's pairwise sum of unrounded entries differs in its last bits
    between CPUs and numpy versions."""
    z = np.random.default_rng(seed).standard_normal((n, n))
    return np.round(z * 2.0**16) / 2.0**16 + n * np.eye(n)


def witness_runs(ops) -> tuple[dict, dict]:
    """The default-magnitude in-band tamper on the witness matrix, per
    method, held to the reference's verdict and culprit."""
    import hashlib

    from repro_torch import ServerFault, SPDCClient

    m = witness_matrix(WITNESS_SEED, SINGLE_N)
    out, launches = {}, {}
    for method, (want_ok, want_culprit) in WITNESS_REFERENCE.items():
        session = SPDCClient(method=method).open_session(
            m, N_SERVERS,
            faults=ServerFault(server=2, mode="single", in_band=True))
        digest = hashlib.sha256(
            session.x_aug.cpu().contiguous().numpy().tobytes()).hexdigest()
        check(digest == WITNESS_X_AUG_SHA256,
              f"witness {method}: the ciphertext is not the reference's")
        res, counted = run_counted(ops, session.run)
        verdict = res.report.verdict
        out[method] = {"verified": bool(res.verified),
                       "culprit": int(verdict.culprit),
                       "residual": float(verdict.residual),
                       "eps": float(verdict.eps),
                       "reference": {"verified": want_ok,
                                     "culprit": want_culprit},
                       "seed_digest": session.digest.hex(),
                       "x_aug_sha256": digest}
        check(bool(res.verified) == want_ok
              and int(verdict.culprit) == want_culprit,
              f"witness {method}: {res.verified} culprit {verdict.culprit},"
              f" the reference gives {want_ok} culprit {want_culprit}")
        for name, count in counted.items():
            launches[name] = launches.get(name, 0) + count
    return out, launches


def phase_faults(rng) -> dict:
    """Tampering servers on the message path and in the sweep."""
    import repro_torch
    from repro_torch import ServerFault, ThreadPoolTransport
    from repro_torch.kernels import ops

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    with ThreadPoolTransport() as tp:
        block, launches = run_counted(ops, lambda: repro_torch.outsource_determinant(
            m, N_SERVERS, transport=tp,
            faults=ServerFault(server=1, mode="block", magnitude=0.3)))
    check(not block.verified and block.report.verdict.culprit == 1,
          f"thread-pool block tamper: {block.verified} "
          f"culprit {block.report.verdict.culprit}")
    # On the witness matrix at this n the JAX reference accepts server 2's
    # in-band single tamper at its default 5% magnitude, under q3 and q1
    # alike (witness_runs below holds the port to the reference's
    # verdicts); whether q1 sees it depends on the ciphertext. The rejected case
    # is sized from the honest run's threshold: the element becomes
    # x·(1 + g) + g with g = 1000·ε(N). Q1's probe sees every entry; Q3
    # sees only the diagonal of L·U, which the downstream servers keep
    # consistent.
    honest = repro_torch.outsource_determinant(m, N_SERVERS, method="q1")
    check(honest.verified, "honest q1 run of the faults phase")
    gain = 1e3 * honest.report.verdict.eps
    in_band, launches_b = run_counted(ops, lambda: repro_torch.outsource_determinant(
        m, N_SERVERS, method="q1",
        faults=ServerFault(server=2, mode="single", in_band=True,
                           magnitude=gain)))
    check(not in_band.verified and in_band.report.verdict.culprit == 2,
          f"in-band single tamper: {in_band.verified} "
          f"culprit {in_band.report.verdict.culprit}")
    witness, launches_w = witness_runs(ops)
    for name in launches:
        launches[name] += launches_b[name] + launches_w.get(name, 0)
    emit({"phase": "faults",
          "rotate_k": block.meta.rotate_k,
          "threadpool_block_server1": {
              "verified": block.verified,
              "culprit": int(block.report.verdict.culprit),
              "residual": block.residual,
              "eps": block.report.verdict.eps, "method": "q3"},
          "inline_in_band_single_server2": {
              "verified": in_band.verified,
              "culprit": int(in_band.report.verdict.culprit),
              "residual": in_band.residual, "magnitude": gain,
              "eps": in_band.report.verdict.eps, "method": "q1"},
          "witness_in_band_single_server2_default_magnitude": witness,
          "launches": launches})
    return launches


def phase_profile(rng) -> None:
    """One warm single-matrix run under torch.profiler: device time by
    kernel and the share of the wall time the card was busy."""
    import repro_torch

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    results = []
    events, host_s, _ = device_events(
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


def route_cases(rng, dev, dtype):
    """{kernel: {case: operands}} at the shapes lu_blocked(x, 1024) gives
    each kernel, in `dtype`: the panel at 32² and the (16, 32, 32) stack;
    the triangular solves at 1024³ and on the 32-wide strips of a
    diagonal tile; the Schur update at 1024³ and the K = 32 inner update
    (strided views of a 1024² tile)."""
    b = SEQ_BLOCK

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)

    tile = torch.from_numpy(dominant(rng, (b, b))).to(dev, dtype)
    tri = tile[:INNER, :INNER]
    l, u = triangles(rng, dev, (), b, dtype)
    return {
        "lu_panel": {
            "32x32": (torch.from_numpy(dominant(rng, (INNER, INNER))).to(dev, dtype),),
            "(16, 32, 32)": (torch.from_numpy(
                dominant(rng, (BATCH, INNER, INNER))).to(dev, dtype),)},
        "trsm_lower": {"1024^3": (l, draw(b, b)),
                       "32x32 vs 32x992 strided": (tri, tile[:INNER, INNER:])},
        "trsm_upper_right": {"1024^3": (u, draw(b, b)),
                             "992x32 vs 32x32 strided": (tri, tile[INNER:, :INNER])},
        "schur_update": {"1024^3": (draw(b, b), draw(b, b), draw(b, b)),
                         "992x32x992 strided": (tile[INNER:, INNER:],
                                                tile[INNER:, :INNER],
                                                tile[:INNER, INNER:])},
    }


def phase_routes(rng, dev) -> dict:
    """The mixed routes (every pair), the f32 default routes and the
    narrow half routes of the panel and the triangular solves against
    their plain versions at the shapes lu_blocked gives them (the narrow
    ones bit for bit); returns max errors by kernels-line row
    ("<kernel>:<route>")."""
    from repro_torch.kernels import ops, ref

    errs = {}
    routes = [(name, st, acc, MIXED_ULPS * torch.finfo(st).eps)
              for name, st, acc, _ in MIXED_ROUTES]
    routes.append(("f32", torch.float32, None, F32_RTOL))
    routes += [(name, st, None, 0.0) for name, st, _, _ in NARROW_ROUTES]
    for route, st, acc, tol in routes:
        cases = route_cases(rng, dev, st)
        if acc is None:  # phase 7 and the mixed routes hold these Schur routes
            del cases["schur_update"]
        line = {}
        for kernel, shaped in cases.items():
            worst = 0.0
            for label, operands in shaped.items():
                got = getattr(ops, kernel)(*operands, acc_dtype=acc)
                want = getattr(ref, f"{kernel}_ref")(*operands, acc)
                torch.cuda.synchronize()
                abs_err, rel = max_err(got.double(), want.double())
                check(got.dtype == st, f"{kernel}:{route} stored {got.dtype}")
                check(rel <= tol, f"{kernel}:{route} {label}: {rel} > {tol}")
                line[f"{kernel} {label}"] = {"max_abs_err": abs_err,
                                             "max_rel_err": rel}
                worst = max(worst, abs_err)
            errs[f"{kernel}:{route}"] = worst
        emit({"phase": "kernel_vs_plain", "kernel": "routes", "route": route,
              "storage": str(st), "arithmetic": str(acc or st),
              "cases": line, "tolerance": f"{tol} * max|plain|"})
    return errs


def phase_f32_protocol(rng, dev) -> tuple[dict, dict]:
    """The f32 protocol on the card: matrix products in full f32 (no
    TF32), then a single n = 4096 and a 16 × 1024 stack, inline, against
    the card's f64 slogdet. Returns the single run's launches and the
    stack's."""
    import repro_torch
    from repro_torch.kernels import ops

    check(torch.backends.cuda.matmul.allow_tf32 is False, "TF32 matmul on")
    check(torch.get_float32_matmul_precision() == "highest",
          f"f32 matmul precision {torch.get_float32_matmul_precision()}")
    # lu_nserver's Schur terms are torch.matmul: an f32 product summed in
    # f32 errs by at most K·2^-24·|A|·|B| elementwise; held normwise to
    # K·2^-24·max|A·B|, which TF32 (operands rounded to 2^-11) misses
    # by an order of magnitude at K = 1024
    k = SEQ_BLOCK
    a, b = (torch.from_numpy(rng.standard_normal((k, k))).to(dev, torch.float32)
            for _ in range(2))
    exact = a.double() @ b.double()
    mm_err = float(((a @ b).double() - exact).abs().max())
    mm_bound = k * 2.0**-24 * float(exact.abs().max())
    check(mm_err <= mm_bound, f"f32 matmul err {mm_err} > {mm_bound}")

    def run_and_check(m, label):
        res, launches = run_counted(ops, lambda: repro_torch.outsource_determinant(
            m, N_SERVERS, dtype="float32"))
        want = slogdet_det(torch.from_numpy(m).to(dev))
        got_dets = res.dets if m.ndim == 3 else [res.det]
        wants = want if m.ndim == 3 else [want]
        dlog = [g.logabs - w.logabs for g, w in zip(got_dets, wants)]
        check(bool(np.all(res.verified)), f"f32 {label} verified {res.verified}")
        check(all(g.sign == w.sign for g, w in zip(got_dets, wants)),
              f"f32 {label} signs")
        check(max(abs(d) for d in dlog) <= F32_DLOG, f"f32 {label} dlog {dlog}")
        warm, warm_s = wall(lambda: repro_torch.outsource_determinant(
            m, N_SERVERS, dtype="float32"))
        check(bool(np.all(warm.verified)), f"f32 {label} warm run")
        return res, launches, {
            "verified": int(np.sum(res.verified)),
            "max_abs_dlogabs": max(abs(d) for d in dlog),
            "residual": float(np.max(res.residual)),
            "eps": float(np.max(res.report.verdict.eps)),
            "launches": launches, "warm_wall_s": warm_s,
            "warm_timings": timings(warm)}

    single, launches, single_line = run_and_check(
        dominant(rng, (SINGLE_N, SINGLE_N)), "single")
    check(launches["ced"] == 1, f"f32 ced launches {launches['ced']}")
    for name, count in expected_launches(SINGLE_N).items():
        check(launches[name] == count, f"f32 {name} launches {launches[name]}")
    _, batch_launches, batch_line = run_and_check(
        dominant(rng, (BATCH, BATCH_N, BATCH_N)), "batch")
    emit({"phase": "f32_protocol", "servers": N_SERVERS, "dtype": "float32",
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "matmul_1024_max_abs_err": mm_err, "matmul_bound": mm_bound,
          "single": {"n": SINGLE_N, "rotate_k": single.meta.rotate_k,
                     **single_line},
          "batch": {"shape": [BATCH, BATCH_N, BATCH_N], **batch_line}})
    return launches, batch_launches


def phase_sequential_routes(rng, dev) -> dict:
    """lu_blocked(x32, 1024), plain f32 (the f32 Schur route) and mixed
    (acc_dtype=float64), at n = 4096: warm wall, launches by kernel, the
    device kernels' routes, the Schur kernels' device ms per call, and
    each one's distance from the f64 factorization; then bf16 and f16,
    narrow, with acc_dtype=float32 and with acc_dtype=float64. Returns
    {route: launches}."""
    from repro_torch.core.lu import lu_blocked
    from repro_torch.kernels import ops

    x = torch.from_numpy(dominant(rng, (SINGLE_N, SINGLE_N))).to(dev)
    x32 = x.float()
    l64, u64 = lu_blocked(x, SEQ_BLOCK)
    nb, panels = SINGLE_N // SEQ_BLOCK, SEQ_BLOCK // INNER
    want_counts = {"ced": 0, "lu_panel": nb * panels,
                   "trsm_lower": nb * (panels - 1) + nb * (nb - 1) // 2,
                   "trsm_upper_right": nb * (panels - 1) + nb * (nb - 1) // 2,
                   "schur_update": sum(k * k for k in range(nb))
                   + nb * (panels - 1), "trsm_left": 0,
                   "flash_attention": 0, "flash_attention_backward": 0,
                   "flash_decode_partial": 0, "flash_combine": 0}
    targs_of = {n: t for n, _, _, t in (*MIXED_ROUTES, *NARROW_ROUTES)}

    def run_route(route, xr, acc):
        """lu_blocked on one route: (factors, its line's launches, device
        kernels and Schur ms, warm wall), launches and kernels checked."""
        targs = targs_of.get(route, "float, float")
        (l, u), launches = run_counted(
            ops, lambda: lu_blocked(xr, SEQ_BLOCK, acc_dtype=acc))
        check(launches == want_counts, f"lu_blocked {route} launches {launches}")
        check(l.dtype == u.dtype == xr.dtype, f"lu_blocked {route} {l.dtype}")
        kernels, schur_ms = route_profile(
            lambda: lu_blocked(xr, SEQ_BLOCK, acc_dtype=acc))
        check(schur_kernel(route) in kernels
              and all(f"<{targs}" in k or k == schur_kernel(route)
                      for k in kernels),
              f"lu_blocked {route} ran {kernels}")
        _, warm_s = wall(lambda: lu_blocked(xr, SEQ_BLOCK, acc_dtype=acc))
        return (l, u), {"launches": launches, "kernels": kernels,
                        "schur_device_ms": schur_ms, "warm_wall_s": warm_s}

    out, lines = {}, {}
    for route, acc in (("f32", None), ("f32_f64", torch.float64)):
        (l, u), lines[route] = run_route(route, x32, acc)
        out[route] = lines[route]["launches"]
        lines[route]["residual"] = float(
            (l.double() @ u.double() - x32.double()).abs().max()
            / x32.double().abs().max())
        lines[route]["distance_from_f64"] = max(
            float((f.double() - g).abs().max() / g.abs().max())
            for f, g in ((l, l64), (u, u64)))
    check(lines["f32_f64"]["residual"] < lines["f32"]["residual"],
          "mixed lu_blocked residual not below plain f32's")
    check(lines["f32_f64"]["distance_from_f64"] < lines["f32"]["distance_from_f64"],
          "mixed lu_blocked not nearer the f64 factors than plain f32")
    # the half routes, narrow, f32 and wide, on the same matrix rounded to
    # the half type; maxima cannot tell them apart (both are set by U's
    # largest entries' rounding to the storage type), norms can. The f32
    # route's residual and distance are read, not gated
    for half, narrow, mid, wide in HALF_SEQUENTIAL:
        xh = x.to(half)
        xd = xh.double()
        lh64, uh64 = lu_blocked(xd, SEQ_BLOCK)
        for route, acc in ((narrow, None), (mid, torch.float32),
                           (wide, torch.float64)):
            (l, u), line = run_route(route, xh, acc)
            check(bool(torch.isfinite(l).all() and torch.isfinite(u).all()),
                  f"lu_blocked {route} factors not finite")
            line["residual_normwise"] = float(
                torch.linalg.norm(l.double() @ u.double() - xd)
                / torch.linalg.norm(xd))
            line["distance_from_f64_normwise"] = max(
                float(torch.linalg.norm(f.double() - g) / torch.linalg.norm(g))
                for f, g in ((l, lh64), (u, uh64)))
            out[route], lines[route] = line["launches"], line
        check(lines[wide]["residual_normwise"] < lines[narrow]["residual_normwise"],
              f"{wide} lu_blocked residual not below {narrow}'s")
        check(lines[wide]["distance_from_f64_normwise"]
              < lines[narrow]["distance_from_f64_normwise"],
              f"{wide} lu_blocked not nearer the f64 factors than {narrow}")
    emit({"phase": "sequential_routes", "n": SINGLE_N, "block": SEQ_BLOCK,
          "residual": "max|L·U - X| / max|X| in f64",
          "distance_from_f64": "max over L, U of max|F - F64| / max|F64|, "
                               "F64 the f64 lu_blocked of the same matrix",
          "residual_normwise": "||L·U - X||_F / ||X||_F in f64, X the "
                               "matrix rounded to the half type",
          "distance_from_f64_normwise": "max over L, U of ||F - F64||_F / "
                                        "||F64||_F, F64 the f64 lu_blocked "
                                        "of X",
          "schur_device_ms": "the Schur kernels' summed device ms in one "
                             "profiled call",
          **lines})
    return out


def healed_factors(session, result) -> bool:
    """Whether the factors Session.collect healed on this run and
    Decipher read (RecoveryReport.factors) are the honest sweep's of the
    same session, bit for bit."""
    from repro_torch.core.lu import lu_nserver

    rep = result.report.recovery
    honest = lu_nserver(session.x_aug, N_SERVERS)[:2]
    return (rep is not None and rep.ok and rep.rounds >= 1
            and same_factors(rep.factors, honest))


def phase_recovery(rng, dev, multiprocess: dict) -> dict:
    """Verification-driven recovery at n = 4096 f64, N = 4, standby 1: a
    reported tamper by server 2 on the inline and thread-pool transports
    (worker processes: `multiprocess`, from phase 10's workers), an
    in-band tamper of 1e-3·max|U| by server 2 inline, and a 16 × 1024 f32
    stack with one matrix's strip dropped."""
    import repro_torch
    from repro_torch import ServerFault, SPDCClient, ThreadPoolTransport
    from repro_torch.api import InlineTransport
    from repro_torch.core.faults import _tamper_position
    from repro_torch.core.lu import lu_block_row
    from repro_torch.kernels import ops

    m = dominant(rng, (SINGLE_N, SINGLE_N))
    honest = repro_torch.outsource_determinant(m, N_SERVERS)
    check(honest.verified, "recovery phase honest run")
    reported = ServerFault(**REPORTED_TAMPER_KW)
    healer = SPDCClient(recover=True, standby=1)
    inline_session = healer.open_session(m, N_SERVERS, faults=reported)
    inline, launches = run_counted(ops, inline_session.run)
    line = {"inline_reported_server2": recovery_case(inline, honest, "inline")}
    check(healed_factors(inline_session, inline),
          "inline healed factors differ from the honest run's")
    # what one re-dispatched shard costs: server 2's block row computed
    # in place, and the same re-dispatch as the inline transport runs it
    # (a ShardTask through host memory, an EdgeServer on the card, the
    # strips back), beside the whole sweep
    session = healer.open_session(m, N_SERVERS)
    inline_tp = InlineTransport()
    (_, u_sweep), sweep_s = wall(lambda: inline_tp.sweep(session.x_aug,
                                                         N_SERVERS))
    _, row_s = wall(lambda: lu_block_row(session.x_aug, u_sweep, 2, N_SERVERS))
    _, repair_s = wall(lambda: inline_tp.repair(
        session._repair_task(2, 1, u_sweep), replacement=N_SERVERS))
    line["shard_cost_server2"] = {"sweep_s": sweep_s, "lu_block_row_s": row_s,
                                  "inline_repair_s": repair_s}
    with ThreadPoolTransport() as tp:
        pooled, pool_launches = run_counted(
            ops, lambda: healer.open_session(m, N_SERVERS,
                                             faults=reported).run(tp))
    line["threadpool_reported_server2"] = recovery_case(pooled, honest,
                                                        "threadpool")
    line["multiprocess_reported_server2"] = multiprocess
    # in band: the entry server 2's fault hits moves by 1e-3·max|U|
    # (x -> x(1 + g) + g), and the relay carries it downstream. Verified
    # under q1: q3 reads only the diagonal of L·U, which the downstream
    # servers keep consistent with the poisoned row (phase 11)
    b = SINGLE_N // N_SERVERS
    q1_healer = SPDCClient(method="q1", recover=True, standby=1)
    q1_honest = repro_torch.outsource_determinant(m, N_SERVERS, method="q1")
    session = healer.open_session(m, N_SERVERS)
    u_honest = InlineTransport().sweep(session.x_aug, N_SERVERS)[1]
    probe = ServerFault(server=2, mode="single", in_band=True)
    r, c = _tamper_position(probe, block=b, n=SINGLE_N, factor="u")
    entry = float(u_honest[2 * b + r, c])
    gain = 1e-3 * float(u_honest.abs().max()) / (entry + 1.0)
    in_band_fault = ServerFault(server=2, mode="single", in_band=True,
                                magnitude=gain)
    in_band_session = q1_healer.open_session(m, N_SERVERS,
                                             faults=in_band_fault)
    in_band, in_band_launches = run_counted(ops, in_band_session.run)
    line["inline_in_band_server2_q1"] = {
        **recovery_case(in_band, q1_honest, "inline in-band"),
        "magnitude": gain, "entry": entry, "shift": gain * (entry + 1.0)}
    check(healed_factors(in_band_session, in_band),
          "inline in-band healed factors differ from the honest run's")
    stack = dominant(rng, (BATCH, BATCH_N, BATCH_N))
    bad = BATCH // 3
    f32, f32_launches = run_counted(ops, lambda: repro_torch.outsource_determinant(
        stack, N_SERVERS, dtype="float32", recover=True, standby=1,
        faults=ServerFault(server=2, kind="dropout", matrices=(bad,))))
    want = slogdet_det(torch.from_numpy(stack).to(dev))
    rep = f32.report.recovery
    check(bool(np.all(f32.verified)) and rep is not None and rep.ok,
          f"f32 stack recovery {f32.verified}")
    check([e.matrices for e in rep.events] == [(bad,)],
          f"f32 stack spliced {[e.matrices for e in rep.events]}")
    dlog = [g.logabs - w.logabs for g, w in zip(f32.dets, want)]
    check(all(g.sign == w.sign for g, w in zip(f32.dets, want))
          and max(abs(d) for d in dlog) <= F32_DLOG, f"f32 stack dets {dlog}")
    line["f32_stack_dropout_server2"] = {
        "shape": [BATCH, BATCH_N, BATCH_N], "matrix": bad,
        "verified": int(np.sum(f32.verified)), "rounds": rep.rounds,
        "spliced": [list(e.matrices) for e in rep.events],
        "max_abs_dlogabs": max(abs(d) for d in dlog),
        "collect_s": f32.report.timings.collect_s,
        "dispatch_s": f32.report.timings.dispatch_s}
    for other in (pool_launches, in_band_launches, f32_launches):
        for name in launches:
            launches[name] += other[name]
    emit({"phase": "recovery", "n": SINGLE_N, "servers": N_SERVERS,
          "dtype": "float64", "standby": 1, **line,
          "healed_bit_equal_to_honest": {"inline_reported": True,
                                         "inline_in_band": True},
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
def expected_pipeline_launches(n: int) -> dict:
    """Launches of one pipeline sweep, reckoned from the code: per server
    the diagonal tile's panels and strips as in the inline sweep, one
    triangular solve of its whole block row (trsm_lower) and one
    L_{t,k} solve for each k < t (trsm_upper_right, N(N-1)/2 in all)."""
    b = n // N_SERVERS
    panels = math.ceil(b / INNER) if b >= 64 else 1
    inner = N_SERVERS * (panels - 1)
    return {"lu_panel": N_SERVERS * panels, "trsm_lower": inner + N_SERVERS,
            "trsm_upper_right": inner + N_SERVERS * (N_SERVERS - 1) // 2}


def kernel_operands(ops, fn):
    """(fn's result, {(wrapper, operand shapes): [calls, operands]}): the
    server kernels' wrappers swapped, for the call only, for ones that
    count their calls by operand shapes and keep a copy of the first
    call's operands of each."""
    seen: dict = {}
    saved = {name: getattr(ops, name) for name in SERVER_PATH}

    def keeping(name, wrapper):
        def call(*args, **kw):
            key = (name, *(tuple(a.shape) for a in args))
            if key not in seen:
                seen[key] = [0, [a.clone() for a in args]]
            seen[key][0] += 1
            return wrapper(*args, **kw)
        return call

    for name, wrapper in saved.items():
        setattr(ops, name, keeping(name, wrapper))
    try:
        return fn(), seen
    finally:
        for name, wrapper in saved.items():
            setattr(ops, name, wrapper)


def pipeline_trace(fn, mesh) -> dict:
    """One sweep of fn on `mesh` under torch.profiler: the relay's device
    copies against the mesh's hop log (count, bytes in order, each on its
    receiver's stream), the device copies outside the relay (only the
    scatter of X's block rows may make any), the CUDA stream each slot's
    kernels ran on (one per slot, none shared), the copies' device ms
    and the card's busy share over the sweep. Copies' bytes come from
    the window's Chrome trace (the events carry none)."""
    import tempfile

    from repro_torch.distrib.spdc_pipeline import (RELAY_RANGE, SCATTER_RANGE,
                                                   SLOT_RANGE)

    cuda = torch.autograd.DeviceType.CUDA
    with tempfile.TemporaryDirectory(prefix="chip-smoke-trace-") as tmp:
        trace = Path(tmp) / "trace.json"
        for _ in range(PROFILE_ATTEMPTS):
            everything, host_s = profiled(fn, 1, trace)
            events, lost, _ = timed_device_events(everything)
            PROFILE_WINDOWS["windows_losing_events"] += lost > 0
            if events and not lost:
                break
        check(bool(events) and not lost,
              f"pipeline profile: {len(events)} device events, {lost} lost")
        nbytes = {ev["args"]["correlation"]: ev["args"]["bytes"]
                  for ev in json.loads(trace.read_text())["traceEvents"]
                  if ev.get("cat") == "gpu_memcpy"}
    host = [e for e in everything if e.device_type != cuda]
    launched = {e.id: e.time_range.start for e in host
                if LAUNCH_CALL.match(e.name)}
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in host
              if e.name.startswith("spdc_pipeline.")]

    def where(event):
        at = launched[event.id]
        return next((name for name, lo, hi in ranges if lo <= at <= hi), None)

    copies = [e for e in events if e.name.startswith("Memcpy")
              and ("DtoD" in e.name or "PtoP" in e.name)]
    relay = sorted((e for e in copies if where(e) == RELAY_RANGE),
                   key=lambda e: launched[e.id])
    scattered = sum(where(e) == SCATTER_RANGE for e in copies)
    hops = list(mesh.hops)
    check(len(relay) == len(hops),
          f"{len(relay)} relay copies on the card, {len(hops)} hops logged")
    check([nbytes.get(e.id) for e in relay] == [h.nbytes for h in hops],
          "relay copies' bytes differ from the hop log's")
    check(len(copies) == len(relay) + scattered and scattered <= N_SERVERS,
          f"device copies outside the relay: {len(copies) - len(relay)}")
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    streams = {}
    for slot in mesh.slots:
        ids = {e.device_resource_id for e in kernels
               if where(e) == f"{SLOT_RANGE}{slot.index}"}
        check(len(ids) == 1, f"slot {slot.index}'s kernels on streams {ids}")
        streams[slot.index] = ids.pop()
    check(len(set(streams.values())) == N_SERVERS,
          f"slots share a stream: {streams}")
    check(all(e.device_resource_id == streams[h.dst]
              for e, h in zip(relay, hops)),
          "a relay copy ran off its receiver's stream")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -math.inf
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return {"device_copies": len(copies), "relay_copies": len(relay),
            "scatter_copies": scattered,
            "hop_device_ms": sum(e.time_range.elapsed_us() for e in relay) / 1e3,
            "hop_bytes": sum(h.nbytes for h in hops),
            "slot_kernels": {i: sum(where(e) == f"{SLOT_RANGE}{i}"
                                    for e in kernels) for i in streams},
            "device_events": len(events), "sweep_s": host_s,
            "busy_share": busy / (host_s * 1e6)}


def phase_pipeline(rng, dev) -> tuple[dict, dict]:
    """The multi-device pipeline (distributed=True: the shardmap
    transport, N slots on the card, each on a stream of its own, the
    relay a device copy a hop): n = 4096 f64 through the protocol,
    verified with the inline run's determinant and verdict; each program's
    factors against the inline sweep's on the session's ciphertext, its
    launches, warm wall and one profiled sweep (pipeline_trace); a
    16 x 1024 stack, n = 4096 in f32 and server 2's dropout healed; the
    panel and both solves against their plain versions at the shapes
    the phase gave them. Returns the single run's launches and its row
    solve (operands and calls) for the kernels line."""
    import repro_torch
    from repro_torch import ServerFault, SPDCClient
    from repro_torch.core.decipher import Determinant
    from repro_torch.core.lu import lu_nserver, slogdet_from_lu
    from repro_torch.core.verify import authenticate
    from repro_torch.distrib.spdc_pipeline import (ServerMesh,
                                                   lu_nserver_shardmap,
                                                   pipeline_collective_bytes)
    from repro_torch.kernels import ops, ref

    started = time.perf_counter()
    m = dominant(rng, (SINGLE_N, SINGLE_N))
    (res, operands), launches = run_counted(ops, lambda: kernel_operands(
        ops, lambda: repro_torch.outsource_determinant(m, N_SERVERS,
                                                       distributed=True)))
    want_counts = expected_pipeline_launches(SINGLE_N)
    check(launches["ced"] == 1, f"pipeline ced launches {launches['ced']}")
    for name, count in want_counts.items():
        check(launches[name] == count,
              f"pipeline {name} launches {launches[name]} != {count}")
    inline = repro_torch.outsource_determinant(m, N_SERVERS)
    want = slogdet_det(torch.from_numpy(m).to(dev))
    check(res.verified and inline.verified, "pipeline verified")
    # equal to the inline run's at the bar recovery holds a healed
    # determinant to (the factors differ in rounding: the Schur terms'
    # shapes differ), and within the protocol's gate of slogdet
    check(res.det.sign == inline.det.sign
          and math.isclose(res.det.logabs, inline.det.logabs, rel_tol=1e-10,
                           abs_tol=0.0),
          f"pipeline det {res.det} vs inline {inline.det}")
    check(res.det.allclose(want), f"pipeline det {res.det} vs slogdet {want}")
    check(res.comm is None and res.report.verdict.culprit
          == inline.report.verdict.culprit, "pipeline verdict")

    # each program on the session's ciphertext: verified, launches, the
    # determinant, warm wall and one profiled sweep; and on the plaintext,
    # whose LU has no growth, its factors against the inline sweep's.
    # The ciphertext's rotation can give the no-pivot LU a large growth,
    # under which no two LU orders agree to 1e-10 (ROADMAP §C), so the
    # factor bar holds where it means something, and the ciphertext's
    # factors are held by Authenticate and their determinant
    session = SPDCClient().open_session(m, N_SERVERS)
    x_aug, x_plain = session.x_aug, torch.from_numpy(m).to(dev)
    l_in, u_in, _ = lu_nserver(x_aug, N_SERVERS)
    l_pl, u_pl, _ = lu_nserver(x_plain, N_SERVERS)
    growth = float(u_in.abs().max() / x_aug.abs().max())
    want_aug = slogdet_det(x_aug)
    inline_s = [wall(lambda: lu_nserver(x_aug, N_SERVERS))[1] for _ in range(3)]
    programs = {}
    for program in PIPELINE_PROGRAMS:
        mesh = ServerMesh(N_SERVERS)

        def sweep(x=x_aug, mesh=mesh, program=program):
            return lu_nserver_shardmap(x, N_SERVERS, mesh=mesh,
                                       program=program)

        (l, u), counts = run_counted(ops, sweep)
        for name, count in want_counts.items():
            check(counts[name] == count,
                  f"{program} {name} launches {counts[name]} != {count}")
        verdict = authenticate(l, u, x_aug, num_servers=N_SERVERS,
                               method="q3", rng=np.random.default_rng(0))
        sign, logabs = slogdet_from_lu(l, u)
        det = Determinant(float(sign), float(logabs))
        check(bool(verdict.ok), f"{program}: Authenticate rejected")
        check(det.allclose(want_aug), f"{program} det {det} vs {want_aug}")
        pl, pu = sweep(x_plain)
        rel = max(max_err(pl, l_pl)[1], max_err(pu, u_pl)[1])
        check(rel <= PIPELINE_RTOL, f"{program} factors {rel} from inline")
        model = pipeline_collective_bytes(SINGLE_N, N_SERVERS)
        live = sum(h.nbytes for h in mesh.hops if h.src == h.round)
        programs[program] = {
            "verified_q3": bool(verdict.ok), "residual": float(verdict.residual),
            "dlogabs_vs_slogdet": det.logabs - want_aug.logabs,
            "max_rel_diff_vs_inline": {
                "plaintext": rel,
                "ciphertext": max(max_err(l, l_in)[1], max_err(u, u_in)[1])},
            "bit_equal_to_inline": {
                "plaintext": same_factors((pl, pu), (l_pl, u_pl)),
                "ciphertext": same_factors((l, u), (l_in, u_in))},
            "launches": {k: counts[k] for k in SERVER_PATH},
            "warm_wall_s": [wall(sweep)[1] for _ in range(3)],
            "hops": len(mesh.hops), "live_edge_bytes": live,
            **pipeline_trace(sweep, mesh),
            "model_relay_bytes": model["relay_bytes"],
            "model_paper_exact_bytes": model["paper_exact_bytes"]}

    stack = dominant(rng, (BATCH, BATCH_N, BATCH_N))
    (sres, stack_operands), stack_launches = run_counted(
        ops, lambda: kernel_operands(ops, lambda: repro_torch.outsource_determinant(
            stack, N_SERVERS, distributed=True)))
    swant = slogdet_det(torch.from_numpy(stack).to(dev))
    check(bool(sres.verified.all()), f"pipeline stack verified {sres.verified}")
    check(all(g.allclose(w) for g, w in zip(sres.dets, swant)),
          "pipeline stack dets")
    for name, count in expected_pipeline_launches(BATCH_N).items():
        check(stack_launches[name] == count,
              f"pipeline stack {name} launches {stack_launches[name]}")

    m32 = dominant(rng, (SINGLE_N, SINGLE_N))
    f32, f32_launches = run_counted(ops, lambda: repro_torch.outsource_determinant(
        m32, N_SERVERS, dtype="float32", distributed=True))
    want32 = slogdet_det(torch.from_numpy(m32).to(dev))
    f32_dlog = f32.det.logabs - want32.logabs
    check(f32.verified and f32.det.sign == want32.sign
          and abs(f32_dlog) <= F32_DLOG, f"pipeline f32 {f32.det} vs {want32}")

    healed = repro_torch.outsource_determinant(
        m, N_SERVERS, distributed=True, recover=True, standby=1,
        faults=ServerFault(server=2, kind="dropout"))
    recovery = recovery_case(healed, res, "pipeline")

    # the panel and both solves against their plain versions on the
    # operands the single and the stack runs gave them
    errs, vs_plain, by_key = {}, [], {}
    for key, (calls, args) in {**operands, **stack_operands}.items():
        name, *shapes = key
        abs_err, rel_err = max_err(getattr(ops, name)(*args),
                                   getattr(ref, f"{name}_ref")(*args))
        check(rel_err <= RTOL, f"pipeline {name} {shapes}: {rel_err}")
        errs[name] = max(errs.get(name, 0.0), abs_err)
        by_key[key] = abs_err
        vs_plain.append({"kernel": name, "shapes": shapes, "calls": calls,
                         "max_abs_err": abs_err, "max_rel_err": rel_err})
    torch.cuda.synchronize()
    row_key = next(key for key in operands
                   if key[0] == "trsm_lower" and key[2][-1] == SINGLE_N)
    phase_s = time.perf_counter() - started
    emit({"phase": "pipeline", "n": SINGLE_N, "servers": N_SERVERS,
          "dtype": "float64", "verified": res.verified,
          "rotate_k": res.meta.rotate_k, "growth_max_u_over_max_x": growth,
          "logabs": res.det.logabs, "inline_logabs": inline.det.logabs,
          "slogdet_logabs": want.logabs, "launches": launches,
          "expected_launches": want_counts,
          "inline_sweep_warm_wall_s": inline_s, "programs": programs,
          "stack": {"shape": [BATCH, BATCH_N, BATCH_N],
                    "verified": int(sres.verified.sum()),
                    "launches": stack_launches,
                    "warm_wall_s": wall(lambda: repro_torch.outsource_determinant(
                        stack, N_SERVERS, distributed=True))[1]},
          "f32": {"n": SINGLE_N, "verified": f32.verified,
                  "dlogabs_vs_f64_slogdet": f32_dlog, "launches": f32_launches},
          "recovery_dropout_server2": recovery,
          "kernel_vs_plain": {"max_abs_err": errs, "cases": len(vs_plain),
                              "tolerance": RTOL,
                              "largest": [c for c in vs_plain
                                          if max(s[-1] for s in c["shapes"])
                                          >= BATCH_N]},
          "phase_s": phase_s})
    check(phase_s <= PIPELINE_BUDGET_S,
          f"the pipeline phase took {phase_s:.1f} s")
    return launches, {"calls": operands[row_key][0],
                      "operands": operands[row_key][1],
                      "max_abs_err": by_key[row_key]}


def flash_inputs(rng, dev, dtype, b, hq, hkv, sq, sk, d, cache_len=None):
    """q, k, v as the serving path passes them: (B, H, S, D) views of
    (B, S, H, D) tensors; with cache_len, k and v are the first sk slots
    of a (B, cache_len, Hkv, D) cache."""
    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    q = draw((b, sq, hq, d)).transpose(1, 2)
    length = cache_len or sk
    k = draw((b, length, hkv, d))[:, :sk].transpose(1, 2)
    v = draw((b, length, hkv, d))[:, :sk].transpose(1, 2)
    return q, k, v


def phase_flash(rng, dev) -> dict:
    """The flash kernel against its plain version; returns the largest
    error by kernels-line row: "flash_attention" over every case,
    "flash_attention:f32" over the f32 cases at the serving shapes and
    the small ones, "flash_attention:f32_sliding" at gemma3's."""
    from repro_torch.kernels import ops, ref

    (hq, hkv, d), b, s = FLASH_HEADS, PREFILL_BATCH, PREFILL_LEN
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += [("prefill", dtype, (b, hq, hkv, s, s, d), {"causal": True}),
                  ("decode over a cache prefix", dtype,
                   (b, hq, hkv, 1, s, d, s + 128), {"causal": True}),
                  ("decode, window 40 inside the last chunk", dtype,
                   (b, hq, hkv, 1, s, d, s + 128),
                   {"causal": True, "window": 40})]
    cases += [("gemma3 sliding prefill", torch.float32,
               (b, 4, 1, s, s, 256), {"causal": True, "window": 1024}),
              ("window 40", torch.bfloat16, (1, 4, 1, 200, 200, d),
               {"causal": True, "window": 40}),
              ("non-causal", torch.bfloat16, (1, 4, 4, 128, 128, d),
               {"causal": False}),
              ("ragged 50 / 77", torch.float32, (2, 4, 2, 50, 77, d),
               {"causal": True}),
              ("fully masked rows, Sq 8 > Sk 4", torch.float32,
               (1, 4, 2, 8, 4, d), {"causal": True})]
    worst = dict.fromkeys(("flash_attention", "flash_attention:f32",
                           "flash_attention:f32_sliding"), 0.0)
    for label, dtype, shape, kw in cases:
        q, k, v = flash_inputs(rng, dev, dtype, *shape)
        got = ops.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        reading = flash_compare(got, want, v)
        line = {"phase": "kernel_vs_plain", "kernel": "flash_attention",
                "case": label, "dtype": str(dtype), "q": list(q.shape),
                "kv": list(k.shape), **kw, **reading}
        if label.startswith("fully masked"):
            mean = v.float().mean(dim=2, keepdim=True)
            mean = mean.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
            rows = q.shape[2] - k.shape[2]
            line["masked_rows_vs_mean_of_v"] = float(
                (got[:, :, :rows].float() - mean).abs().max())
            check(line["masked_rows_vs_mean_of_v"]
                  <= FLASH_TOL[dtype] * reading["max_abs_v"],
                  "fully masked rows are not the mean of V")
        emit(line)
        check(reading["within"], f"flash_attention {label} {dtype}: {reading}")
        rows = ["flash_attention"]
        if dtype == torch.float32:
            rows.append("flash_attention:f32_sliding" if label.startswith("gemma3")
                        else "flash_attention:f32")
        for name in rows:
            worst[name] = max(worst[name], reading["max_abs_err"])
    worst.update(flash_split(rng, dev))
    return worst


def flash_split(rng, dev) -> dict:
    """The split decode's halves on phase 12's 2048-key decode case, in
    bf16 and f32, over each cut of SPLIT_CUTS: the partial kernel over
    each range (every range given as many 128-key chunks as the widest
    needs), the merge kernel over all ranges' chunks in order; against
    the unsplit kernel decode (bit-equal where every range starts on a
    multiple of the chunk) and the plain whole decode (FLASH_TOL).
    Returns the largest error of each half alone: the partial's, its
    chunks merged by the plain merge against the plain partials merged
    so; the merge's, against the plain merge of the same partials."""
    from repro_torch.kernels import ops, ref

    (hq, hkv, d), b, s = FLASH_HEADS, PREFILL_BATCH, PREFILL_LEN
    worst = dict.fromkeys(("flash_attention:decode_partial",
                           "flash_attention:combine"), 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(rng, dev, dtype, b, hq, hkv, 1, s, d, s + 128)
        whole = ops.flash_attention(q, k, v, causal=True)
        plain_whole = ref.flash_attention_ref(q, k, v, causal=True)
        for label, cuts in SPLIT_CUTS.items():
            ranges = list(zip(cuts, cuts[1:]))
            chunks = max(-(-(hi - lo) // 128) for lo, hi in ranges)

            def partials(fn):
                return torch.cat([fn(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                     chunks=chunks)
                                  for lo, hi in ranges])

            part, launches = counted(ops, lambda: partials(ops.flash_decode_partial))
            got, merged = counted(ops, lambda: ops.flash_combine(part, dtype))
            plain_part = partials(ref.flash_decode_partial_ref)
            reading = flash_compare(got, plain_whole, v)
            merged_plainly = ref.flash_combine_ref(part, dtype).float()
            errors = {
                "flash_attention:decode_partial": float(
                    (merged_plainly - ref.flash_combine_ref(plain_part, dtype)
                     .float()).abs().max()),
                "flash_attention:combine": float(
                    (got.float() - merged_plainly).abs().max())}
            aligned = all(lo % 128 == 0 for lo in cuts)
            bit_equal = bool(torch.equal(got, whole))
            emit({"phase": "kernel_vs_plain", "kernel": "flash_attention",
                  "case": f"split decode over {label}", "dtype": str(dtype),
                  "q": list(q.shape), "kv": list(k.shape), "cuts": list(cuts),
                  "chunks_per_range": chunks, "bit_equal_to_unsplit": bit_equal,
                  "halves_vs_plain": errors,
                  "launches": {"partial": launches["flash_decode_partial"],
                               "merge": merged["flash_combine"]},
                  **reading})
            check(reading["within"], f"split decode over {label} {dtype}: "
                                     f"{reading}")
            check(not aligned or bit_equal,
                  f"split decode over {label} {dtype} is not the unsplit "
                  "decode's bits")
            check(launches["flash_decode_partial"]
                  == sum(hi > lo for lo, hi in ranges)
                  and merged["flash_combine"] == 1,
                  f"split decode launches {launches} {merged}")
            for name, err in errors.items():
                worst[name] = max(worst[name], err)
    return worst


def flash_compare(got, want, v) -> dict:
    """The flash kernel's output against its plain version's, read and
    judged by FLASH_TOL's rule for the dtype."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_v = float(v.float().abs().max())
    out = {"max_abs_err": float(err.max()), "max_abs_v": max_v,
           "median_abs_want": float(want.abs().median())}
    if v.dtype == torch.float32:
        out["tolerance"] = f"{FLASH_TOL[v.dtype]} * max|v|"
        out["within"] = out["max_abs_err"] <= FLASH_TOL[v.dtype] * max_v
        return out
    eps = torch.finfo(v.dtype).eps
    bound = 2 * eps * want.abs() + eps / 8 * max_v
    out.update(
        rel_norm_err=float(err.norm() / want.norm()),
        worst_of_elementwise_bound=float((err / bound).max()),
        tolerance=f"|err| <= 2 eps |want| + eps/8 max|v| and "
                  f"||err|| <= eps ||want||, eps {eps}")
    out["within"] = (out["worst_of_elementwise_bound"] <= 1
                     and out["rel_norm_err"] <= eps)
    return out


def rel_err(got: torch.Tensor, want: torch.Tensor, vocab: int) -> float:
    """max |got − want| over max |want|, on the real vocabulary."""
    got, want = got[:, :vocab].float(), want[:, :vocab].float()
    return float((got - want).abs().max()) / float(want.abs().max())


def decode_against_prefill(ops, model, cfg, tokens) -> dict:
    """Decode the tokens one by one from empty caches; the last logits
    against the prefill of the same tokens."""
    from repro_torch.serve.kvcache import init_caches
    from repro_torch.serve.steps import build_decode_step, build_prefill_step

    b, s = tokens.shape
    want = build_prefill_step(cfg)(model, {"tokens": tokens})
    caches = init_caches(cfg, b, s, device=tokens.device)
    decode = build_decode_step(cfg)

    def run():
        logits = None
        for t in range(s):
            pos = torch.full((b,), t, dtype=torch.int32, device=tokens.device)
            logits, _ = decode(model, caches, {"tokens": tokens[:, t:t + 1]}, pos)
        return logits

    (got, launches), seconds = wall(lambda: counted(ops, run))
    check(launches["flash_attention"] == cfg.num_layers * s,
          f"decode flash launches {launches['flash_attention']}")
    return {"rel_err": rel_err(got, want, cfg.vocab_size),
            "max_abs_logits": float(want[:, :cfg.vocab_size].abs().max()),
            "decode_steps": s, "decode_s": seconds,
            "flash_launches": launches["flash_attention"]}


def phase_serve(rng, dev, seed: int) -> tuple[dict, int, tuple]:
    """LM serving of tinyllama-1.1b at full width and depth on the card,
    then of the other model families (serve_models). Returns the greedy
    run's launches, the f32 flash launches (the f32 decode against
    prefill and the f32 card prefill) and serve_models' (launches by
    arch, flash launches by route)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.steps import build_prefill_step, greedy_generate
    from repro_torch.train.data import SyntheticLM

    ops.reset_launches()
    phase_t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    model, init_s = wall(lambda: init_lm(cfg, seed, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    data = SyntheticLM(cfg, seed=seed)
    prompts = data.batch(0, PREFILL_BATCH, PREFILL_LEN)["tokens"].to(dev)
    prefill = build_prefill_step(cfg)
    batch = {"tokens": prompts}
    (logits, launches), cold_s = wall(lambda: counted(ops, lambda: prefill(model, batch)))
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          "prefill logits are not finite")
    check(launches["flash_attention"] == cfg.num_layers,
          f"prefill flash launches {launches['flash_attention']}")
    warm = [wall(lambda: prefill(model, batch))[1] for _ in range(3)]
    warm_s = float(np.median(warm))

    bf16 = decode_against_prefill(ops, model, cfg, prompts[:, :CONSISTENCY_LEN])
    check(bf16["rel_err"] <= SERVE_TOL["decode_vs_prefill_bf16"],
          f"bf16 decode vs prefill: {bf16['rel_err']}")

    # the launcher's run, with the counts set to 0 just before it: the
    # main path's launches, which the kernels line reports
    gen_prompts = data.batch(1, GEN_BATCH, GEN_PROMPT)["tokens"].to(dev)
    (out, gen_launches), gen_s = wall(lambda: run_counted(
        ops, lambda: greedy_generate(cfg, model, gen_prompts, GEN_STEPS)))
    check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_STEPS),
          f"greedy output shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "greedy tokens outside the vocabulary")
    gen_decode_steps = GEN_PROMPT + GEN_STEPS - 1
    check(gen_launches["flash_attention"] == cfg.num_layers * gen_decode_steps,
          f"greedy flash launches {gen_launches['flash_attention']}")

    profile = serve_profile(model, prefill, batch)
    del model
    torch.cuda.empty_cache()

    cfg32 = replace(cfg, activation_dtype="float32", params_dtype="float32")
    model32 = init_lm(cfg32, seed, device=dev)
    f32 = decode_against_prefill(ops, model32, cfg32, prompts[:, :CONSISTENCY_LEN])
    check(f32["rel_err"] <= SERVE_TOL["decode_vs_prefill_f32"],
          f"f32 decode vs prefill: {f32['rel_err']}")
    short = prompts[:1, :CPU_CHECK_LEN]
    on_card, card_launches = counted(
        ops, lambda: build_prefill_step(cfg32)(model32, {"tokens": short}))
    check(card_launches["flash_attention"] == cfg.num_layers,
          f"f32 prefill flash launches {card_launches['flash_attention']}")
    model32.cpu()
    torch.cuda.empty_cache()
    on_cpu, cpu_s = wall(lambda: build_prefill_step(cfg32)(
        model32, {"tokens": short.cpu()}))
    card_vs_cpu = rel_err(on_card.cpu(), on_cpu, cfg.vocab_size)
    check(card_vs_cpu <= SERVE_TOL["card_vs_cpu_f32"],
          f"f32 card vs CPU prefill: {card_vs_cpu}")
    del model32

    emit({"phase": "serve", "arch": SERVE_ARCH, "params": n_params,
          "dtype": cfg.activation_dtype, "init_s": init_s,
          "prefill": {"batch": PREFILL_BATCH, "prompt": PREFILL_LEN,
                      "cold_s": cold_s, "warm_s": warm_s, "warm_runs_s": warm,
                      "tokens_per_s": PREFILL_BATCH * PREFILL_LEN / warm_s,
                      "flash_launches_per_call": cfg.num_layers},
          "decode_vs_prefill": {"bf16": bf16, "f32": f32,
                                "tolerance": {k: v for k, v in SERVE_TOL.items()
                                              if k.startswith("decode")}},
          "card_vs_cpu_f32": {"batch": 1, "prompt": CPU_CHECK_LEN,
                              "rel_err": card_vs_cpu, "cpu_s": cpu_s,
                              "tolerance": SERVE_TOL["card_vs_cpu_f32"]},
          "greedy": {"batch": GEN_BATCH, "prompt": GEN_PROMPT,
                     "generated": GEN_STEPS, "seconds": gen_s,
                     "tokens_per_s": GEN_BATCH * GEN_STEPS / gen_s,
                     "decode_steps": gen_decode_steps,
                     "flash_launches": gen_launches["flash_attention"],
                     "sample": out[0, :24].tolist()},
          "launches": gen_launches, "phase_s": time.perf_counter() - phase_t0})
    emit(profile)
    # the other model families, each with its counts set to 0 before it
    models = serve_models(dev, seed)
    return (gen_launches, f32["flash_launches"] + card_launches["flash_attention"],
            models)


def serve_profile(model, prefill, batch) -> dict:
    """One warm prefill under torch.profiler: the card's busy share and
    its device time by kernel."""
    events, host_s, _ = device_events(lambda: prefill(model, batch), 1)
    check(bool(events), "the profiler recorded no device activity")
    by_kernel: dict[str, list] = {}
    for evt in events:
        entry = by_kernel.setdefault(short_name(evt.name), [0.0, 0])
        entry[0] += evt.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    return {"phase": "serve_profile", "arch": SERVE_ARCH,
            "batch": PREFILL_BATCH, "prompt": PREFILL_LEN,
            "wall_ms": host_s * 1e3, "device_ms": busy_ms,
            "device_busy_share": busy_ms / (host_s * 1e3),
            "device_launches": sum(c for _, c in by_kernel.values()),
            "top_device_ms": {k: {"ms": v[0], "count": v[1]} for k, v in top}}


class FlashRoutes:
    """While installed, counts the flash kernel's launches by route: the
    wrapper ops.flash_attention is wrapped, and so is the model's
    attention function (blocks.attention), which tells it the layer kind
    and phase that called. Routes: causal and non_causal prefill,
    sliding (the window route), chunk_fold (a chunked layer's chunks
    folded into the batch), decode over a full cache and ring_decode
    over a local layer's ring."""

    NAMES = ("causal", "non_causal", "sliding", "chunk_fold", "decode",
             "ring_decode")

    def __init__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import blocks

        self.ops, self.blocks = ops, blocks
        self.counts = dict.fromkeys(self.NAMES, 0)
        self.caller = None

    def __enter__(self):
        ops, blocks = self.ops, self.blocks
        self.saved = flash, attention = ops.flash_attention, blocks.attention

        def layer(p, x, cfg, positions, *, kind="full", cache=None):
            w = cfg.window
            self.caller = (kind, cache is not None,
                           bool(w) and 1 < w < x.shape[1])
            try:
                return attention(p, x, cfg, positions, kind=kind, cache=cache)
            finally:
                self.caller = None

        def counting(q, k, v, *, causal=True, window=None, scale=None):
            before = ops.LAUNCHES["flash_attention"]
            out = flash(q, k, v, causal=causal, window=window, scale=scale)
            kind, decode, local = self.caller or ("full", False, False)
            if decode:
                route = "decode" if kind == "full" else "ring_decode"
            elif window is not None:
                route = "sliding"
            elif kind == "chunked" and local:
                route = "chunk_fold"
            else:
                route = "causal" if causal else "non_causal"
            self.counts[route] += ops.LAUNCHES["flash_attention"] - before
            return out

        ops.flash_attention, blocks.attention = counting, layer
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention, self.blocks.attention = self.saved
        return False


def model_inputs(cfg, dev, b: int, s: int, seed: int, stream: int) -> dict:
    """A prompt batch for cfg: SyntheticLM tokens, or for a stub frontend
    standard-normal embeddings drawn on the card from seed and stream."""
    from repro_torch.train.data import SyntheticLM

    if cfg.frontend is None:
        return {"tokens": SyntheticLM(cfg, seed=seed).batch(stream, b, s)[
            "tokens"].to(dev)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1000 + stream)
    return {"embeds": torch.randn((b, s, cfg.d_model), generator=gen,
                                  device=dev).to(cfg.dtype)}


def attention_layers(cfg) -> int:
    return sum(mixer != "ssm" for mixer, _ in cfg.layer_list())


def decode_vs_prefill(ops, model, cfg, batch: dict) -> dict:
    """Decode the batch's S positions one by one from empty caches (a ring
    for local layers, state for SSM layers); the last logits against the
    prefill of the same inputs."""
    from repro_torch.serve.kvcache import init_caches
    from repro_torch.serve.steps import build_decode_step, build_prefill_step

    key, inputs = next(iter(batch.items()))
    b, s = inputs.shape[:2]
    want = build_prefill_step(cfg)(model, batch)
    caches = init_caches(cfg, b, s, device=inputs.device)
    decode = build_decode_step(cfg)

    def run():
        logits = None
        for t in range(s):
            pos = torch.full((b,), t, dtype=torch.int32, device=inputs.device)
            logits, _ = decode(model, caches, {key: inputs[:, t:t + 1]}, pos)
        return logits

    (got, launches), seconds = wall(lambda: counted(ops, run))
    check(launches["flash_attention"] == attention_layers(cfg) * s,
          f"{cfg.name} decode flash launches {launches['flash_attention']}")
    return {"rel_err": rel_err(got, want, cfg.vocab_size),
            "max_abs_logits": float(want[:, :cfg.vocab_size].abs().max()),
            "decode_steps": s, "decode_s": seconds,
            "flash_launches": launches["flash_attention"]}


def serve_model(arch: str, layers: int | None, dev, seed: int) -> dict:
    """One model family on the card in bf16 from seeded weights: prefill
    (launches, warm time, one profiled call), decode against prefill in
    bf16 and f32 (SERVE_TOL), the f32 card prefill against the CPU's, and
    greedy generation for the token decoders. The consistency gates run
    the dense MoE, as the reference's decode test does: capacity drops
    depend on the token group, which a prefill and a decode step size
    differently. Returns the phase line; its "launches" are the whole
    run's."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.steps import build_prefill_step, greedy_generate

    t0 = time.perf_counter()
    ops.reset_launches()
    cfg = get_config(arch)
    if layers:
        cfg = replace(cfg, num_layers=layers)
    model, init_s = wall(lambda: init_lm(cfg, seed, device=dev))
    n_params = sum(p.numel() for p in model.parameters())
    chunked = any(m == "attn_chunked" for m, _ in cfg.layer_list())
    b, s = CHUNK_PREFILL if chunked else (PREFILL_BATCH, PREFILL_LEN)
    batch = model_inputs(cfg, dev, b, s, seed, 0)
    prefill = build_prefill_step(cfg)
    (logits, launches), cold_s = wall(
        lambda: counted(ops, lambda: prefill(model, batch)))
    check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
          f"{arch} prefill logits are not finite")
    check(launches["flash_attention"] == attention_layers(cfg),
          f"{arch} prefill flash launches {launches['flash_attention']}")
    warm = [wall(lambda: prefill(model, batch))[1] for _ in range(3)]
    warm_s = float(np.median(warm))
    events, host_s, _ = device_events(lambda: prefill(model, batch), 1)
    check(bool(events), f"{arch}: the profiler recorded no device activity")
    by_kernel: dict[str, list] = {}
    for evt in events:
        entry = by_kernel.setdefault(short_name(evt.name), [0.0, 0])
        entry[0] += evt.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    line = {"phase": "serve", "arch": arch, "params": n_params,
            "layers": cfg.num_layers, "depth_cut": layers,
            "dtype": cfg.activation_dtype, "init_s": init_s,
            "prefill": {"batch": b, "prompt": s, "input": next(iter(batch)),
                        "cold_s": cold_s, "warm_s": warm_s,
                        "warm_runs_s": warm, "tokens_per_s": b * s / warm_s,
                        "flash_launches_per_call": launches["flash_attention"]},
            "prefill_profile": {"wall_ms": host_s * 1e3, "device_ms": busy_ms,
                                "device_busy_share": busy_ms / (host_s * 1e3),
                                "device_launches": sum(
                                    c for _, c in by_kernel.values()),
                                "top_device_ms": {k: {"ms": v[0], "count": v[1]}
                                                  for k, v in top}}}
    gate = replace(cfg, moe_impl="dense") if cfg.num_experts else cfg
    if cfg.causal:
        # local windows and llama4's chunks cut to F32_WINDOW, or 128
        # tokens would stay inside one
        bf16_cfg = replace(gate, window=F32_WINDOW) if cfg.window else gate
        long = model_inputs(cfg, dev, PREFILL_BATCH, CONSISTENCY_LEN, seed, 1)
        bf16 = decode_vs_prefill(ops, model, bf16_cfg, long)
        bf16["window"] = bf16_cfg.window
        # one expert a token: a routing tie broken the other way by bf16
        # rounding swaps the whole expert, so llama4's bf16 run is read,
        # not gated; its f32 run is
        bf16["tolerance"] = SERVE_TOL_BF16.get(
            arch, SERVE_TOL["decode_vs_prefill_bf16"])
        bf16["gated"] = cfg.experts_per_token != 1
        if bf16["gated"]:
            check(bf16["rel_err"] <= bf16["tolerance"],
                  f"{arch} bf16 decode vs prefill: {bf16['rel_err']}")
        line["decode_vs_prefill"] = {"bf16": bf16}
        if cfg.frontend is None:
            gen = model_inputs(cfg, dev, GEN_BATCH, GEN_PROMPT, seed, 2)
            (out, gen_launches), gen_s = wall(lambda: counted(
                ops, lambda: greedy_generate(cfg, model, gen["tokens"],
                                             GEN_STEPS)))
            check(tuple(out.shape) == (GEN_BATCH, GEN_PROMPT + GEN_STEPS),
                  f"{arch} greedy output shape {tuple(out.shape)}")
            check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
                  f"{arch} greedy tokens outside the vocabulary")
            steps = GEN_PROMPT + GEN_STEPS - 1
            check(gen_launches["flash_attention"]
                  == attention_layers(cfg) * steps,
                  f"{arch} greedy flash launches "
                  f"{gen_launches['flash_attention']}")
            line["greedy"] = {"batch": GEN_BATCH, "prompt": GEN_PROMPT,
                              "generated": GEN_STEPS, "seconds": gen_s,
                              "tokens_per_s": GEN_BATCH * GEN_STEPS / gen_s,
                              "flash_launches": gen_launches["flash_attention"],
                              "sample": out[0, :16].tolist()}
    del model
    torch.cuda.empty_cache()

    cfg32 = replace(gate, activation_dtype="float32", params_dtype="float32")
    model32 = init_lm(cfg32, seed, device=dev)
    if cfg.causal:
        f32_cfg = replace(cfg32, window=F32_WINDOW) if cfg.window else cfg32
        short = model_inputs(cfg32, dev, PREFILL_BATCH, CONSISTENCY_LEN, seed, 1)
        f32 = decode_vs_prefill(ops, model32, f32_cfg, short)
        f32["window"] = f32_cfg.window
        check(f32["rel_err"] <= SERVE_TOL["decode_vs_prefill_f32"],
              f"{arch} f32 decode vs prefill: {f32['rel_err']}")
        line["decode_vs_prefill"]["f32"] = f32
        line["decode_vs_prefill"]["tolerance"] = {
            k: v for k, v in SERVE_TOL.items() if k.startswith("decode")}
    if n_params <= CPU_CHECK_MAX_PARAMS:
        cpu_cfg = replace(cfg32, window=CPU_WINDOW) if cfg.window else cfg32
        one = model_inputs(cfg32, dev, 1, CPU_CHECK_LEN, seed, 3)
        on_card, card_launches = counted(
            ops, lambda: build_prefill_step(cpu_cfg)(model32, one))
        check(card_launches["flash_attention"] == attention_layers(cfg),
              f"{arch} f32 prefill flash launches")
        model32.cpu()
        torch.cuda.empty_cache()
        on_cpu, cpu_s = wall(lambda: build_prefill_step(cpu_cfg)(
            model32, {k: t.cpu() for k, t in one.items()}))
        card_vs_cpu = rel_err(on_card.cpu(), on_cpu, cfg.vocab_size)
        check(card_vs_cpu <= SERVE_TOL["card_vs_cpu_f32"],
              f"{arch} f32 card vs CPU prefill: {card_vs_cpu}")
        line["card_vs_cpu_f32"] = {"batch": 1, "prompt": CPU_CHECK_LEN,
                                   "window": cpu_cfg.window,
                                   "rel_err": card_vs_cpu, "cpu_s": cpu_s,
                                   "tolerance": SERVE_TOL["card_vs_cpu_f32"]}
    del model32
    torch.cuda.empty_cache()
    line["launches"] = dict(ops.LAUNCHES)
    line["phase_s"] = time.perf_counter() - t0
    return line


def serve_models(dev, seed: int) -> tuple[dict, dict]:
    """serve_model over SERVE_MODELS, each run with the counts set to 0
    just before it, under FlashRoutes. Returns (launches by arch, flash
    launches by route over all of them)."""
    t0 = time.perf_counter()
    by_arch = {}
    with FlashRoutes() as routes:
        for arch, layers in SERVE_MODELS:
            line = serve_model(arch, layers, dev, seed)
            by_arch[arch] = line["launches"]
            emit(line)
    for route in ("sliding", "chunk_fold", "ring_decode", "non_causal"):
        check(routes.counts[route] > 0,
              f"the flash route {route} never ran: {routes.counts}")
    emit({"phase": "serve_models", "archs": [a for a, _ in SERVE_MODELS],
          "flash_routes": routes.counts, "phase_s": time.perf_counter() - t0})
    return by_arch, routes.counts


def models_vs_plain(rng, dev) -> dict:
    """The flash kernel against its plain version at the shapes the
    model families give it, in bf16 (FLASH_TOL's rule): gemma3's sliding
    prefill (4 × 2048, 4 query heads over 1 kv head, D 256, window 1024)
    and its decode over a full 1024-slot ring; llama4's prefill of
    16384 tokens folded into two 8192-token chunks (40 heads over 8,
    D 128), the plain version run on one kv-head group of one chunk at a
    time to fit the card; hubert's non-causal prefill (4 × 2048, 16
    heads, D 80). Returns the largest error by kernels-line row."""
    from repro_torch.kernels import ops, ref

    bf16 = torch.bfloat16
    errs: dict[str, float] = {}

    def judge(name, label, got, want, v, **kw):
        reading = flash_compare(got, want, v)
        emit({"phase": "kernel_vs_plain", "kernel": "flash_attention",
              "where": "models", "case": label, "q": list(got.shape),
              "kv": list(v.shape), **kw, **reading})
        check(reading["within"], f"flash_attention {label}: {reading}")
        errs[name] = max(errs.get(name, 0.0), reading["max_abs_err"])

    q, k, v = flash_inputs(rng, dev, bf16, 4, 4, 1, 2048, 2048, 256)
    judge("flash_attention:sliding", "gemma3 sliding prefill",
          ops.flash_attention(q, k, v, causal=True, window=1024),
          ref.flash_attention_ref(q, k, v, causal=True, window=1024), v,
          window=1024)
    q, k, v = flash_inputs(rng, dev, bf16, 4, 4, 1, 1, 1024, 256, 1024)
    judge("flash_attention:ring_decode", "gemma3 decode over a full ring",
          ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v), v)
    q, k, v = flash_inputs(rng, dev, bf16, 2, 40, 8, 8192, 8192, 128)
    got = ops.flash_attention(q, k, v, causal=True)
    for c in range(2):
        for g in range(8):
            heads = slice(5 * g, 5 * g + 5)
            judge("flash_attention:chunk_fold",
                  f"llama4 chunk {c} kv head {g}", got[c:c + 1, heads],
                  ref.flash_attention_ref(q[c:c + 1, heads],
                                          k[c:c + 1, g:g + 1],
                                          v[c:c + 1, g:g + 1], causal=True),
                  v[c:c + 1, g:g + 1])
    del q, k, v, got
    q, k, v = flash_inputs(rng, dev, bf16, 4, 16, 16, 2048, 2048, 80)
    judge("flash_attention:non_causal", "hubert prefill",
          ops.flash_attention(q, k, v, causal=False),
          ref.flash_attention_ref(q, k, v, causal=False), v, causal=False)
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
def grads_within(got, want) -> dict:
    """Gradients against the oracle's by GRAD_ULPS's rule for their dtype:
    each leaf's max|err| over its max|g| (and its normwise error), and
    whether every leaf is within."""
    out = {"max_err_of_max": [], "norm_err": [], "within": True}
    for a, c in zip(got, want):
        err = (a.float() - c.float()).abs()
        top = float(c.float().abs().max())
        of_max = float(err.max()) / top
        norm = float(err.norm() / c.float().norm())
        out["max_err_of_max"].append(of_max)
        out["norm_err"].append(norm)
        if c.dtype == torch.float32:
            ok = of_max <= FLASH_TOL[torch.float32]
        else:
            eps = torch.finfo(c.dtype).eps
            ok = of_max <= GRAD_ULPS * eps and norm <= eps
        out["within"] = out["within"] and ok and top > 0
    out["tolerance"] = ("1e-5 * max|g|" if want[0].dtype == torch.float32
                        else f"{GRAD_ULPS} eps max|g|, eps ||want||")
    return out


#: B6's gradient at small shapes on every route the models give it:
#: (label, b, hq, hkv, sq, sk, d, flash keyword arguments, grad layout)
GRAD_ROUTES = (
    ("window d256", 1, 4, 1, 384, 384, 256, {"causal": True, "window": 128},
     "model"),
    ("non-causal d80", 2, 16, 16, 256, 256, 80, {"causal": False}, "model"),
    ("chunk fold d128", 4, 40, 8, 256, 256, 128, {"causal": True}, "model"),
    ("sq < sk", 2, 8, 2, 100, 300, 64, {"causal": True}, "model"),
    ("fully masked rows", 1, 8, 2, 300, 100, 64, {"causal": True}, "model"),
    ("strided grad", 2, 32, 4, 256, 256, 64, {"causal": True}, "offset"),
    ("short sq", 2, 32, 4, 9, 300, 64, {"causal": True}, "model"),
)


def grad_case(rng, dev, dtype, b, hq, hkv, sq, sk, d, layout="model"):
    """q, k, v (model views, requiring grad) and a grad_out: the model's
    (B, H, S, D) view of a (B, S, H, D) tensor, or with layout "offset"
    columns 1 .. D of a (B, S, H, D + 1) tensor, whose rows start off 16
    bytes (the gradient kernels' 2-byte copies)."""
    q, k, v = (t.detach().requires_grad_()
               for t in flash_inputs(rng, dev, dtype, b, hq, hkv, sq, sk, d))
    width = d + (layout == "offset")
    g = torch.from_numpy(rng.standard_normal((b, sq, hq, width),
                                             dtype=np.float32)).to(dev, dtype)
    return q, k, v, g[..., width - d:].transpose(1, 2)


def autograd_check(ops, q, k, v, g, kw) -> dict:
    """The kernel under autograd (one forward and one backward counted)
    against the oracle, autograd through the plain version: the forward
    within FLASH_TOL, dq, dk, dv within GRAD_ULPS's rule and the same bits
    from a second backward. Returns the reading."""
    from repro_torch.kernels import flash_grad, ref

    def forward_and_backward():
        out = ops.flash_attention(q, k, v, **kw)
        return out, torch.autograd.grad(out, (q, k, v), g)

    (got, grads), launches = counted(ops, forward_and_backward)
    check(launches["flash_attention"] == 1
          and launches["flash_attention_backward"] == 1,
          f"the flash kernels did not run under autograd: {launches}")
    _, again = forward_and_backward()
    want = ref.flash_attention_ref(q, k, v, **kw)
    reading = flash_compare(got.detach(), want.detach(), v.detach())
    check(reading["within"], f"flash forward under autograd: {reading}")
    plain = flash_grad.flash_attention_backward(
        q, k, v, g, kw.get("causal", True), kw.get("window"), kw.get("scale"))
    grad = grads_within(grads, plain)
    grad["bit_equal_run_to_run"] = all(bool(torch.equal(a, c))
                                       for a, c in zip(grads, again))
    check(grad["within"] and grad["bit_equal_run_to_run"],
          f"dq, dk, dv against the plain version: {grad}")
    return {"forward": reading, "grads": grad}


def kernel_split(fn, reps: int) -> dict:
    """Device ms a call of fn by kernel (template name), from the
    profiler's device events of `reps` calls."""
    events, _, _ = device_events(fn, reps)
    check(bool(events), "the profiler recorded no device activity")
    out: dict = {}
    for e in events:
        name = template_name(e.name)
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    return out


def train_autograd(rng, dev) -> dict:
    """The flash kernel under autograd. At tinyllama's prefill shape, bf16
    and f32, q, k and v as the model's (B, S, H, D) views: the forward
    within FLASH_TOL of the plain version, dq, dk, dv from the gradient
    kernels within GRAD_ULPS's rule of autograd through the plain version
    and bit-equal from call to call; the forward's device ms, the
    gradient kernels' by kernel, the plain backward's (the oracle) and
    scaled_dot_product_attention's backward on the same values (K and V
    repeated to the query heads; a yardstick the port never calls). Then
    the same checks at small shapes on every route (GRAD_ROUTES), bf16 and
    f32. Returns the bf16 case (the kernels line's autograd_case) and the
    f32 one."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import flash_bwd, flash_grad, ops

    (hq, hkv, d), b, s = FLASH_HEADS, PREFILL_BATCH, PREFILL_LEN
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, g = grad_case(rng, dev, dtype, b, hq, hkv, s, s, d)
        reading = autograd_check(ops, q, k, v, g, {"causal": True})
        fwd_ms, fwd_event, _ = timed(
            lambda: ops.flash_attention(q, k, v, causal=True), 10)
        out = ops.flash_attention(q, k, v, causal=True)
        bwd = kernel_split(lambda: torch.autograd.grad(
            out, (q, k, v), g, retain_graph=True), 10)
        check(sorted(bwd) == sorted(flash_bwd.device_kernels(q)),
              f"the backward ran {sorted(bwd)}")
        plain_ms, plain_event, _ = timed(
            lambda: flash_grad.flash_attention_backward(q, k, v, g, True), 3)
        qr, kr, vr = (t.detach().requires_grad_() for t in (
            q, k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)))
        lib_out = sdpa(qr, kr, vr, is_causal=True)
        lib_ms, lib_event, _ = timed(lambda: torch.autograd.grad(
            lib_out, (qr, kr, vr), g, retain_graph=True), 10)
        cases[str(dtype).removeprefix("torch.")] = {
            "q": list(q.shape), "kv": list(k.shape), "causal": True,
            "forward_ms": fwd_ms, "forward_event_ms": fwd_event,
            "backward_ms": sum(bwd.values()), "backward_kernels_ms": bwd,
            "plain_backward_ms": plain_ms, "plain_backward_event_ms": plain_event,
            "sdpa_backward_ms": lib_ms, "sdpa_backward_event_ms": lib_event,
            **reading}
        del q, k, v, g, out, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    routes = []
    for label, *shape, kw, layout in GRAD_ROUTES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, g = grad_case(rng, dev, dtype, *shape, layout=layout)
            reading = autograd_check(ops, q, k, v, g, kw)
            routes.append({"route": label, "dtype": str(dtype).removeprefix("torch."),
                           "shape": shape, **kw, "grad_layout": layout,
                           **reading["grads"]})
    emit({"phase": "train_autograd", **cases, "routes": routes,
          "units": "device ms a call under torch.profiler; backward_ms: the "
                   "three gradient kernels (csrc/flash_bwd.cu); "
                   "plain_backward_ms: autograd through flash_attention_ref, "
                   "recomputed (the oracle); sdpa_backward_ms: "
                   "scaled_dot_product_attention's backward, K and V repeated"})
    return cases


def train_card_vs_cpu(dev, seed: int) -> dict:
    """tinyllama at full width, TRAIN_CPU_LAYERS layers, f32, on the same
    seeded weights on the card and the CPU: the loss, every gradient leaf
    and the parameters after one AdamW step (TRAIN_TOL)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import init_lm, with_parameters
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.train.steps import loss_and_grads

    t0 = time.perf_counter()
    cfg = replace(get_config(SERVE_ARCH), num_layers=TRAIN_CPU_LAYERS,
                  activation_dtype="float32", params_dtype="float32")
    cpu = init_lm(cfg, seed, device="cpu")
    card = with_parameters(cpu, {n: p.to(dev) for n, p in cpu.named_parameters()})
    batch = SyntheticLM(cfg, seed=seed).batch(0, *TRAIN_CPU_SHAPE)
    opt_cfg = AdamWConfig()
    runs = {}
    for where, model, bt in (("card", card, {k: v.to(dev) for k, v in batch.items()}),
                             ("cpu", cpu, batch)):
        ((loss, grads), launches), seconds = wall(lambda: counted(
            ops, lambda: loss_and_grads(model, bt, cfg)))
        if where == "card":
            card_launches = launches
        params, _, _ = adamw_update(dict(model.named_parameters()), grads,
                                    init_opt_state(model, opt_cfg), opt_cfg)
        runs[where] = (loss.cpu(), {n: x.cpu() for n, x in grads.items()},
                       {n: x.cpu() for n, x in params.items()}, seconds)
    (l1, g1, p1, card_s), (l0, g0, p0, cpu_s) = runs["card"], runs["cpu"]
    loss_rel = float(abs(l1 - l0) / abs(l0))
    grad_err = {n: float((g1[n] - g0[n]).abs().max() / g0[n].abs().max())
                for n in g0 if float(g0[n].abs().max()) > 0}
    zero = sorted(n for n in g0 if float(g0[n].abs().max()) == 0
                  or float(g1[n].abs().max()) == 0)
    param_err = max(float((p1[n] - p0[n]).abs().max()) for n in p0)
    qkv = {n: float(g1[n].abs().max()) for n in g1
           if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")}
    line = {"phase": "train_card_vs_cpu", "layers": cfg.num_layers,
            "batch": list(TRAIN_CPU_SHAPE), "loss_card": float(l1),
            "loss_cpu": float(l0), "loss_rel_err": loss_rel,
            "worst_grad_leaf": max(grad_err, key=grad_err.get),
            "worst_grad_err_of_max": max(grad_err.values()),
            "zero_grad_leaves": zero, "max_abs_grad_qkv": qkv,
            "params_after_step_max_abs_err": param_err,
            "card_s": card_s, "cpu_s": cpu_s, "tolerance": TRAIN_TOL,
            "card_launches": {n: card_launches[n] for n in
                              ("flash_attention", "flash_attention_backward")},
            "phase_s": time.perf_counter() - t0}
    emit(line)
    check(loss_rel <= TRAIN_TOL["loss"], f"card vs CPU loss {loss_rel}")
    check(not zero and all(v > 0 for v in qkv.values()),
          f"zero gradients on {zero}")
    check(max(grad_err.values()) <= TRAIN_TOL["grad"],
          f"card vs CPU gradient {line['worst_grad_leaf']}")
    check(param_err <= TRAIN_TOL["params"], f"card vs CPU params {param_err}")
    check(card_launches["flash_attention_backward"] == cfg.num_layers,
          f"f32 gradient kernel calls: {card_launches}")
    return line


def train_split(events_and_host, plain_range: str | None = None) -> dict:
    """A training step's device time by part, from one profiled step: B6's
    forward kernel (the forwards and the remat recomputes), its gradient
    kernels (flash_bwd_*), the plain attention backward (launched inside
    `plain_range`, by default flash_grad.PLAIN_BACKWARD_RANGE, which a
    step on the card does not enter; train_ab.py names an older tree's),
    the rest of the backward, the forward and the optimizer (by the
    steps' ranges their launches fall in), and the card's busy share of
    the wall; the gradient kernels' launches a step."""
    from repro_torch.kernels import flash_grad
    from repro_torch.train import steps

    plain_range = plain_range or flash_grad.PLAIN_BACKWARD_RANGE
    everything, host_s = events_and_host
    events, lost, _ = timed_device_events(everything)
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in everything if e.device_type != cuda]
    names = (plain_range, steps.OPTIMIZER_RANGE, steps.BACKWARD_RANGE,
             steps.FORWARD_RANGE)
    spans = {n: [(e.time_range.start, e.time_range.end) for e in host
                 if e.name == n] for n in names}
    launched = {e.id: e.time_range.start for e in host if LAUNCH_CALL.match(e.name)}
    parts = dict.fromkeys(("forward", "flash_kernel_b6", "flash_backward_b6",
                           "plain_attention_backward", "other_backward",
                           "optimizer", "other"), 0.0)
    label = {plain_range: "plain_attention_backward",
             steps.OPTIMIZER_RANGE: "optimizer",
             steps.BACKWARD_RANGE: "other_backward",
             steps.FORWARD_RANGE: "forward"}
    backward_launches = 0
    for evt in events:
        ms = evt.time_range.elapsed_us() / 1e3
        name = short_name(evt.name)
        if name.startswith("flash_bwd_"):
            parts["flash_backward_b6"] += ms
            backward_launches += 1
            continue
        if name.startswith("flash_"):
            parts["flash_kernel_b6"] += ms
            continue
        t = launched[evt.id]
        where = next((label[n] for n in names
                      if any(a <= t <= b for a, b in spans[n])), "other")
        parts[where] += ms
    busy = sum(parts.values())
    return {"device_ms": parts, "device_busy_ms": busy, "wall_ms": host_s * 1e3,
            "device_busy_share": busy / (host_s * 1e3), "lost_events": lost,
            "flash_backward_launches": backward_launches,
            "plain_backward_ranges": len(spans[plain_range])}


def train_full(dev, seed: int) -> tuple[dict, dict]:
    """tinyllama-1.1b at full width and depth in its config's dtypes (bf16
    params and activations, f32 AdamW state, remat "nothing"), batch
    TRAIN_SHAPE: every leaf's gradient nonzero and finite; then, the
    counts set to 0, one warm step and TRAIN_STEPS timed steps on one
    batch (the falling loss, finite grad norms, 2 flash launches a
    layer a step: the forward and its remat recompute; 1 call of the
    gradient kernels a layer a step), then one step under
    torch.profiler (train_split: flash_bwd.CUDA_LAUNCHES gradient
    kernels a layer, no plain backward). Returns (the line, the steps'
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_bwd, ops
    from repro_torch.models.lm import init_lm
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step, loss_and_grads

    t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    model = init_lm(cfg, seed, device=dev)
    batch = {k: v.to(dev) for k, v in
             SyntheticLM(cfg, seed=seed).batch(0, *TRAIN_SHAPE).items()}
    _, grads = loss_and_grads(model, batch, cfg)
    bad = sorted(n for n, x in grads.items()
                 if not bool(torch.isfinite(x).all()) or float(x.abs().max()) == 0)
    check(not bad, f"zero or non-finite gradients on {bad}")
    del grads
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    opt = init_opt_state(model, opt_cfg)
    step = build_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    steps_run = []
    for _ in range(1 + TRAIN_STEPS):
        (out, launches), seconds = wall(lambda: counted(
            ops, lambda: step(model, opt, batch)))
        model, opt, metrics = out
        steps_run.append({"wall_s": seconds, "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]),
                          "flash_launches": launches["flash_attention"],
                          "flash_backward_launches":
                              launches["flash_attention_backward"]})
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    timed_steps = steps_run[1:]
    walls = [r["wall_s"] for r in timed_steps]
    losses = [r["loss"] for r in steps_run]
    split = train_split(profiled(lambda: step(model, opt, batch), 1))
    line = {"phase": "train", "arch": SERVE_ARCH, "layers": cfg.num_layers,
            "params": sum(p.numel() for p in model.parameters()),
            "dtype": cfg.activation_dtype, "opt_dtype": cfg.optimizer_dtype,
            "remat": cfg.remat, "batch": list(TRAIN_SHAPE), "steps": steps_run,
            "step_wall_s": float(np.median(walls)),
            "tokens_per_s": TRAIN_SHAPE[0] * TRAIN_SHAPE[1] / float(np.median(walls)),
            "max_memory_allocated_bytes": peak,
            "flash_launches_per_step": 2 * cfg.num_layers,
            "flash_backward_calls_per_step": cfg.num_layers,
            "flash_backward_cuda_launches_per_call": flash_bwd.CUDA_LAUNCHES,
            "profile": split, "phase_s": time.perf_counter() - t0}
    emit(line)
    check(all(r["flash_launches"] == 2 * cfg.num_layers for r in steps_run),
          f"flash launches a step: {[r['flash_launches'] for r in steps_run]}")
    check(all(r["flash_backward_launches"] == cfg.num_layers
              for r in steps_run),
          f"flash backward calls a step: "
          f"{[r['flash_backward_launches'] for r in steps_run]}")
    check(split["flash_backward_launches"]
          == flash_bwd.CUDA_LAUNCHES * cfg.num_layers
          and split["plain_backward_ranges"] == 0,
          f"a profiled step's gradient kernels: {split}")
    check(all(math.isfinite(r["grad_norm"]) for r in steps_run),
          "a grad norm is not finite")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    del model, opt
    torch.cuda.empty_cache()
    return line, launches


def train_launcher() -> dict:
    """The launcher in process: TRAIN_LAUNCH's run with a checkpoint every
    20 steps and the SDC check, then again to 50 steps, which must resume
    from step 40; both with no SDC rejection (the launcher itself
    asserts that the loss fell). The checkpoint directory is removed."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.launch import train

    root = tempfile.mkdtemp(prefix="chip-smoke-train-")
    runs = []
    try:
        for steps in TRAIN_LAUNCH_STEPS:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                code = train.main([*TRAIN_LAUNCH, "--steps", str(steps),
                                   "--ckpt", root])
                seconds = time.perf_counter() - t0
            lines = out.getvalue().splitlines()
            runs.append({"steps": steps, "exit": code, "seconds": seconds,
                         "lines": lines})
            check(code == 0 and any("sdc_rejects=0" in ln for ln in lines),
                  f"launcher run to {steps} steps: {lines}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, second = TRAIN_LAUNCH_STEPS
    check(f"resume_from={first}" in runs[1]["lines"][0],
          f"the second run did not resume from step {first}: {runs[1]['lines']}")
    return {"phase": "train_launcher", "argv": TRAIN_LAUNCH, "runs": runs}


def first_gradients(mesh: str, dev) -> tuple[float, dict]:
    """The loss and each parameter's gradient (whole, f64 on the host) of
    the mesh phase's first step: MESH_LAUNCH's model from seed 0 and its
    batch 0, built as `launch/train.py --mesh {mesh}` builds them (a
    process group of one rank, the (1, 1) mesh, its rules and placed
    parameters for "smoke"), through the train step's `loss_and_grads`."""
    import contextlib

    from repro_torch.distrib.sharding import (
        full, make_rules, plain_replicated, use_rules)
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.lm import init_lm
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.steps import loss_and_grads

    cfg = train.REPRO_100M
    group = (train.process_group(dev) if mesh == "smoke"
             else contextlib.nullcontext((0, 1, dev)))
    with group as (_, world, dev):
        device_mesh = None
        if mesh == "smoke":
            device_mesh = make_smoke_mesh(train.smoke_mesh_shape(world),
                                          ("data", "model"), device_type=dev.type)
        rules = make_rules(device_mesh, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads)
        with use_rules(rules), plain_replicated():
            model = init_lm(cfg, 0, device=dev)
            if device_mesh is not None:
                model = train.place_params(model, rules)
            batch = SyntheticLM(cfg, seed=0).batch(0, *MESH_SHAPE)
            loss, grads = loss_and_grads(
                model, {k: v.to(dev) for k, v in batch.items()}, cfg)
            return float(full(loss)), {
                name: full(g).to(torch.float64).cpu().numpy()
                for name, g in grads.items()}


def phase_mesh() -> dict:
    """The launcher in process with --mesh smoke (one rank, mesh (1, 1))
    and then --mesh none, MESH_LAUNCH at the same seed: the sharded run's
    parameters are DTensors, its flash launches counted, its losses those
    of the unsharded run within MESH_RTOL. Then the first step's gradient
    of every parameter both ways (first_gradients), each within MESH_RTOL
    of the unsharded one. The later grad norms and the final checkpoint
    leaves are read, not gated (MESH_RTOL's note). Returns the sharded
    run's launches."""
    import contextlib
    import io
    import shutil
    import tempfile
    from pathlib import Path

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import train

    def logged(lines, name):
        return json.loads(next(ln for ln in lines if ln.startswith(
            f"[train] {name}:")).split(":", 1)[1])

    def checkpoint(final: Path) -> dict:
        leaves = json.loads((final / "manifest.json").read_text())["leaves"]
        return {leaf["path"]: np.load(final / leaf["file"]).astype(np.float64)
                for leaf in leaves}

    def rel(got, want) -> float:
        """A leaf's distance over its norm, as the CPU launcher test reads
        it."""
        return float(np.linalg.norm(got - want)
                     / max(np.linalg.norm(want), 1e-30))

    def top(diffs: dict) -> dict:
        return dict(sorted(diffs.items(), key=lambda kv: -kv[1])[:4])

    root = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    runs = {}
    try:
        for mesh in ("smoke", "none"):
            out = io.StringIO()
            ops.reset_launches()
            with contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                code = train.main([*MESH_LAUNCH, "--steps", str(MESH_STEPS),
                                   "--mesh", mesh, "--ckpt", f"{root}/{mesh}"])
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            lines = out.getvalue().splitlines()
            check(code == 0, f"--mesh {mesh}: {lines}")
            runs[mesh] = {"seconds": seconds, "lines": lines,
                          "losses": logged(lines, "losses"),
                          "grad_norms": logged(lines, "grad_norms"),
                          "final": checkpoint(max(Path(root, mesh).glob("step_*"))),
                          "launches": dict(ops.LAUNCHES)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(not dist.is_initialized(), "the mesh run left its process group")
    smoke, none = runs["smoke"], runs["none"]
    total = smoke["lines"][0].rsplit("sharded_params=", 1)[1]
    placed, count = (int(v) for v in total.split("/"))
    check(sorted(smoke["final"]) == sorted(none["final"]) and none["final"],
          "the two runs' final checkpoints hold other leaves")
    final = {n: rel(smoke["final"][n], w) for n, w in none["final"].items()}

    dev = torch.device("cuda", torch.cuda.current_device())
    (loss_s, grads_s), (loss_n, grads_n) = (first_gradients(m, dev)
                                            for m in ("smoke", "none"))
    check(not dist.is_initialized(), "first_gradients left its process group")
    check(sorted(grads_s) == sorted(grads_n) and grads_n,
          "the two first steps' gradients name other parameters")
    grads = {n: rel(grads_s[n], w) for n, w in grads_n.items()}
    zero = sorted(n for n, w in grads_n.items() if not np.any(w))

    def worst(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    gated = {"losses": worst(smoke["losses"], none["losses"]),
             "first_loss": abs(loss_s - loss_n) / abs(loss_n),
             "first_gradients": max(grads.values())}
    emit({"phase": "mesh", "argv": MESH_LAUNCH, "steps": MESH_STEPS,
          "mesh": [1, 1], "sharded_params": placed, "params": count,
          "losses_smoke": smoke["losses"], "losses_none": none["losses"],
          "max_rel_diff": gated, "tolerance": MESH_RTOL,
          "first_gradients": {"leaves": len(grads), "zero_leaves": zero,
                              "worst": top(grads)},
          "read": {"grad_norms_smoke": smoke["grad_norms"],
                   "grad_norms_none": none["grad_norms"],
                   "grad_norms": worst(smoke["grad_norms"], none["grad_norms"]),
                   "leaves_final": max(final.values()),
                   "worst_final": top(final)},
          "seconds": {m: r["seconds"] for m, r in runs.items()},
          "flash_launches": {m: r["launches"]["flash_attention"]
                             for m, r in runs.items()}})
    check("mesh={'data': 1, 'model': 1}" in smoke["lines"][0],
          f"--mesh smoke's mesh: {smoke['lines'][0]}")
    check(placed == count > 0, f"--mesh smoke placed {placed} of {count}")
    check(smoke["launches"]["flash_attention"] > 0, "no flash launch under the mesh")
    check(len(smoke["losses"]) == len(none["losses"]) == MESH_STEPS,
          f"{len(smoke['losses'])} and {len(none['losses'])} steps logged")
    check(not zero, f"parameters with no gradient: {zero}")
    for what, diff in gated.items():
        check(diff <= MESH_RTOL[what], f"--mesh smoke {what} off by {diff}")
    return smoke["launches"]


def mesh_decode(dev, seed: int) -> dict:
    """Decode under the mesh (phase 15, module docstring): tinyllama-1.1b
    from --seed, caches whose first MESH_DECODE_PREFIX slots hold k and v
    drawn from --seed (both sides start from copies of them, so they need
    not come from the model), then MESH_DECODE_STEPS greedy steps from a
    token drawn from --seed, first without rules, then under the smoke
    rules on a (1, 1) mesh with the counts set to 0 just before. Returns
    those counts."""
    from repro_torch.configs import get_config
    from repro_torch.distrib.sharding import full, make_rules, use_rules
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.lm import init_lm
    from repro_torch.serve.kvcache import init_caches, place_caches
    from repro_torch.serve.steps import build_decode_step

    t0 = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    (b, filled), steps = MESH_DECODE_PREFIX, MESH_DECODE_STEPS
    model = init_lm(cfg, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    caches = init_caches(cfg, b, filled + steps, device=dev)
    for cache in caches:
        for name in ("k", "v"):
            prefix = cache[name][:, :filled]
            prefix.copy_(torch.randn(prefix.shape, generator=gen, device=dev))
        cache["pos"][:filled] = torch.arange(filled, device=dev)
        cache["step"].fill_(filled)
    first = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev,
                          dtype=torch.int32)
    saved = [{name: leaf.clone() for name, leaf in cache.items()}
             for cache in caches]
    decode = build_decode_step(cfg)

    def at(t):
        return torch.full((b,), t, dtype=torch.int32, device=dev)

    def greedy(tok, caches):
        logits_all, tokens = [], []
        for t in range(filled, filled + steps):
            logits, _ = decode(model, caches, {"tokens": tok}, at(t))
            logits = full(logits)
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            logits_all.append(logits)
            tokens.append(tok)
        return torch.stack(logits_all), torch.cat(tokens, dim=1)

    (plain_logits, plain_tokens), plain_s = wall(lambda: greedy(first, caches))
    with train.process_group(dev) as (_, world, dev):
        mesh = make_smoke_mesh(train.smoke_mesh_shape(world), ("data", "model"),
                               device_type=dev.type)
        rules = make_rules(mesh, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads)
        with use_rules(rules):
            model = train.place_params(model, rules)
            placed = place_caches(saved)
            ((logits, tokens), launches), mesh_s = wall(
                lambda: run_counted(ops, lambda: greedy(first, placed)))
        mesh_shape = list(mesh.shape)
    layers = attention_layers(cfg)
    line = {"phase": "mesh_decode", "arch": SERVE_ARCH, "dtype": cfg.activation_dtype,
            "mesh": mesh_shape, "prefix": list(MESH_DECODE_PREFIX),
            "greedy_steps": steps,
            "greedy_s": {"none": plain_s, "smoke": mesh_s},
            "tokens_equal": bool(torch.equal(tokens, plain_tokens)),
            "logits_bit_equal": bool(torch.equal(logits, plain_logits)),
            "max_abs_logits_diff": float((logits - plain_logits).abs().max()),
            "sample": tokens[0].tolist(),
            "launches": {name: n for name, n in launches.items() if n},
            "phase_s": time.perf_counter() - t0}
    emit(line)
    check(mesh_shape == [1, 1], f"the decode mesh is {mesh_shape}")
    check(line["tokens_equal"], "decode under the mesh chose other tokens")
    check(line["logits_bit_equal"],
          f"decode under the mesh is off by {line['max_abs_logits_diff']}")
    check(launches["flash_decode_partial"] == launches["flash_combine"]
          == layers * steps and launches["flash_attention"] == 0,
          f"decode under the mesh launched {launches}")
    return launches


def phase_train(rng, dev, seed: int) -> tuple[dict, dict]:
    """Training on the card (module docstring): B6 under autograd, card
    against CPU, tinyllama-1.1b at full size, the launcher; within
    TRAIN_BUDGET_S. Returns (the flash kernel's autograd cases and the
    forward's and gradient kernels' launches for the kernels line, the
    full model's steps' launches)."""
    t0 = time.perf_counter()
    autograd = train_autograd(rng, dev)
    card_vs_cpu = train_card_vs_cpu(dev, seed)
    full, launches = train_full(dev, seed)
    emit(train_launcher())
    phase_s = time.perf_counter() - t0
    emit({"phase": "train_wall", "phase_s": phase_s, "budget_s": TRAIN_BUDGET_S})
    check(phase_s <= TRAIN_BUDGET_S, f"the train phase took {phase_s:.1f} s")
    return {"autograd_case": autograd, "launches_train": launches["flash_attention"],
            "launches_backward": launches["flash_attention_backward"],
            "launches_backward_f32":
                card_vs_cpu["card_launches"]["flash_attention_backward"],
            "train_steps": len(full["steps"])}, launches


# ---------------------------------------------------------------------------
def kernels_line(rng, dev, launches: dict, errs: dict, strips: dict,
                 trisolve_operands, gateway_flush: dict,
                 row_solve_operands, train_flash: dict) -> dict:
    """Time each kernel, its plain version and the library call at the
    phase-3 shapes, beside its bound; `strips` holds phase 3's strip
    launches of each TRSM wrapper, `trisolve_operands` the linalg phase's
    factors and a right-hand side at its inverse round's chunk shape,
    `gateway_flush` the launches of the gateway phase's full flush,
    `row_solve_operands` the pipeline phase's first block-row solve,
    `train_flash` the train phase's flash launches and autograd case."""
    from repro_torch.kernels import flash_attn, ops, ref, trsm

    f64 = torch.float64
    n, b = SINGLE_N, SINGLE_N // N_SERVERS
    entries: list[dict] = []

    def case(kernel, plain, library, reps, plain_reps, nbytes, ops_count,
             dtype=f64, expect_launches=None, peak=None) -> dict:
        """Device ms and CUDA launches per call of the kernel, the ms of
        its plain version and the library call at one shape, beside the
        bound (operations at `peak`'s rate, default `dtype`'s);
        CUDA-event times in event_ms, and the profiler windows each
        timing took in profile_windows. The launches are the profiled
        calls' device events per call, rounded, and held to
        `expect_launches` (the wrapper's formula) where given. Should
        the profiler still miss an event, a wrapper off its formula is
        off on every call, so at most a quarter of the calls may lack
        one."""
        bound, by = bound_ms(nbytes, ops_count, peak or dtype)
        ms, launches_per_call, per_call, windows = device_profile(
            kernel, reps)
        check(abs(per_call - launches_per_call) * reps <= reps // 4,
              f"{per_call} device events a call")
        if expect_launches is not None:
            check(launches_per_call == expect_launches,
                  f"{per_call} CUDA launches a call, formula {expect_launches}")
        kernel_event = event_ms(kernel, reps)
        plain_ms, plain_event, plain_windows = timed(plain, plain_reps)
        lib_ms, lib_event, lib_windows = (timed(library, reps) if library
                                          else (None, None, None))
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound, "bound_by": by,
                "cuda_launches_per_call": launches_per_call,
                "device_events_per_call": per_call,
                "event_ms": {"kernel": kernel_event, "plain": plain_event,
                             "library": lib_event},
                "profile_windows": {"kernel": windows, "plain": plain_windows,
                                    "library": lib_windows}}

    def row(name, source, replaces, shape, kernel, plain, library, reps,
            plain_reps, nbytes, ops_count, dtype=f64, expect_launches=None,
            peak=None, **extra):
        entries.append({
            "name": name, "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "shape": shape,
            "dtype": str(dtype).removeprefix("torch."),
            **case(kernel, plain, library, reps, plain_reps, nbytes,
                   ops_count, dtype, expect_launches, peak),
            **extra,
            "at_s": time.perf_counter() - STARTED[0],
        })

    m = torch.from_numpy(rng.standard_normal((n, n))).to(dev)
    v = torch.from_numpy(rng.uniform(0.5, 2.0, n)).to(dev)
    row("ced", "ced.cu", "src/repro/kernels/ced.py:69", [n, n],
        lambda: ops.ced(m, v, 1), lambda: ref.ced_ref(m, v, 1), None, 20, 10,
        (2 * n * n + n) * 8, n * n)

    tile = torch.from_numpy(dominant(rng, (INNER, INNER))).to(dev)
    stack = torch.from_numpy(dominant(rng, (BATCH, INNER, INNER))).to(dev)
    w = np.arange(INNER)  # trailing widths b-k-1 of the elimination steps
    tile_ops = float((w + 2 * w * w).sum())
    batch_case = case(
        lambda: ops.lu_panel(stack), lambda: ref.lu_panel_ref(stack),
        lambda: torch.linalg.lu_factor_ex(stack, pivot=False), 50, 10,
        2 * BATCH * INNER * INNER * 8, BATCH * tile_ops, expect_launches=1)
    row("lu_panel", "lu_panel.cu", "src/repro/kernels/lu_panel.py:52",
        [INNER, INNER], lambda: ops.lu_panel(tile),
        lambda: ref.lu_panel_ref(tile),
        lambda: torch.linalg.lu_factor_ex(tile, pivot=False), 50, 10,
        2 * INNER * INNER * 8, tile_ops, expect_launches=1,
        batch_case={"shape": [BATCH, INNER, INNER], **batch_case},
        note="latency-bound: a 32-step dependent chain; one warp a tile "
             "(lu_warp_kernel), four tiles a block; batch_case is the "
             "batch phase's stack")

    lt = (torch.from_numpy(np.tril(rng.standard_normal((b, b)), -1) / b
                           + np.eye(b)).to(dev))
    ut = (torch.from_numpy(np.triu(rng.standard_normal((b, b))) + b * np.eye(b))
          .to(dev))
    rhs = torch.from_numpy(rng.standard_normal((b, b))).to(dev)
    # the panel loop's strips: a 32 x 32 triangle of the compact tile
    # against the 32 x (b - s1) strip beside it and the (b - s1) x 32
    # strip below it, strided views; timed at the widest, s1 = 32
    a = torch.from_numpy(dominant(rng, (b, b))).to(dev)
    tri, right, below = a[:INNER, :INNER], a[:INNER, INNER:], a[INNER:, :INNER]
    w = b - INNER
    strip_lower = case(
        lambda: ops.trsm_lower(tri, right), lambda: ref.trsm_lower_ref(tri, right),
        lambda: torch.linalg.solve_triangular(tri, right, upper=False,
                                              unitriangular=True),
        50, 10, (INNER * (INNER - 1) / 2 + 2 * INNER * w) * 8,
        INNER * (INNER - 1) * w, expect_launches=trsm.cuda_launches(INNER))
    strip_upper = case(
        lambda: ops.trsm_upper_right(tri, below),
        lambda: ref.trsm_upper_right_ref(tri, below),
        lambda: torch.linalg.solve_triangular(tri, below, upper=True, left=False),
        50, 10, (INNER * (INNER + 1) / 2 + 2 * INNER * w) * 8, INNER * INNER * w,
        expect_launches=trsm.cuda_launches(INNER))
    for label, one in (("trsm_lower", strip_lower), ("trsm_upper_right", strip_upper)):
        one.update(shape=[INNER, INNER, w], launches_per_single_call=strips[label])
    emit({"phase": "inner_strip_times", "shape": [INNER, w],
          "strips_per_single_call": sum(strips.values()),
          "trsm_lower": strip_lower, "trsm_upper_right": strip_upper,
          "units": "ms per call: device time under torch.profiler; event_ms "
                   "by CUDA events, with the host's launch latency; "
                   "launches_per_single_call counted on phase 3 (strips "
                   f"{w} down to {INNER} columns wide, timed at the widest)"})
    row("trsm_lower", "trsm.cu", "src/repro/kernels/trsm.py:74", [b, b, b],
        lambda: ops.trsm_lower(lt, rhs), lambda: ref.trsm_lower_ref(lt, rhs),
        lambda: torch.linalg.solve_triangular(lt, rhs, upper=False,
                                              unitriangular=True),
        10, SOLVE_PLAIN_REPS, (b * (b - 1) / 2 + 2 * b * b) * 8,
        b * (b - 1) * b,
        expect_launches=trsm.cuda_launches(b), strip_case=strip_lower,
        note="launches: wrapper calls on the single phase (strip_case's "
             "launches_per_single_call strips, the rest Algorithm-3 "
             "blocks); each call put cuda_launches_per_call kernels on the "
             "stream (leaves and the recursion's products), counted by the "
             "profiler")
    row("trsm_upper_right", "trsm.cu", "src/repro/kernels/trsm.py:114",
        [b, b, b], lambda: ops.trsm_upper_right(ut, rhs),
        lambda: ref.trsm_upper_right_ref(ut, rhs),
        lambda: torch.linalg.solve_triangular(ut, rhs, upper=True, left=False),
        10, SOLVE_PLAIN_REPS, (b * (b + 1) / 2 + 2 * b * b) * 8, b * b * b,
        expect_launches=trsm.cuda_launches(b), strip_case=strip_upper,
        note="the lower solver on the transposed problem (trsm.cu)")
    # the pipeline's block-row solve (L_ii against the server's whole
    # Schur-updated row), on the operands the pipeline phase gave it
    lii, srow = row_solve_operands
    rb, rn = srow.shape[-2], srow.shape[-1]
    row("trsm_lower:row_solve", "trsm.cu", "src/repro/kernels/trsm.py:74",
        [rb, rb, rn], lambda: ops.trsm_lower(lii, srow),
        lambda: ref.trsm_lower_ref(lii, srow),
        lambda: torch.linalg.solve_triangular(lii, srow, upper=False,
                                              unitriangular=True),
        10, SOLVE_PLAIN_REPS, (rb * (rb - 1) / 2 + 2 * rb * rn) * 8,
        rb * (rb - 1) * rn,
        expect_launches=trsm.cuda_launches(rb),
        note="the pipeline's row solve (distributed=True): each server "
             "solves L_ii against its whole (b, n) Schur-updated row on its "
             "slot's stream, the reference's solve_triangular in "
             "_server_program (src/repro/distrib/spdc_pipeline.py:132); "
             "launches: wrapper calls in the pipeline phase's single run, "
             "one per server; the library call is a yardstick the port "
             "never calls")
    # the trisolve legs on the linalg phase's factors, at its inverse
    # round's chunk shape (n' x n' against n' x n'/N)
    l_f, u_f, rhs_f = trisolve_operands
    nn, mm = rhs_f.shape
    for leg, (upper, trans, replaces) in TRISOLVE_LEGS.items():
        t = u_f if upper else l_f
        row(f"trsm:trisolve_{leg}", "trsm.cu", replaces, [nn, nn, mm],
            lambda t=t, upper=upper, trans=trans: ops.trsm_left(
                t, rhs_f, upper=upper, transpose_t=trans),
            lambda t=t, upper=upper, trans=trans: ref.trsm_left_ref(
                t, rhs_f, upper=upper, transpose_t=trans),
            lambda t=t, upper=upper, trans=trans: torch.linalg.solve_triangular(
                t.T if trans else t, rhs_f, upper=upper != trans),
            10, SOLVE_PLAIN_REPS, (nn * (nn + 1) / 2 + 2 * nn * mm) * 8,
            nn * nn * mm,
            expect_launches=trsm.cuda_launches(nn),
            note="a left solve of a trisolve chunk (ops.trsm_left), timed "
                 "at the inverse round's chunk shape: launches are wrapper "
                 "calls on the linalg phase's op plan (solve, adjoint solve, "
                 "inverse; N chunks a round), whose narrow rounds ran at "
                 "n' x rhs/N, held to the plain version there too "
                 "(linalg phase, legs_vs_plain_narrow); an "
                 "upper op(T) runs the lower solver reversed, J op(T) J "
                 "at negated strides; the library call "
                 "(solve_triangular) is a yardstick the port never calls")
    # the trailing update of lu_blocked at the sequential phase's blocks,
    # its inner updates (K = 32: views of a diagonal tile, as
    # lu_panel_blocked passes them, timed at the widest) and a stack
    cs, as_, bs = (torch.from_numpy(rng.standard_normal((b, b))).to(dev)
                   for _ in range(3))
    diag = torch.from_numpy(dominant(rng, (b, b))).to(dev)
    ic, ia, ib = diag[INNER:, INNER:], diag[INNER:, :INNER], diag[:INNER, INNER:]
    w = b - INNER
    inner_case = case(
        lambda: ops.schur_update(ic, ia, ib),
        lambda: ref.schur_update_ref(ic, ia, ib),
        lambda: torch.addmm(ic, ia, ib, alpha=-1), 50, 10,
        (2 * w * w + 2 * INNER * w) * 8, 2 * w * w * INNER, expect_launches=1)
    k3 = [torch.from_numpy(rng.standard_normal((BATCH, 256, 256))).to(dev)
          for _ in range(3)]
    batch_case = case(
        lambda: ops.schur_update(*k3), lambda: ref.schur_update_ref(*k3),
        lambda: torch.baddbmm(*k3, alpha=-1), 20, 20,
        4 * BATCH * 256 * 256 * 8, 2 * BATCH * 256 ** 3, expect_launches=1)
    row("schur_update", "schur.cu", "src/repro/kernels/gemm.py:46",
        [b, b, b], lambda: ops.schur_update(cs, as_, bs),
        lambda: ref.schur_update_ref(cs, as_, bs),
        lambda: torch.addmm(cs, as_, bs, alpha=-1), 20, 20,
        4 * b * b * 8, 2 * b * b * b, expect_launches=1,
        inner_case={"shape": [w, INNER, w], **inner_case},
        batch_case={"shape": [BATCH, 256, 256, 256], **batch_case},
        note="launches from the sequential phase (lu_blocked): "
             f"{SINGLE_N // SEQ_BLOCK} x {SEQ_BLOCK // INNER - 1} of them at "
             "inner_case's K = 32 (down from its M = N), the rest trailing "
             "updates; f64 on the tensor cores (mma.sync m16n8k4), 128 x 64 "
             "blocks, a 3-stage cp.async ring")

    # attention at the serving path's prefill and decode shapes, bf16
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    bf16 = torch.bfloat16
    (hq, hkv, d), fb, s = FLASH_HEADS, PREFILL_BATCH, PREFILL_LEN
    q, k, v = flash_inputs(rng, dev, bf16, fb, hq, hkv, s, s, d)
    qd, kd, vd = flash_inputs(rng, dev, bf16, fb, hq, hkv, 1, s, d, s + 128)
    names = prefill_kernels(lambda: ops.flash_attention(q, k, v, causal=True),
                            q)
    decode_case = case(
        lambda: ops.flash_attention(qd, kd, vd),
        lambda: ref.flash_attention_ref(qd, kd, vd),
        lambda: sdpa(qd, kd, vd, enable_gqa=True), 50, 10,
        2 * (2 * fb * hq * d + 2 * fb * hkv * s * d), 4 * fb * hq * s * d,
        bf16, expect_launches=flash_attn.cuda_launches(qd, kd))
    decode_case["device_kernels"] = decode_kernels(
        lambda: ops.flash_attention(qd, kd, vd), flash_attn.device_kernel(qd))
    row("flash_attention", "flash_attn.cu", "src/repro/kernels/flash_attn.py:79",
        [fb, hq, s, d], lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 10, 3,
        2 * (2 * fb * hq * s * d + 2 * fb * hkv * s * d),
        2 * fb * hq * s * s * d, dtype=bf16,
        kv_shape=[fb, hkv, s, d],
        expect_launches=flash_attn.cuda_launches(q, k),
        device_kernels=names,
        decode_case={"q": [fb, hq, 1, d], "kv_prefix": [fb, hkv, s, d],
                     **decode_case},
        launches_train=train_flash["launches_train"],
        autograd_case=train_flash["autograd_case"],
        note="launches from the serve phase's greedy_generate run (22 "
             "layers x 47 decode steps), launches_train from the train "
             "phase's tinyllama steps (22 forwards and 22 remat recomputes "
             "a step, under autograd; autograd_case: the forward kernel, "
             "the gradient kernels, the plain backward and SDPA's backward "
             "at the prefill shape); causal prefill counted at half "
             "of 4·B·Hq·S²·D; bf16 prefill on wgmma fed by a TMA ring "
             "(device_kernels, by the profiler), decode in one launch of "
             "flash_decode_kernel (decode_case's device_kernels and "
             "cuda_launches_per_call): each GQA group packed into a block, "
             "four warps splitting each 128-key chunk, a TMA ring fed by a "
             "producer warp, the chunks merged by a thread block cluster; "
             "the library call "
             "(scaled_dot_product_attention) is a yardstick the port never "
             "calls")
    # the same shapes in f32 (the FMA kernel, one launch a call), which
    # the serve phase's f32 decode against prefill and f32 prefill run
    f32 = torch.float32
    q, k, v = flash_inputs(rng, dev, f32, fb, hq, hkv, s, s, d)
    qd, kd, vd = flash_inputs(rng, dev, f32, fb, hq, hkv, 1, s, d, s + 128)
    decode_case = case(
        lambda: ops.flash_attention(qd, kd, vd),
        lambda: ref.flash_attention_ref(qd, kd, vd),
        lambda: sdpa(qd, kd, vd, enable_gqa=True), 50, 10,
        4 * (2 * fb * hq * d + 2 * fb * hkv * s * d), 4 * fb * hq * s * d,
        f32, expect_launches=flash_attn.cuda_launches(qd, kd))
    row("flash_attention:f32", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [fb, hq, s, d],
        lambda: ops.flash_attention(q, k, v, causal=True),
        lambda: ref.flash_attention_ref(q, k, v, causal=True),
        lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), 10, 3,
        4 * (2 * fb * hq * s * d + 2 * fb * hkv * s * d),
        2 * fb * hq * s * s * d, dtype=f32, kv_shape=[fb, hkv, s, d],
        expect_launches=flash_attn.cuda_launches(q, k),
        decode_case={"q": [fb, hq, 1, d], "kv_prefix": [fb, hkv, s, d],
                     **decode_case},
        note="launches from the serve phase's f32 runs (decode against "
             "prefill over 128 tokens, and the f32 card prefill); f32 on "
             "the FMA pipes (flash_fma32_kernel): prefill 128 query rows "
             "a block, 8 x 4 a thread, a cp.async ring; decode packs each "
             "GQA group, splits the keys and merges the chunks in a second "
             "launch, flash_combine_kernel (decode_case's "
             "cuda_launches_per_call); the bound at the f32 "
             "rate")
    # B6's gradient (csrc/flash_bwd.cu) at the training shape, bf16 and
    # f32: the three kernels on the forward kernel's own output and lse,
    # beside their plain version on the same inputs and SDPA's backward
    # (K and V repeated to the query heads; a yardstick the port never
    # calls); the bound is the 5 products of 2·D operations a seen pair
    # and q, k, v, O, lse, dO and the three gradients once each
    from repro_torch.kernels import flash_bwd

    pairs = fb * hq * s * (s + 1) // 2
    for dtype, suffix in ((bf16, ""), (f32, ":f32")):
        q, k, v = flash_inputs(rng, dev, dtype, fb, hq, hkv, s, s, d)
        g = flash_inputs(rng, dev, dtype, fb, hq, hkv, s, s, d)[0]
        o, lse = flash_attn.flash_attention_lse_cuda(q, k, v, causal=True)
        grad = lambda: flash_bwd.flash_attention_backward_cuda(q, k, v, o, lse, g)
        plain_grad = lambda: ref.flash_attention_backward_ref(q, k, v, o, lse, g)
        errs[f"flash_attention_backward{suffix}"] = max(
            max_err(a.float(), c.float())[0] for a, c in zip(grad(), plain_grad()))
        qr, kr, vr = (t.detach().requires_grad_() for t in (
            q, k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)))
        lib_out = sdpa(qr, kr, vr, is_causal=True)
        row(f"flash_attention_backward{suffix}", "flash_bwd.cu",
            "src/repro/kernels/flash_attn.py:79", [fb, hq, s, d], grad,
            plain_grad,
            lambda: torch.autograd.grad(lib_out, (qr, kr, vr), g,
                                        retain_graph=True), 10, 3,
            dtype.itemsize * 4 * (fb * hq * s * d + fb * hkv * s * d)
            + 4 * fb * hq * s, 10 * d * pairs, dtype=dtype,
            kv_shape=[fb, hkv, s, d], expect_launches=flash_bwd.CUDA_LAUNCHES,
            kernels_ms=kernel_split(grad, 10),
            replaces_note="the port's gradient of B6, which has no Pallas "
                          "backward (the reference differentiates its jnp "
                          "attention)",
            note="launches: the train phase's calls of the gradient "
                 "kernels (tinyllama's steps in bf16, one a layer a step; "
                 "the card-against-CPU f32 step for :f32), 3 CUDA launches "
                 "each (delta, dK and dV, dQ; kernels_ms); causal pairs "
                 "counted once; the kernels run 7 products where the bound "
                 "counts 5; bf16 on mma.sync m16n8k16, f32 on the FMA "
                 "pipes")
        del q, k, v, g, o, lse, qr, kr, vr, lib_out
        torch.cuda.empty_cache()
    # the split decode's halves (decode under a mesh), bf16: the partial
    # over the first of two ranks' halves of the decode case's keys, and
    # the merge of both halves' chunks
    qd, kd, vd = flash_inputs(rng, dev, bf16, fb, hq, hkv, 1, s, d, s + 128)
    half = s // 2
    per_half = half // 128
    kh, vh = kd[:, :, :half], vd[:, :, :half]
    row("flash_attention:decode_partial", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [fb, hq, 1, d],
        lambda: ops.flash_decode_partial(qd, kh, vh, chunks=per_half),
        lambda: ref.flash_decode_partial_ref(qd, kh, vh, chunks=per_half),
        None, 50, 10,
        2 * (fb * hq * d + 2 * fb * hkv * half * d)
        + 4 * per_half * fb * hq * (d + 2),
        4 * fb * hq * half * d, bf16, expect_launches=1,
        device_kernels=decode_kernels(
            lambda: ops.flash_decode_partial(qd, kh, vh, chunks=per_half),
            flash_attn.device_kernel(qd)),
        kv_range=[fb, hkv, half, d], partials=[per_half, fb, hq, 1, d + 2],
        note="launches from the mesh phase's decode under the (1, 1) mesh "
             "(22 layers x 16 greedy steps); the split decode's first "
             "half alone (flash_decode_kernel, a block a chunk and no "
             "cluster, every chunk's f32 partial "
             "left in the caller's buffer), over one of two ranks' key "
             "ranges; bytes: q, the range's K and V once, the partials "
             "written once; no library call computes a partial")
    part = torch.cat([ops.flash_decode_partial(qd, kd[:, :, lo:lo + half],
                                               vd[:, :, lo:lo + half],
                                               chunks=per_half)
                      for lo in (0, half)])
    row("flash_attention:combine", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", list(part.shape),
        lambda: ops.flash_combine(part, bf16),
        lambda: ref.flash_combine_ref(part, bf16), None, 50, 10,
        4 * part.numel() + 2 * fb * hq * d, 2 * part.numel(), f32,
        expect_launches=1, out_dtype="bfloat16",
        device_kernels=decode_kernels(
            lambda: ops.flash_combine(part, bf16),
            "flash_combine_kernel<__nv_bfloat16, 2>"),
        note="launches from the mesh phase's decode under the (1, 1) mesh; "
             "the split decode's second half alone (flash_combine_kernel, "
             "merge_row: the decode cluster's own merge) "
             "over two ranges' 16 chunks of f32 partials into the bf16 "
             "output; bytes: the partials read once, the output written "
             "once; the bound at the f32 rate; no library call merges "
             "partials")
    # gemma3's window shape in f32: the kernel's D = 256 configuration
    q, k, v = flash_inputs(rng, dev, f32, fb, 4, 1, s, s, 256)
    kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
    i = torch.arange(s, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 1024)
    pairs = sum(min(t + 1, 1024) for t in range(s))
    row("flash_attention:f32_sliding", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [fb, 4, s, 256],
        lambda: ops.flash_attention(q, k, v, causal=True, window=1024),
        lambda: ref.flash_attention_ref(q, k, v, causal=True, window=1024),
        lambda: sdpa(q, kr, vr, attn_mask=band), 10, 3,
        4 * (2 * fb * 4 * s * 256 + 2 * fb * s * 256),
        4 * fb * 4 * 256 * pairs, dtype=f32, kv_shape=[fb, 1, s, 256],
        window=1024, expect_launches=flash_attn.cuda_launches(q, k),
        note="gemma3-1b's sliding-layer shape in f32: the FMA kernel at "
             "D = 256 (64 query rows a block, 32-key tiles); launches are "
             "the f32 route's on the serve phase (D = 64), since no f32 "
             "run there has this shape; the bound counts the unmasked "
             "pairs, the library call is SDPA with the band as a mask")
    del q, k, v, kr, vr
    # the model families' shapes in bf16, launches by route over the
    # serve phase's model runs (FlashRoutes); the library calls get K/V
    # repeated to the query heads beforehand, so SDPA takes its own
    # kernels and not a materialized fallback
    w, s2 = 1024, PREFILL_LEN
    q, k, v = flash_inputs(rng, dev, bf16, fb, 4, 1, s2, s2, 256)
    kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
    i = torch.arange(s2, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    pairs = sum(min(t + 1, w) for t in range(s2))
    names = prefill_kernels(
        lambda: ops.flash_attention(q, k, v, causal=True, window=w), q)
    row("flash_attention:sliding", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [fb, 4, s2, 256],
        lambda: ops.flash_attention(q, k, v, causal=True, window=w),
        lambda: ref.flash_attention_ref(q, k, v, causal=True, window=w),
        lambda: sdpa(q, kr, vr, attn_mask=band), 10, 3,
        2 * (2 * fb * 4 * s2 * 256 + 2 * fb * s2 * 256),
        4 * fb * 4 * 256 * pairs, dtype=bf16, kv_shape=[fb, 1, s2, 256],
        window=w, expect_launches=flash_attn.cuda_launches(q, k),
        device_kernels=names,
        note="gemma3-1b's sliding layers: the window route, prefill "
             "past the 1024-token window; the bound counts the unmasked "
             "pairs, Σ_i min(i + 1, W); the library call is SDPA with "
             "the band as a boolean mask")
    q, k, v = flash_inputs(rng, dev, bf16, fb, 4, 1, 1, w, 256, w)
    kr, vr = (t.repeat_interleave(4, dim=1) for t in (k, v))
    row("flash_attention:ring_decode", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [fb, 4, 1, 256],
        lambda: ops.flash_attention(q, k, v), lambda: ref.flash_attention_ref(q, k, v),
        lambda: sdpa(q, kr, vr), 50, 10,
        2 * (2 * fb * 4 * 256 + 2 * fb * w * 256), 4 * fb * 4 * w * 256,
        dtype=bf16, kv_shape=[fb, 1, w, 256],
        expect_launches=flash_attn.cuda_launches(q, k),
        device_kernels=decode_kernels(lambda: ops.flash_attention(q, k, v),
                                      flash_attn.device_kernel(q)),
        note="gemma3-1b's sliding layers in decode, over a wrapped ring "
             "of 1024 slots (every slot attended): the decode route, one "
             "launch of flash_decode_kernel at D = 256 (packed GQA group, "
             "keys split into 8 chunks, the chunks merged by the 8-block "
             "cluster); the library call is SDPA with K and V repeated to "
             "the query heads")
    del q, k, v, kr, vr
    cw, heads, kvh, d2 = 8192, 40, 8, 128
    q, k, v = flash_inputs(rng, dev, bf16, 2, heads, kvh, cw, cw, d2)
    kr, vr = (t.repeat_interleave(heads // kvh, dim=1) for t in (k, v))

    def plain_chunks():
        for c in range(2):
            for g in range(kvh):
                hs = slice(g * heads // kvh, (g + 1) * heads // kvh)
                ref.flash_attention_ref(q[c:c + 1, hs], k[c:c + 1, g:g + 1],
                                        v[c:c + 1, g:g + 1], causal=True)

    names = prefill_kernels(lambda: ops.flash_attention(q, k, v, causal=True),
                            q)
    row("flash_attention:chunk_fold", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [2, heads, cw, d2],
        lambda: ops.flash_attention(q, k, v, causal=True), plain_chunks,
        lambda: sdpa(q, kr, vr, is_causal=True), 5, 1,
        2 * (2 * 2 * heads * cw * d2 + 2 * 2 * kvh * cw * d2),
        4 * heads * d2 * 2 * (cw * (cw + 1) // 2), dtype=bf16,
        kv_shape=[2, kvh, cw, d2], expect_launches=flash_attn.cuda_launches(q, k),
        device_kernels=names,
        note="llama4's chunked layers: a 16384-token prefill folded into "
             "two 8192-token chunks as the batch, run causal; the plain "
             "version runs one kv-head group of one chunk at a time (16 "
             "calls) to fit the card")
    del q, k, v, kr, vr
    q, k, v = flash_inputs(rng, dev, bf16, fb, 16, 16, s2, s2, 80)
    names = prefill_kernels(lambda: ops.flash_attention(q, k, v, causal=False),
                            q)
    row("flash_attention:non_causal", "flash_attn.cu",
        "src/repro/kernels/flash_attn.py:79", [fb, 16, s2, 80],
        lambda: ops.flash_attention(q, k, v, causal=False),
        lambda: ref.flash_attention_ref(q, k, v, causal=False),
        lambda: sdpa(q, k, v), 10, 3, 2 * 4 * fb * 16 * s2 * 80,
        4 * fb * 16 * s2 * s2 * 80, dtype=bf16, kv_shape=[fb, 16, s2, 80],
        expect_launches=flash_attn.cuda_launches(q, k),
        device_kernels=names,
        note="hubert-xlarge, the encoder: non-causal prefill at head "
             "dimension 80")
    del q, k, v
    torch.cuda.empty_cache()
    # the f32 routes the f32 protocol and plain f32 lu_blocked run, and
    # the mixed routes (both pairs; mixed lu_blocked runs f32 -> f64):
    # the bound counts the storage type's bytes and the arithmetic
    # type's operations
    m32 = torch.from_numpy(rng.standard_normal((n, n))).to(dev, torch.float32)
    v32 = torch.from_numpy(rng.uniform(0.5, 2.0, n)).to(dev, torch.float32)
    row("ced:f32", "ced.cu", "src/repro/kernels/ced.py:69", [n, n],
        lambda: ops.ced(m32, v32, 1), lambda: ref.ced_ref(m32, v32, 1), None,
        20, 10, (2 * n * n + n) * 4, n * n, dtype=torch.float32,
        note="the f32 protocol's Cipher")
    w = b - INNER
    tile_ops = float((np.arange(INNER) + 2 * np.arange(INNER) ** 2).sum())
    routes = [(name, st, acc, targs) for name, st, acc, targs in MIXED_ROUTES]
    routes.append(("f32", torch.float32, None, "float, float"))
    routes += list(NARROW_ROUTES)
    for route, st, acc, targs in routes:
        size = torch.finfo(st).bits // 8
        arith = acc or st
        cases = route_cases(rng, dev, st)
        # a library call computes the same function on the f32 default
        # routes alone (no library LU or solve takes a half type)
        f32_lib = acc is None and st == torch.float32

        def names_of(kernel_fn, want=f"<{targs}"):
            found, _ = route_profile(kernel_fn)
            check(bool(found) and all(want in k for k in found),
                  f"route {route} ran {found}")
            return found

        (tile,), (stack,) = cases["lu_panel"].values()
        lib_panel = ((lambda t: lambda: torch.linalg.lu_factor_ex(t, pivot=False))
                     if f32_lib else (lambda t: None))
        panel = lambda t: lambda: ops.lu_panel(t, acc_dtype=acc)
        plain_panel = lambda t: lambda: ref.lu_panel_ref(t, acc)
        batch_case = case(panel(stack), plain_panel(stack), lib_panel(stack),
                          50, 10, 2 * BATCH * INNER * INNER * size,
                          BATCH * tile_ops, arith, expect_launches=1)
        row(f"lu_panel:{route}", "lu_panel.cu",
            "src/repro/kernels/lu_panel.py:52", [INNER, INNER], panel(tile),
            plain_panel(tile), lib_panel(tile), 50, 10,
            2 * INNER * INNER * size, tile_ops, arith, expect_launches=1,
            batch_case={"shape": [BATCH, INNER, INNER], **batch_case},
            kernels=names_of(panel(tile)), storage=str(st),
            arithmetic=str(arith))
        for kernel, source, tri_bytes, ops_of in (
                ("trsm_lower", "src/repro/kernels/trsm.py:74",
                 lambda k: k * (k - 1) / 2, lambda k, mm: k * (k - 1) * mm),
                ("trsm_upper_right", "src/repro/kernels/trsm.py:114",
                 lambda k: k * (k + 1) / 2, lambda k, mm: k * k * mm)):
            (tri, rhs), (stri, srhs) = cases[kernel].values()
            call = lambda t, r: lambda: getattr(ops, kernel)(t, r, acc_dtype=acc)
            plain = lambda t, r: lambda: getattr(ref, f"{kernel}_ref")(t, r, acc)
            if not f32_lib:
                lib = lambda t, r: None
            elif kernel == "trsm_lower":
                lib = lambda t, r: lambda: torch.linalg.solve_triangular(
                    t, r, upper=False, unitriangular=True)
            else:
                lib = lambda t, r: lambda: torch.linalg.solve_triangular(
                    t, r, upper=True, left=False)
            strip_case = case(call(stri, srhs), plain(stri, srhs),
                              lib(stri, srhs), 50, 10,
                              (tri_bytes(INNER) + 2 * INNER * w) * size,
                              ops_of(INNER, w), arith,
                              expect_launches=trsm.cuda_launches(INNER))
            row(f"{kernel}:{route}", "trsm.cu", source, [b, b, b],
                call(tri, rhs), plain(tri, rhs), lib(tri, rhs), 10,
                SOLVE_PLAIN_REPS,
                (tri_bytes(b) + 2 * b * b) * size, ops_of(b, b), arith,
                expect_launches=trsm.cuda_launches(b),
                strip_case={"shape": [INNER, INNER, w], **strip_case},
                kernels=names_of(call(tri, rhs)), storage=str(st),
                arithmetic=str(arith))
        if (route, st, acc, targs) in NARROW_ROUTES:
            continue  # their Schur route is the half -> f32 row's
        (cs, as_, bs), (ic, ia, ib) = cases["schur_update"].values()
        upd = lambda c, a, bb: lambda: ops.schur_update(c, a, bb, acc_dtype=acc)
        plain_upd = lambda c, a, bb: lambda: ref.schur_update_ref(c, a, bb, acc)
        # one PyTorch call computes the same function where the route's
        # sum is the storage type's own (f32), or f32 for bf16 (addmm)
        lib_upd = ((lambda c, a, bb: lambda: torch.addmm(c, a, bb, alpha=-1))
                   if acc != torch.float64 else (lambda c, a, bb: None))
        # products of bf16/f16 operands are exact in f32, summed in f32:
        # what the tensor cores' bf16/f16 route computes, so the bound
        # takes that rate; the panel and the solves multiply f32
        # intermediates and stay at the f32 rate
        schur_peak = st if st in (torch.bfloat16, torch.float16) else arith
        inner_case = case(upd(ic, ia, ib), plain_upd(ic, ia, ib),
                          lib_upd(ic, ia, ib), 50, 10,
                          (2 * w * w + 2 * INNER * w) * size, 2 * w * w * INNER,
                          arith, expect_launches=1, peak=schur_peak)
        row(f"schur_update:{route}", "schur.cu", "src/repro/kernels/gemm.py:46",
            [b, b, b], upd(cs, as_, bs), plain_upd(cs, as_, bs),
            lib_upd(cs, as_, bs), 20, 20, 4 * b * b * size, 2 * b * b * b,
            arith, expect_launches=1, peak=schur_peak,
            inner_case={"shape": [w, INNER, w], **inner_case},
            kernels=names_of(upd(cs, as_, bs), schur_kernel(route)),
            storage=str(st), arithmetic=str(arith))
    for e in entries:
        e.update(route="cuda", launches=launches[e["name"]],
                 max_abs_err=errs[e["name"]])
        if e["name"] in MAIN_PATH:
            e["launches_gateway_flush"] = gateway_flush[e["name"]]
    # the rows (their own timings or a case's) that needed a second window
    PROFILE_WINDOWS["retried_rows"] = [
        e["name"] for e in entries
        if any(w > 1 for timing in (e, *(v for v in e.values()
                                         if isinstance(v, dict)
                                         and "profile_windows" in v))
               for w in timing["profile_windows"].values() if w)]
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

    started = STARTED[0] = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    # the f32, mixed-route and recovery phases draw from a stream of their
    # own, so the earlier phases keep their inputs
    rng_routes = np.random.default_rng([args.seed, 1])
    # and so do the socket and rateless phases, and the linalg phase
    rng_socket = np.random.default_rng([args.seed, 2])
    rng_linalg = np.random.default_rng([args.seed, 3])
    rng_gateway = np.random.default_rng([args.seed, 4])
    rng_pipeline = np.random.default_rng([args.seed, 5])
    rng_train = np.random.default_rng([args.seed, 6])
    dev = torch.device("cuda", torch.cuda.current_device())

    phase_build()
    card = card_line()
    emit({"phase": "card", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card})
    errs = phase_kernels(rng, dev)
    single_launches, strips = phase_single(rng, dev)
    per_phase = {
        "single": (single_launches, MAIN_PATH),
        "batch": (phase_batch(rng, dev), MAIN_PATH),
        "padded": (phase_padded(rng, dev), MAIN_PATH),
        "tamper": (phase_tamper(rng), MAIN_PATH),
    }
    schur_errs = phase_schur(rng, dev)
    errs["schur_update"] = schur_errs[torch.float64]
    errs["schur_update:f32"] = schur_errs[torch.float32]
    per_phase["sequential"] = (phase_sequential(rng, dev), SEQUENTIAL_PATH)
    per_phase["role_split"] = (phase_role_split(rng, dev), MAIN_PATH)
    # the workers launch the server kernels in their own processes
    mp_launches, mp_recovery = phase_multiprocess(rng, dev, rng_routes)
    per_phase["multiprocess"] = (mp_launches, CLIENT_PATH)
    per_phase["faults"] = (phase_faults(rng), MAIN_PATH)
    errs.update(phase_routes(rng_routes, dev))
    errs["ced:f32"] = errs["ced"]  # phase 2's CED cases include f32
    f32_single, f32_batch = phase_f32_protocol(rng_routes, dev)
    per_phase["f32_single"] = (f32_single, MAIN_PATH)
    per_phase["f32_batch"] = (f32_batch, MAIN_PATH)
    seq_routes = phase_sequential_routes(rng_routes, dev)
    for route, launches in seq_routes.items():
        per_phase[f"sequential_{route}"] = (launches, SEQUENTIAL_PATH)
    per_phase["recovery"] = (phase_recovery(rng_routes, dev, mp_recovery),
                             MAIN_PATH)
    per_phase["pipeline"], row_solve = phase_pipeline(rng_pipeline, dev)
    per_phase["pipeline"] = (per_phase["pipeline"], MAIN_PATH)
    # the daemons launch the server kernels in their own processes
    socket_launches, rateless_launches, gateway, linalg = phase_daemons(
        rng_socket, dev, rng_linalg, rng_gateway)
    per_phase["socket"] = (socket_launches, CLIENT_PATH)
    per_phase["rateless"] = (rateless_launches, CLIENT_PATH)
    per_phase["gateway"] = (gateway["launches"], GATEWAY_PATH)
    per_phase["linalg"] = (linalg["launches"], LINALG_PATH)
    errs.update(linalg["errs"])
    for name, err in gateway["errs"].items():
        errs[name] = max(errs[name], err)
    errs.update(phase_flash(rng, dev))
    serve_launches, f32_flash_launches, (model_launches, flash_routes) = \
        phase_serve(rng, dev, args.seed)
    per_phase["serve"] = (serve_launches, SERVE_PATH)
    from repro_torch.configs import get_config
    for arch, arch_launches in model_launches.items():
        path = SERVE_PATH if attention_layers(get_config(arch)) else ()
        per_phase[f"serve {arch}"] = (arch_launches, path)
    errs.update(models_vs_plain(rng, dev))
    train_flash, per_phase["train"] = phase_train(rng_train, dev, args.seed)
    per_phase["train"] = (per_phase["train"], TRAIN_PATH)
    per_phase["mesh"] = (phase_mesh(), SERVE_PATH)
    per_phase["mesh_decode"] = (mesh_decode(dev, args.seed), MESH_DECODE_PATH)
    for phase, (launches, path) in per_phase.items():
        for name in path:
            check(launches[name] > 0, f"{name} never launched in phase {phase}")
    phase_profile(rng)
    launches = dict(per_phase["single"][0])
    launches["schur_update"] = per_phase["sequential"][0]["schur_update"]
    launches["flash_attention"] = per_phase["serve"][0]["flash_attention"]
    # each route's row: its launches on the path that runs it (the f32
    # protocol's single run, plain f32, mixed and half lu_blocked, the
    # half ones with acc_dtype=float32 for the bf16/f16 -> f32 rows)
    for name in ("ced", "lu_panel", "trsm_lower", "trsm_upper_right"):
        launches[f"{name}:f32"] = f32_single[name]
    for name in SEQUENTIAL_PATH:
        for route in ("f32_f64", "bf16_f32", "f16_f32", "bf16_f64", "f16_f64"):
            launches[f"{name}:{route}"] = seq_routes[route][name]
    for name in SERVER_PATH:
        for route, _, _, _ in NARROW_ROUTES:
            launches[f"{name}:{route}"] = seq_routes[route][name]
    launches["schur_update:f32"] = seq_routes["f32"]["schur_update"]
    check(f32_flash_launches > 0, "flash_attention never launched in f32")
    launches["flash_attention:f32"] = f32_flash_launches
    launches["flash_attention:f32_sliding"] = f32_flash_launches
    for leg in TRISOLVE_LEGS:
        launches[f"trsm:trisolve_{leg}"] = linalg["legs"][leg]
    launches["trsm_lower:row_solve"] = row_solve["calls"]
    for route in ("sliding", "ring_decode", "chunk_fold", "non_causal"):
        launches[f"flash_attention:{route}"] = flash_routes[route]
    launches["flash_attention_backward"] = train_flash["launches_backward"]
    launches["flash_attention_backward:f32"] = \
        train_flash["launches_backward_f32"]
    launches["flash_attention:decode_partial"] = \
        per_phase["mesh_decode"][0]["flash_decode_partial"]
    launches["flash_attention:combine"] = \
        per_phase["mesh_decode"][0]["flash_combine"]
    errs["trsm_lower:row_solve"] = row_solve["max_abs_err"]
    line = kernels_line(rng, dev, launches, errs, strips, linalg["operands"],
                        gateway["flush"], row_solve["operands"], train_flash)
    emit({"phase": "run", "wall_s": time.perf_counter() - started,
          "profile_windows": PROFILE_WINDOWS})
    emit(line)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
