#!/usr/bin/env python3
"""A tinyllama-1.1b training step in two source trees, alternated, on one
NVIDIA GPU.

    python3 train_ab.py --tree parent=.checkout/parent/src --tree change=src \\
        [--rounds 1] [--seed 0]

Each tree's run is a process of its own with that tree's `src` on its
path, so two checkouts of `repro_torch` never share one; each builds its
own kernels. A run trains tinyllama-1.1b as chip_smoke.py's train phase
does: full width and depth in its config's dtypes (bf16, f32 AdamW
state, remat "nothing"), AdamWConfig(lr=1e-3, warmup_steps=1), one batch
of 4 × 2048 tokens from SyntheticLM(seed); one warm step, then STEPS
timed steps, each closed by a synchronize, with
torch.cuda.max_memory_allocated over the warm and timed steps; then one
step under torch.profiler, split by chip_smoke.train_split into B6's
forward kernel, its gradient kernels, the plain attention backward (the
range its tree's flash_grad puts around autograd through the plain
version: PLAIN_BACKWARD_RANGE, or BACKWARD_RANGE in a tree whose
backward was that autograd), the rest of the backward, the forward and
the optimizer. It prints one JSON line a run; the trees run in the
order A B B A in every round (schur_ab.main), and the last line gives
each number's median by tree, the second tree's over the first's, and
the card's name and power limit.
"""
from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path

import schur_ab

ROOT = Path(__file__).resolve().parent
ARCH, BATCH, SEQ, STEPS = "tinyllama-1.1b", 4, 2048, 3


def child(src: str, seed: int) -> dict:
    import torch

    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_grad
    from repro_torch.models.lm import init_lm
    from repro_torch.train.data import SyntheticLM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.steps import build_train_step

    sys.path.insert(1, str(ROOT))
    from chip_smoke import profiled, train_split

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    model = init_lm(cfg, seed, device=dev)
    batch = {k: v.to(dev) for k, v in
             SyntheticLM(cfg, seed=seed).batch(0, BATCH, SEQ).items()}
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    opt = init_opt_state(model, opt_cfg)
    step = build_train_step(cfg, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for i in range(1 + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, batch)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    plain = getattr(flash_grad, "PLAIN_BACKWARD_RANGE",
                    flash_grad.BACKWARD_RANGE)
    split = train_split(profiled(lambda: step(model, opt, batch), 1), plain)
    wall = statistics.median(walls)
    return {"src": src, "step_wall_s": wall,
            "tokens_per_s": BATCH * SEQ / wall,
            "max_memory_allocated_gb": peak / 1e9,
            "loss_first": losses[0], "loss_last": losses[-1],
            "profiled_wall_ms": split["wall_ms"],
            "device_busy_ms": split["device_busy_ms"],
            "device_busy_share": split["device_busy_share"],
            "flash_backward_cuda_launches": split["flash_backward_launches"],
            **{f"{part} ms": ms for part, ms in split["device_ms"].items()}}


if __name__ == "__main__":
    sys.exit(schur_ab.main(child=child, script=__file__, doc=__doc__))
