"""Training launcher: config → seeded model on the device → AdamW → the
fault-tolerant loop with checkpoints.

    python -m repro_torch.launch.train --arch repro-100m \\
        --steps 300 --batch 16 --seq 512 --ckpt ckpt   # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tinyllama-1.1b --smoke --steps 12 --batch 4 --seq 32

Port of src/repro/launch/train.py, with the same flags plus --device.
Without --device it runs on the CUDA device, or raises where there is
none. Any registry arch (or its smoke reduction, --smoke) runs; weights
come from --seed. Only --mesh none runs: the port has one device, and
--mesh smoke needs launch/mesh.py, which is not ported yet (ROADMAP
A14.6). A rerun with the same --ckpt resumes from its latest checkpoint.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from ..configs import ModelConfig, get_config, smoke_config
from ..device import resolve_device
from ..models.lm import init_lm
from ..train.checkpoint import CheckpointManager
from ..train.data import SyntheticLM
from ..train.loop import LoopConfig, run_training
from ..train.optimizer import AdamWConfig, init_opt_state
from ..train.steps import build_train_step

# the example ~100M-param config (llama-style), trained by
# examples/train_lm_torch.py
REPRO_100M = ModelConfig(
    name="repro-100m", family="dense",
    num_layers=10, d_model=640, num_heads=10, num_kv_heads=5, head_dim=64,
    d_ff=1792, vocab_size=32000,
    pattern=(("attn_full", "mlp"),), mlp_type="swiglu",
    activation_dtype="float32", params_dtype="float32",
)


def resolve_config(name: str, smoke: bool) -> ModelConfig:
    if name == "repro-100m":
        return REPRO_100M
    return smoke_config(name) if smoke else get_config(name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=["none", "smoke"], default="none")
    ap.add_argument("--sdc", action="store_true",
                    help="enable Freivalds SDC verification per step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    if args.mesh == "smoke":
        raise NotImplementedError(
            "--mesh smoke needs launch/mesh.py, which the port does not have "
            "yet (ROADMAP A14.6); run with --mesh none")
    device = resolve_device(args.device)
    cfg = resolve_config(args.arch, args.smoke)
    params = init_lm(cfg, args.seed, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps, state_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, opt_cfg)
    step_fn = build_train_step(cfg, opt_cfg, sdc_check=args.sdc)
    data = SyntheticLM(cfg, seed=args.seed)
    mgr = CheckpointManager(args.ckpt, keep_last=3)
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch={args.batch} seq={args.seq} steps={args.steps} "
          f"mesh=none device={device} sdc={args.sdc} "
          f"resume_from={mgr.latest_step()}")

    t0 = time.time()
    params, opt, report = run_training(
        step_fn, params, opt,
        lambda s: data.batch(s, args.batch, args.seq),
        mgr,
        LoopConfig(total_steps=args.steps,
                   checkpoint_every=args.ckpt_every, log_every=10),
        key=args.seed + 1,
    )
    dt = time.time() - t0
    first = np.mean(report.losses[:5])
    last = np.mean(report.losses[-5:])
    tput = args.batch * args.seq * report.steps_run / dt
    print(f"[train] done: {report.steps_run} steps in {dt:.1f}s "
          f"({tput:.0f} tok/s) loss {first:.4f} -> {last:.4f} "
          f"restarts={report.restarts} sdc_rejects={report.sdc_rejects} "
          f"stragglers={len(report.straggler_events)}")
    print(f"[train] checkpoints: {len(mgr.write_seconds)} written, "
          f"write_s={[round(s, 3) for s in mgr.write_seconds]}")
    assert last < first, "training did not improve loss"
    return 0


if __name__ == "__main__":
    sys.exit(main())
