"""Training launcher: config → mesh and sharding rules → seeded model on
the device → AdamW → the fault-tolerant loop with checkpoints.

    python -m repro_torch.launch.train --arch repro-100m \\
        --steps 300 --batch 16 --seq 512 --ckpt ckpt   # on the CUDA device
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch tinyllama-1.1b --smoke --steps 12 --batch 4 --seq 32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --device cpu --mesh smoke --arch tinyllama-1.1b --smoke --steps 12 \\
        --batch 8 --seq 32

Port of src/repro/launch/train.py, with the same flags plus --device.
Without --device it runs on the CUDA device, or raises where there is
none. Any registry arch (or its smoke reduction, --smoke) runs; weights
come from --seed. A rerun with the same --ckpt resumes from its latest
checkpoint.

--mesh smoke shards the run the way the production mesh would (the same
rules code path): over the process group torchrun's environment
describes (gloo on the CPU, NCCL on CUDA devices, rank r on cuda:r), or,
started without torchrun, over a group of one rank. The mesh is the
reference's (d, world / d), d = 2 where world >= 4, axes (data, model);
the parameters and the AdamW state are DTensors placed by their specs,
each batch is sharded over the data axis, and the checkpoints hold full
tensors, written by rank 0, so they equal an unsharded run's. Only rank
0 prints.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs import ModelConfig, get_config, smoke_config
from ..device import resolve_device
from ..distrib.sharding import is_sharded, make_rules, use_rules
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


@contextlib.contextmanager
def process_group(device: torch.device):
    """The process group of torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), else one of a single rank over an
    in-process store; destroyed on exit where this function started it.
    Yields (rank, world size, this rank's device)."""
    import torch.distributed as dist

    backend = "nccl" if device.type == "cuda" else "gloo"
    started = not dist.is_initialized()
    if started and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    elif started:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    try:
        yield rank, world, device
    finally:
        if started:
            dist.destroy_process_group()


def smoke_mesh_shape(world: int) -> tuple[int, int]:
    """The reference's smoke mesh: (d, world / d), d = 2 where world >= 4."""
    d = 2 if world >= 4 else 1
    return d, world // d


def place_params(model, rules):
    """The model with every parameter a DTensor placed by its spec under
    `rules` (each rank holds the same full weights, drawn from the seed)."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        placed = nn.Parameter(
            distribute_tensor(p.detach(), rules.mesh, rules.placements(*p.spec)),
            requires_grad=p.requires_grad)
        placed.spec = p.spec
        setattr(module, leaf, placed)
    return model


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

    device = resolve_device(args.device)
    cfg = resolve_config(args.arch, args.smoke)
    group = (process_group(device) if args.mesh == "smoke"
             else contextlib.nullcontext((0, 1, device)))
    with group as (rank, world, device):
        mesh = None
        if args.mesh == "smoke":
            from .mesh import make_smoke_mesh

            mesh = make_smoke_mesh(smoke_mesh_shape(world), ("data", "model"),
                                   device_type=device.type)
        rules = make_rules(mesh, num_heads=cfg.num_heads or None,
                           num_kv_heads=cfg.num_kv_heads or None)
        with use_rules(rules):
            report = _train(args, cfg, device, rules, rank)
    return 0 if report is not None else 1


def _train(args, cfg, device, rules, rank: int):
    say = print if rank == 0 else (lambda *a, **k: None)
    params = init_lm(cfg, args.seed, device=device)
    n_params = sum(p.numel() for p in params.parameters())
    if rules.mesh is not None:
        params = place_params(params, rules)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps, state_dtype=cfg.opt_dtype)
    opt = init_opt_state(params, opt_cfg)
    step_fn = build_train_step(cfg, opt_cfg, sdc_check=args.sdc)
    data = SyntheticLM(cfg, seed=args.seed)
    mgr = CheckpointManager(args.ckpt, keep_last=3)
    mesh = "none" if rules.mesh is None else dict(
        zip(rules.mesh.mesh_dim_names, rules.mesh.shape))
    placed = sum(is_sharded(p) for p in params.parameters())
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
        f"batch={args.batch} seq={args.seq} steps={args.steps} "
        f"mesh={mesh} device={device} sdc={args.sdc} "
        f"resume_from={mgr.latest_step()} "
        f"sharded_params={placed}/{len(list(params.parameters()))}")

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
    say(f"[train] done: {report.steps_run} steps in {dt:.1f}s "
        f"({tput:.0f} tok/s) loss {first:.4f} -> {last:.4f} "
        f"restarts={report.restarts} sdc_rejects={report.sdc_rejects} "
        f"stragglers={len(report.straggler_events)}")
    say(f"[train] losses: {[round(float(x), 6) for x in report.losses]}")
    say(f"[train] grad_norms: {report.grad_norms}")
    say(f"[train] checkpoints: {len(mgr.write_seconds)} written, "
        f"write_s={[round(s, 3) for s in mgr.write_seconds]}")
    assert last < first, "training did not improve loss"
    return report


if __name__ == "__main__":
    sys.exit(main())
