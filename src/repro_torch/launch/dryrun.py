"""Dry run: one train, prefill or decode step of a config on the
production mesh, costed per device without a card.

Port of src/repro/launch/dryrun.py. The reference lowers and compiles the
step for 256 (or 512) fake XLA devices and reads the partitioned HLO. The
port "lowers" a cell by running the step itself, eagerly, under
FakeTensorMode (no tensor holds data, nothing is allocated) on a fake
process group of the mesh's size (torch.testing's FakeStore: this
process plays rank 0, and no collective moves data), with the parameters,
optimizer state and batch placed as DTensors by the sharding rules;
launch/op_cost.py counts what rank 0 runs, and launch/roofline.py turns
it into the three modelled terms. Every number is modelled: the card's
machine has one GPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k --mesh single --out /tmp/dry
    PYTHONPATH=src python -m repro_torch.launch.dryrun --spdc --out /tmp/dry
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The record keeps the reference's keys. Three have no counterpart in an
eager PyTorch step and are null, with the reason under "null_keys":
`compile_s` (nothing is compiled; `lower_s` is the counted run's wall
time), `xla_cost_analysis_raw` (there is no XLA cost analysis) and
`memory_stats.alias_bytes` (no buffer donation: the port's update is out
of place). `memory_stats.peak_est_bytes` is the largest live-tensor total
per device the count saw. A decode cell costs the token at the end of a
full cache, as the reference's decode reads every slot: each attention
layer's host step is its cache length less one (a fake tensor holds no
value to read it from), so every rank runs B6's decode partial over its
own slots, and the partials' all-gather over the model axis and their
merge are counted (models/attention.py's decode under a mesh).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from ..configs import CONFIGS, SHAPES, cell_status, get_config
from ..distrib.sharding import ShardingRules, axis_size, make_rules, use_rules
from .mesh import make_production_mesh
from .op_cost import GPUS_PER_NODE, counting, tensor_bytes
from .roofline import analyze

RESULTS_DIR = Path(tempfile.gettempdir()) / "repro_torch_dryrun"
#: why a reference key is null in the port's record
NULL_KEYS = {
    "compile_s": "an eager step compiles nothing; lower_s is the counted "
                 "run's wall time",
    "xla_cost_analysis_raw": "there is no XLA cost analysis; the counts "
                             "are launch/op_cost.py's",
    "memory_stats.alias_bytes": "no buffer donation: the port's AdamW "
                                "update is out of place",
}


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of `world` ranks, this process rank 0;
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def rules_for(cfg, shape, mesh) -> ShardingRules:
    rules = make_rules(mesh, num_heads=cfg.num_heads or None,
                       num_kv_heads=cfg.num_kv_heads or None,
                       use_fsdp=cfg.use_fsdp)
    if cfg.dp_over_model:
        # pure-DP strategy: batch (and FSDP) over every mesh axis, no TP
        all_axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.mesh_dim_names)
        rules = replace(rules, batch_axes=all_axes, model_axis=None,
                        fsdp_axes=all_axes if cfg.use_fsdp else (),
                        shard_heads=False, shard_kv=False)
    dsize = math.prod(axis_size(mesh, a) for a in rules.batch_axes)
    if dsize and shape.global_batch % dsize != 0:
        rules = replace(rules, batch_axes=())
    return rules


def effective_cfg(cfg, shape, mesh, rules):
    """Clamp grad_accum so each microbatch still shards evenly over the
    data axes (global_batch / accum must be a multiple of the data size)."""
    if shape.kind != "train" or cfg.grad_accum == 1:
        return cfg
    dsize = math.prod(axis_size(mesh, a) for a in rules.batch_axes)
    accum = cfg.grad_accum
    while accum > 1 and (shape.global_batch % accum or
                         (shape.global_batch // accum) % max(dsize, 1)):
        accum //= 2
    return replace(cfg, grad_accum=max(accum, 1))


def _local_bytes(tensors) -> float:
    from torch.distributed.tensor import DTensor

    return float(sum(tensor_bytes(t.to_local() if isinstance(t, DTensor) else t)
                     for t in tensors))


def _inputs(cfg, shape, seq: int) -> dict:
    """The step's batch, full, of fake tensors."""
    b = shape.global_batch
    out = {}
    if cfg.frontend is None:
        out["tokens"] = torch.zeros((b, seq), dtype=torch.int32)
    else:
        out["embeds"] = torch.zeros((b, seq, cfg.d_model), dtype=torch.float32)
    if shape.kind == "train":
        out["labels"] = torch.zeros((b, seq), dtype=torch.int32)
    return out


def lower_cell(arch: str, shape_name: str, mesh, mesh_name: str):
    """Run and count one (arch × shape) cell's step on fake tensors;
    returns (op_cost Cost, rules, meta)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distrib.sharding import distribute
    from ..models.lm import init_lm
    from ..serve.kvcache import init_caches, place_caches
    from ..serve.steps import build_decode_step, build_prefill_step
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.steps import build_train_step
    from .train import place_params

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rules = rules_for(cfg, shape, mesh)
    cfg = effective_cfg(cfg, shape, mesh, rules)
    meta = {"cfg": cfg, "shape": shape}
    with FakeTensorMode(), use_rules(rules):
        model = place_params(init_lm(cfg, 0, device="cpu"), rules)
        params = list(model.parameters())
        meta["params_total_bytes"] = float(sum(tensor_bytes(p) for p in params))
        args = list(params)
        seq = 1 if shape.kind == "decode" else shape.seq_len
        batch = _inputs(cfg, shape, seq)
        if shape.kind == "train":
            opt_cfg = AdamWConfig(state_dtype=cfg.opt_dtype)
            opt = init_opt_state(model, opt_cfg)
            leaves = [*opt["mu"].values(), *opt["nu"].values()]
            meta["opt_total_bytes"] = float(sum(tensor_bytes(t) for t in leaves))
            args += leaves
            step = build_train_step(cfg, opt_cfg)
            run = lambda: step(model, opt, batch, 0)  # noqa: E731
        else:
            batch = {k: distribute(v, "batch", *([None] * (v.ndim - 1)))
                     for k, v in batch.items()}
            if shape.kind == "prefill":
                step = build_prefill_step(cfg)
                run = lambda: step(model, batch)  # noqa: E731
            else:
                caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                                     device="cpu")
                caches = _at_last_slot(place_caches(caches))
                leaves = [t for c in caches for t in c.values()]
                meta["caches_total_bytes"] = float(
                    sum(tensor_bytes(t) for t in leaves))
                args += leaves
                pos = distribute(torch.zeros((shape.global_batch,),
                                             dtype=torch.int32), "batch")
                step = build_decode_step(cfg)
                run = lambda: step(model, caches, batch, pos)  # noqa: E731
        args += list(batch.values())
        live = _local_bytes(args)
        t0 = time.perf_counter()
        with counting(live) as cost:
            out = run()
        meta["lower_s"] = time.perf_counter() - t0
        meta["argument_bytes"] = live
        meta["output_bytes"] = _local_bytes(
            [t for t in _tensors(out)])
    return cost, rules, meta


def _at_last_slot(caches: list[dict]) -> list[dict]:
    """Each attention cache's step set on the host to its last slot (its
    length less one), so that the decode token attends every slot; an
    SSM layer's state has no step."""
    for cache in caches:
        if "step" in cache:
            cache["step"] = cache["k"].shape[1] - 1
    return caches


def _tensors(tree):
    from torch import nn

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _record(rl, meta, cost, rules, chips) -> dict:
    rec = rl.to_dict()
    rec["xla_cost_analysis_raw"] = None
    rec["compile_s"] = None
    rec["lower_s"] = meta["lower_s"]
    rec["null_keys"] = NULL_KEYS
    rec["modelled"] = ("H100 SXM constants (launch/roofline.py); counted on "
                       "fake tensors over a fake process group, not measured")
    rec["sharding"] = {
        "shard_heads": rules.shard_heads, "shard_kv": rules.shard_kv,
        "batch_axes": list(rules.batch_axes),
    }
    state = {k: meta[k] for k in ("params_total_bytes", "opt_total_bytes",
                                  "caches_total_bytes") if k in meta}
    state["state_per_device_gib"] = sum(state.values()) / chips / 2**30
    rec["state_analysis"] = state
    return rec


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: Path) -> dict:
    multi = mesh_name == "multi"
    chips = 512 if multi else 256
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        cost, rules, meta = lower_cell(arch, shape_name, mesh, mesh_name)
    cfg, shape = meta["cfg"], meta["shape"]
    memory_stats = {
        "argument_bytes": int(meta["argument_bytes"]),
        "output_bytes": int(meta["output_bytes"]),
        "temp_bytes": int(max(cost.peak_live_bytes - meta["argument_bytes"], 0)),
        "alias_bytes": None,
        "peak_est_bytes": int(cost.peak_live_bytes),
    }
    training = shape.kind == "train"
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    rl = analyze(arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
                 op_cost=cost, memory_stats=memory_stats,
                 active_params=cfg.active_param_count(), tokens=tokens,
                 training=training)
    rec = _record(rl, meta, cost, rules, chips)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{arch}__{shape_name}__{mesh_name}.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(
        f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
        f"lower={meta['lower_s']:.1f}s "
        f"compute={rl.compute_s*1e3:.2f}ms memory={rl.memory_s*1e3:.2f}ms "
        f"collective={rl.collective_s*1e3:.2f}ms dominant={rl.dominant} "
        f"frac={rl.roofline_fraction:.3f} "
        f"peak_mem={memory_stats['peak_est_bytes']/2**30:.2f}GiB (modelled)"
    )
    return rec


def spdc_cost(n: int, num_servers: int, program: str = "baseline",
              dtype=torch.float32):
    """(Cost, hops) of one sweep of the N-server pipeline on fake (n, n)
    tensors over N CPU slots: the slots' work counted together (each
    round's active row, as the reference's conditional counts its
    costliest branch on every device), and each relay hop a
    collective-permute of its bytes over the link between its two slots
    (slot i is rank i of the model axis)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distrib.spdc_pipeline import ServerMesh, lu_nserver_shardmap

    smesh = ServerMesh(num_servers, "cpu")
    with FakeTensorMode():
        x = torch.zeros((n, n), dtype=dtype)
        with counting(tensor_bytes(x)) as cost:
            lu_nserver_shardmap(x, num_servers, mesh=smesh, program=program)
    for hop in smesh.hops:
        same = hop.src // GPUS_PER_NODE == hop.dst // GPUS_PER_NODE
        cost.collective("collective-permute", hop.nbytes,
                        "nvlink" if same else "network")
    return cost, list(smesh.hops)


def run_spdc_cell(mesh_name: str, out_dir: Path, n: int = 8192,
                  program: str = "baseline", tag: str | None = None) -> dict:
    """The paper's own workload on the production mesh: 16-server one-way
    pipelined LU over the model axis (f32, as the reference lowers it)."""
    multi = mesh_name == "multi"
    chips = 512 if multi else 256
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        servers = axis_size(mesh, "model")
    t0 = time.perf_counter()
    cost, hops = spdc_cost(n, servers, program)
    lower_s = time.perf_counter() - t0
    rl = analyze(arch="spdc-lu", shape=f"n{n}" if tag is None else tag,
                 mesh_name=mesh_name, chips=chips, op_cost=cost,
                 memory_stats={"peak_est_bytes": int(cost.peak_live_bytes)},
                 active_params=0.0, tokens=1.0, training=False)
    rec = rl.to_dict()
    rec["compile_s"] = None
    rec["lower_s"] = lower_s
    rec["null_keys"] = {"compile_s": NULL_KEYS["compile_s"]}
    rec["lu_flops"] = 2 * n**3 / 3
    rec["program"] = program
    rec["hops"] = len(hops)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = tag or f"spdc-lu__n{n}__{mesh_name}"
    with open(out_dir / f"{name}.json", "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] spdc-lu n={n} {program} × {mesh_name}: OK "
          f"lower={lower_s:.1f}s collective-permutes="
          f"{rl.collectives['counts'].get('collective-permute', 0)} "
          f"compute={rl.compute_s*1e3:.2f}ms memory={rl.memory_s*1e3:.2f}ms "
          f"collective={rl.collective_s*1e3:.2f}ms (modelled)")
    return rec


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in CONFIGS:
        for shape_name in SHAPES:
            ok, _ = cell_status(CONFIGS[arch], shape_name)
            if ok:
                cells.append((arch, shape_name))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--spdc", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    if args.list:
        for a, s in all_cells():
            print(f"{a} {s}")
        return 0
    try:
        if args.spdc:
            run_spdc_cell(args.mesh, out_dir)
        else:
            run_cell(args.arch, args.shape, args.mesh, out_dir)
        return 0
    except Exception:
        traceback.print_exc()
        print(f"[dryrun] {args.arch} × {args.shape} × {args.mesh}: FAILED")
        return 1


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
