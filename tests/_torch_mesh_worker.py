"""One rank of the sharded train step that tests/test_torch_sharding.py
spawns: a process group over a FileStore (gloo, CPU), the reference's
(2, 2) ("data", "model") smoke mesh, the smoke config's weights from
seed 0 placed by their specs (its head counts replaced where `heads`
gives them), and two AdamW steps on one batch. Rank 0
writes the losses, the grad norms, whether every parameter and moment is
a DTensor, and the parameters after the steps gathered whole. Imports
neither jax nor the reference package, so each rank starts quickly."""
import json

import numpy as np
import torch
import torch.distributed as dist


def run(rank: int, world: int, store: str, out: str, arch: str,
        batch: int, seq: int, heads=None) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.tensor import DTensor

        from repro_torch.configs import smoke_config
        from repro_torch.distrib.sharding import full, make_rules, use_rules
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.train import place_params, smoke_mesh_shape
        from repro_torch.models.lm import init_lm
        from repro_torch.train.data import SyntheticLM
        from repro_torch.train.optimizer import AdamWConfig, init_opt_state
        from repro_torch.train.steps import build_train_step

        cfg = smoke_config(arch)
        if heads is not None:
            from dataclasses import replace

            cfg = replace(cfg, num_heads=heads[0], num_kv_heads=heads[1])
        mesh = make_smoke_mesh(smoke_mesh_shape(world), ("data", "model"),
                               device_type="cpu")
        rules = make_rules(mesh, num_heads=cfg.num_heads,
                           num_kv_heads=cfg.num_kv_heads)
        data = SyntheticLM(cfg).batch(0, batch, seq)
        opt_cfg = AdamWConfig()
        with use_rules(rules):
            model = place_params(init_lm(cfg, 0, device="cpu"), rules)
            opt = init_opt_state(model, opt_cfg)
            step = build_train_step(cfg, opt_cfg)
            metrics = []
            for _ in range(2):
                model, opt, m = step(model, opt, data, 0)
                metrics.append({k: float(v) for k, v in m.items()})
            sharded = all(isinstance(p, DTensor) for p in model.parameters())
            sharded &= all(isinstance(t, DTensor) for t in opt["mu"].values())
            params = {n: full(p).numpy() for n, p in model.named_parameters()}
        if rank == 0:
            np.savez(f"{out}.npz", **params)
            with open(f"{out}.json", "w") as f:
                json.dump({"metrics": metrics, "sharded": bool(sharded),
                           "mesh": list(mesh.shape)}, f)
    finally:
        dist.destroy_process_group()
