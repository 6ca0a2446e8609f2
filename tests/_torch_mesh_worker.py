"""One rank of the sharded runs that tests/test_torch_sharding.py
spawns: a process group over a FileStore (gloo, CPU), the reference's
(2, 2) ("data", "model") smoke mesh, and a smoke config's weights from
seed 0 placed by their specs (its head counts replaced where `heads`
gives them).

`run`: two AdamW steps on one batch; rank 0 writes the losses, the grad
norms, whether every parameter and moment is a DTensor, and the
parameters after the steps gathered whole. `decode`: for each case, the
prefill of a prompt and a decode loop from empty caches (`decode_logits`,
which the test runs unsharded too); rank 0 writes the logits gathered
whole and whether the caches' k, v and pos ended as DTensors. Imports
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


def decode_tokens(cfg, batch: int, steps: int) -> torch.Tensor:
    """The decode loop's tokens, (batch, steps) int32, drawn with numpy
    from a fixed seed."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, steps)).astype(np.int32))


def decode_logits(cfg, model, tokens: torch.Tensor, caches=None) -> np.ndarray:
    """(steps, B, Vp) logits of a decode loop that feeds tokens (B, S) one
    column a step into caches of S slots (empty ones where not given), at
    positions 0, 1, ..., gathered whole on every rank."""
    from repro_torch.distrib.sharding import full
    from repro_torch.serve.kvcache import init_caches
    from repro_torch.serve.steps import build_decode_step

    b, s = tokens.shape
    if caches is None:
        caches = init_caches(cfg, b, s, device="cpu")
    step = build_decode_step(cfg)
    out = []
    for t in range(s):
        logits, caches = step(model, caches, {"tokens": tokens[:, t:t + 1]},
                              torch.full((b,), t, dtype=torch.int32))
        out.append(full(logits).numpy())
    return np.stack(out)


def decode(rank: int, world: int, store: str, out: str, cases: dict,
           batch: int, steps: int, prompt: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from dataclasses import replace

        from torch.distributed.tensor import DTensor

        from repro_torch.configs import smoke_config
        from repro_torch.distrib.sharding import full, make_rules, use_rules
        from repro_torch.launch.mesh import make_smoke_mesh
        from repro_torch.launch.train import place_params, smoke_mesh_shape
        from repro_torch.models.lm import init_lm
        from repro_torch.serve.kvcache import init_caches, place_caches
        from repro_torch.serve.steps import build_prefill_step

        mesh = make_smoke_mesh(smoke_mesh_shape(world), ("data", "model"),
                               device_type="cpu")
        arrays, placed = {}, {}
        for name, (arch, heads) in cases.items():
            cfg = smoke_config(arch)
            if heads is not None:
                cfg = replace(cfg, num_heads=heads[0], num_kv_heads=heads[1])
            rules = make_rules(mesh, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads)
            tokens = decode_tokens(cfg, batch, steps)
            with use_rules(rules):
                model = place_params(init_lm(cfg, 0, device="cpu"), rules)
                arrays[f"{name}/prefill"] = full(build_prefill_step(cfg)(
                    model, {"tokens": tokens[:, :prompt]})).numpy()
                caches = place_caches(init_caches(cfg, batch, steps,
                                                  device="cpu"))
                arrays[f"{name}/decode"] = decode_logits(cfg, model, tokens,
                                                         caches)
            placed[name] = all(isinstance(c[leaf], DTensor) for c in caches
                               for leaf in ("k", "v", "pos") if leaf in c)
        if rank == 0:
            np.savez(f"{out}.npz", **arrays)
            with open(f"{out}.json", "w") as f:
                json.dump({"placed": placed, "mesh": list(mesh.shape)}, f)
    finally:
        dist.destroy_process_group()
