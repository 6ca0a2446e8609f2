"""AdamW from scratch with global-norm clipping, a linear-warmup cosine
schedule and a configurable state dtype.

Port of src/repro/train/optimizer.py. Parameters, gradients and moments
are dicts of named tensors (`named(model)` gives a model's); the step
count is a 0-d int32 tensor. Each leaf's update is computed in f32 and
stored in its own dtype (the state's for the moments, the parameter's for
the parameter), one leaf at a time, so only one leaf's f32 intermediates
are live at once (the reference chains its leaves through
optimization_barrier for the same reason).

The update is out of place: it returns new parameter and moment tensors
and leaves its inputs as they were. The training loop's SDC gate keeps
the pre-step values when it rejects a step, which an in-place update
would have overwritten.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: Any = torch.float32


def named(params) -> dict[str, torch.Tensor]:
    """A model's parameters by name, or a dict of named tensors as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (a number or an f32 tensor): linear
    warmup to cfg.lr, then a cosine down to 0.1·lr at total_steps."""
    step = torch.as_tensor(step, dtype=F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """{"mu": zeros, "nu": zeros (by name, in cfg.state_dtype, on each
    parameter's device), "step": 0 (int32)}."""
    params = named(params)
    device = next(iter(params.values())).device if params else None

    def zeros():
        # zeros_like keeps a sharded parameter's placements
        return {n: torch.zeros_like(p, dtype=cfg.state_dtype)
                for n, p in params.items()}

    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of Σ over leaves of Σ x² in f32."""
    leaves = [torch.sum(torch.square(x.to(F32))) for x in named(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """(new params, new state, {"grad_norm", "lr"}), all new tensors."""
    params, grads = named(params), named(grads)
    step = state["step"] + 1
    stepf = step.to(F32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    lr = schedule(cfg, stepf)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    new_p, new_mu, new_nu = {}, {}, {}
    for name, p in params.items():
        mu, nu = state["mu"][name], state["nu"][name]
        g = grads[name].to(F32) * scale
        mu_f = b1 * mu.to(F32) + (1 - b1) * g
        nu_f = b2 * nu.to(F32) + (1 - b2) * torch.square(g)
        delta = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        new_p[name] = (p.to(F32) - lr * delta).to(p.dtype)
        new_mu[name] = mu_f.to(mu.dtype)
        new_nu[name] = nu_f.to(nu.dtype)
    return (new_p, {"mu": new_mu, "nu": new_nu, "step": step},
            {"grad_norm": gnorm, "lr": lr})
