"""Shared model machinery: the parameter factory, norms, RoPE.

Port of src/repro/models/common.py. Parameters live in `nn.Module`s, so
the reference's spec-carrying `Px` leaves and `split_tree` have no
counterpart here (on one device every logical sharding spec is a no-op).
M-RoPE (`apply_mrope`) comes with the qwen2-vl slice (ROADMAP A14).
"""
from __future__ import annotations

import torch
from torch import nn

F32 = torch.float32


class Initializer:
    """Deterministic parameter factory: a `torch.Generator` on the target
    device, drawn from in construction order.

    The numbers differ from the reference's `jax.random` draws for the
    same seed; a test that needs both packages on one set of weights
    carries the reference's across (`interop.lm_params_from_numpy`). On
    the "meta" device it allocates nothing and draws nothing, so a model
    skeleton gives every parameter's shape for free."""

    def __init__(self, seed: int, dtype=torch.bfloat16, device="cpu"):
        self.device = torch.device(device)
        self.dtype = dtype
        self.generator = None
        if self.device.type != "meta":
            self.generator = torch.Generator(device=self.device)
            self.generator.manual_seed(int(seed))

    def _param(self, value: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(value, requires_grad=False)

    def normal(self, shape, *, std: float = 0.02, dtype=None) -> nn.Parameter:
        d = dtype or self.dtype
        if self.generator is None:
            return self._param(torch.empty(shape, dtype=d, device=self.device))
        v = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=F32)
        return self._param((v * std).to(d))

    def zeros(self, shape, *, dtype=None) -> nn.Parameter:
        return self._param(torch.zeros(shape, dtype=dtype or self.dtype,
                                       device=self.device))

    def ones(self, shape, *, dtype=None) -> nn.Parameter:
        return self._param(torch.ones(shape, dtype=dtype or self.dtype,
                                      device=self.device))


# ---------------------------------------------------------------------------
# norms (computed in f32, cast back)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) · (1 + gamma): gamma is stored as an offset from one."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(F32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * gamma.to(F32) + beta.to(F32)
    return out.to(x.dtype)


class Norm(nn.Module):
    """An RMSNorm (gamma, zero at init) or a LayerNorm (gamma one, beta
    zero at init)."""

    def __init__(self, ini: Initializer, d: int, kind: str = "rmsnorm"):
        super().__init__()
        if kind == "rmsnorm":
            self.gamma = ini.zeros((d,))
        else:
            self.gamma = ini.ones((d,))
            self.beta = ini.zeros((d,))


def init_norm(ini: Initializer, d: int, kind: str = "rmsnorm") -> Norm:
    return Norm(ini, d, kind)


def apply_norm(p: Norm, x: torch.Tensor, kind: str = "rmsnorm") -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p.gamma)
    return layer_norm(x, p.gamma, p.beta)


# ---------------------------------------------------------------------------
# RoPE (half-split convention)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates in f32, then casts
    back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (d/2,)
    ang = positions[..., None].to(F32) * freqs  # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_for(cfg, batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """Position stream (B, S) for a text segment starting at `offset` (an
    int, or one offset per row)."""
    if cfg.rope_type == "mrope":
        raise NotImplementedError(
            "M-RoPE position streams come with the qwen2-vl slice (ROADMAP A14)")
    off = torch.as_tensor(offset, device=device).reshape(-1, 1)
    pos = torch.arange(seq, device=device)[None, :] + off
    return pos.expand(batch, seq)


__all__ = [
    "Initializer", "Norm", "rms_norm", "layer_norm", "init_norm",
    "apply_norm", "rope_freqs", "apply_rope", "positions_for",
]
