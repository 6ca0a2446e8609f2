"""Shared model machinery: the parameter factory, norms, RoPE and M-RoPE.

Port of src/repro/models/common.py. Parameters live in `nn.Module`s;
each one carries the reference's logical PartitionSpec names as its
`spec` attribute from birth (the reference's `Px(value, spec)` leaf), so
the init code is the sharding map. `param_specs(model)` gives them in
the reference's tree layout (its `split_tree(...)[1]`), and
`launch/train.py --mesh smoke` places each parameter by its spec.
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

    def _param(self, value: torch.Tensor, spec) -> nn.Parameter:
        if len(spec) != value.ndim:
            raise ValueError(f"spec {spec} for a {value.ndim}-d parameter")
        p = nn.Parameter(value, requires_grad=False)
        p.spec = tuple(spec)
        return p

    def normal(self, shape, spec, *, std: float = 0.02, dtype=None) -> nn.Parameter:
        d = dtype or self.dtype
        if self.generator is None:
            return self._param(torch.empty(shape, dtype=d, device=self.device),
                               spec)
        v = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=F32)
        return self._param((v * std).to(d), spec)

    def zeros(self, shape, spec, *, dtype=None) -> nn.Parameter:
        return self._param(torch.zeros(shape, dtype=dtype or self.dtype,
                                       device=self.device), spec)

    def ones(self, shape, spec, *, dtype=None) -> nn.Parameter:
        return self._param(torch.ones(shape, dtype=dtype or self.dtype,
                                      device=self.device), spec)


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
            self.gamma = ini.zeros((d,), (None,))
        else:
            self.gamma = ini.ones((d,), (None,))
            self.beta = ini.zeros((d,), (None,))


def init_norm(ini: Initializer, d: int, kind: str = "rmsnorm") -> Norm:
    return Norm(ini, d, kind)


def apply_norm(p: Norm, x: torch.Tensor, kind: str = "rmsnorm") -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p.gamma)
    return layer_norm(x, p.gamma, p.beta)


# ---------------------------------------------------------------------------
# RoPE (half-split convention) + M-RoPE (Qwen2-VL §3.1)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by angles (B, S, D/2) in f32, cast back."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates in f32, then casts
    back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (d/2,)
    return _rotate(x, positions[..., None].to(F32) * freqs)


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL's (temporal, h, w) = (16, 24, 24) of the 64 freq slots at
    head_dim 128, generalized proportionally (1/4, 3/8, 3/8)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
                sections: tuple[int, int, int] | None = None) -> torch.Tensor:
    """M-RoPE: the head_dim/2 freq slots split into (temporal, h, w)
    sections, each rotated by its own position stream. positions:
    (B, S, 3); for the text-only backbone all three streams equal the
    text position, which makes this plain RoPE."""
    d = x.shape[-1]
    if sections is None:
        sections = mrope_sections(d)
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} do not split {d // 2} slots")
    freqs = rope_freqs(d, theta, device=x.device)  # (d/2,)
    # which position stream each freq slot reads
    sec_id = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=x.device)
    pos_per_slot = positions.to(F32)[..., sec_id]  # (B, S, d/2)
    return _rotate(x, pos_per_slot * freqs)


def positions_for(cfg, batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """Position stream (B, S) for a text segment starting at `offset` (an
    int, or one offset per row); (B, S, 3), three equal streams, under
    M-RoPE."""
    off = torch.as_tensor(offset, device=device).reshape(-1, 1)
    pos = (torch.arange(seq, device=device)[None, :] + off).expand(batch, seq)
    if cfg.rope_type == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos


__all__ = [
    "Initializer", "Norm", "rms_norm", "layer_norm", "init_norm",
    "apply_norm", "rope_freqs", "apply_rope", "mrope_sections", "apply_mrope",
    "positions_for",
]
