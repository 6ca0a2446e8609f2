"""Mamba2 / SSD (state-space duality) mixer — arXiv:2405.21060.

Port of src/repro/models/ssm.py. The chunked SSD algorithm is three
product families (the quadratic form within a chunk, each chunk's final
state, and the recurrence between chunks), left to torch.einsum as the
reference leaves them to XLA; the reference's lax.scan over chunks is a
Python loop of S/Q steps. The reference has no Pallas kernel for this
mixer.

Discretization: h_t = exp(dt_t·A) h_{t-1} + dt_t B_t x_t;  y_t = C_t h_t + D x_t.
B and C are single-group (G = 1).

Decode is the O(1) recurrence over a cache of the state and the last
three conv inputs (init_ssm_cache), updated in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Initializer, rms_norm

F32 = torch.float32
#: the depthwise causal conv's width
CONV_WIDTH = 4


class SSM(nn.Module):
    """w_z, w_x (d, di), w_B, w_C (d, N), w_dt (d, H), conv_x (4, di),
    conv_B, conv_C (4, N), A_log, D, dt_bias (H,) in f32, norm_gamma (di,),
    w_out (di, d)."""

    def __init__(self, ini: Initializer, cfg):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        if h * p != di:
            raise ValueError(f"ssm_heads {h} x ssm_head_dim {p} != d_inner {di}")
        std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.w_z = ini.normal((d, di))
        self.w_x = ini.normal((d, di))
        self.w_B = ini.normal((d, n))
        self.w_C = ini.normal((d, n))
        self.w_dt = ini.normal((d, h))
        self.conv_x = ini.normal((CONV_WIDTH, di), std=0.2)
        self.conv_B = ini.normal((CONV_WIDTH, n), std=0.2)
        self.conv_C = ini.normal((CONV_WIDTH, n), std=0.2)
        self.A_log = ini.zeros((h,), dtype=F32)
        self.D = ini.ones((h,), dtype=F32)
        self.dt_bias = ini.zeros((h,), dtype=F32)
        self.norm_gamma = ini.zeros((di,))
        self.w_out = ini.normal((di, d), std=std_o)


def init_ssm(ini: Initializer, cfg) -> SSM:
    return SSM(ini, cfg)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width K, as K shifted adds in f32.
    x: (B, S, C), w: (K, C)."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k):
        out = out + w[i].to(F32) * xp[:, i:i + s].to(F32)
    return out.to(x.dtype)


def _ssd_chunked(xd: torch.Tensor, la: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xd: (B, S, H, P) dt-scaled inputs; la: (B, S, H)
    log-decay; Bc, Cc: (B, S, N). Returns y (B, S, H, P) in xd's dtype
    and the final state (B, H, N, P) in f32."""
    b, s, h, p = xd.shape
    n = Bc.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        xd = F.pad(xd, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    nc = xd.shape[1] // q
    dtype = xd.dtype
    xd = xd.reshape(b, nc, q, h, p).to(F32)
    la = la.reshape(b, nc, q, h).to(F32)
    Bc = Bc.reshape(b, nc, q, n)
    Cc = Cc.reshape(b, nc, q, n)

    cum = torch.cumsum(la, dim=2)  # (b, nc, q, h)
    # --- within a chunk (quadratic in q) ---
    scores = torch.einsum("bcin,bcjn->bcij", Cc.to(F32), Bc.to(F32))
    lower = torch.tril(torch.ones(q, q, dtype=torch.bool, device=xd.device))
    ldecay = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, i, j, h)
    w_ij = torch.where(lower[None, None, :, :, None],
                       torch.exp(ldecay) * scores[..., None],
                       torch.zeros((), dtype=F32, device=xd.device))
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xd)

    # --- each chunk's final state ---
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, q, h)
    st = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc.to(F32), decay_end, xd)

    # --- the recurrence between chunks ---
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)
    state = torch.zeros((b, h, n, p), dtype=F32, device=xd.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bin,bhnp,bih->bihp", Cc[:, c].to(F32),
                                    state, torch.exp(cum[:, c])))
        state = state * chunk_decay[:, c, :, None, None] + st[:, c]
    y = (y_intra + torch.stack(y_inter, dim=1)).reshape(b, nc * q, h, p)
    return y[:, :s].to(dtype), state


def apply_ssm(p: SSM, x: torch.Tensor, cfg, *, cache: dict | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """x: (B, S, d_model). cache (decode, S == 1): {"state": (B, H, N, P),
    "conv": (B, 3, C_conv)} with C_conv = d_inner + 2N, replaced in place
    by the step's. Returns (out, cache)."""
    b, s, _ = x.shape
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di = h * pd

    z = x @ p.w_z
    xs = x @ p.w_x
    Bc = x @ p.w_B
    Cc = x @ p.w_C
    dt = (x @ p.w_dt).to(F32)

    conv_in = torch.cat([xs, Bc, Cc], dim=-1)
    conv_w = torch.cat([p.conv_x, p.conv_B, p.conv_C], dim=-1)
    if cache is None:
        conv_out = F.silu(_causal_conv(conv_in, conv_w).to(F32))
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        hist = torch.cat([cache["conv"], conv_in], dim=1)  # (B, 4, C)
        conv_out = F.silu((conv_w.to(F32) * hist.to(F32)).sum(dim=1, keepdim=True))
        cache["conv"] = hist[:, 1:]
    xs = conv_out[..., :di].to(x.dtype)
    Bc = conv_out[..., di:di + n].to(x.dtype)
    Cc = conv_out[..., di + n:].to(x.dtype)

    a = -torch.exp(p.A_log.to(F32))  # (H,)
    dt = F.softplus(dt + p.dt_bias.to(F32))  # (B, S, H)
    xh = xs.reshape(b, s, h, pd)
    xd = xh * dt[..., None].to(x.dtype)
    la = dt * a  # log decay

    if cache is None:
        y, _ = _ssd_chunked(xd, la, Bc, Cc, cfg.ssm_chunk)
    else:
        alpha = torch.exp(la[:, 0])  # (B, H)
        state = cache["state"] * alpha[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", Bc[:, 0].to(F32), xd[:, 0].to(F32))
        y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].to(F32), state)[:, None]
        cache["state"] = state

    y = y + p.D.to(F32)[None, None, :, None] * xh.to(F32)
    y = y.reshape(b, s, di).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(x.dtype), p.norm_gamma)
    return y @ p.w_out, cache


def init_ssm_cache(cfg, batch: int, dtype=F32, *, device) -> dict:
    """An SSM layer's decode cache: the zero state (B, H, N, P) in f32 and
    the zero conv tail (B, 3, d_inner + 2N) in `dtype`."""
    h, pd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, n, pd), dtype=F32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, h * pd + 2 * n),
                            dtype=dtype, device=device),
    }
