"""Mixture-of-Experts FFN with top-k routing.

Port of src/repro/models/moe.py. Two implementations (cfg.moe_impl):

  * "dense"    — every expert computes every token; the routing weights
                 pick the used ones at combine.
  * "dispatch" — capacity-bounded dispatch: tokens are placed into
                 per-expert buffers of `cap` slots, each expert runs on
                 its buffer, and the outputs are combined with the
                 routing weights. A (token, choice) past its expert's
                 capacity is dropped.

The reference dispatches and combines with one-hot einsums (the
MaxText style, which an SPMD partitioner shards over experts); eagerly
the same placement is an index write and a gather. Slots and drops are
the reference's exactly: within a group of `moe_group` tokens, the
(token, choice) pairs in token-major order fill each expert's slots
first come, first served. The experts' products are torch.matmul; the
reference has no Pallas MoE kernel.

Router: softmax over expert logits in f32, top-k, weights renormalized
over the selected experts (the Mixtral/Llama4 convention).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Initializer
from .mlp import _gelu

F32 = torch.float32
ACT = {
    "swiglu": F.silu,
    "geglu": _gelu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "gelu": _gelu,
}


class MoE(nn.Module):
    """router (d, E) in f32, w_gate and w_up (E, d, f), w_down (E, f, d)."""

    def __init__(self, ini: Initializer, cfg):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        std_o = 0.02 / (2 * cfg.num_layers) ** 0.5
        self.router = ini.normal((d, e), dtype=F32)
        self.w_gate = ini.normal((e, d, f))
        self.w_up = ini.normal((e, d, f))
        self.w_down = ini.normal((e, f, d), std=std_o)


def init_moe(ini: Initializer, cfg) -> MoE:
    return MoE(ini, cfg)


def _routing(p: MoE, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens → (weights (T, k) f32, expert ids (T, k)),
    the k largest softmax probabilities in descending order."""
    probs = torch.softmax(x.to(F32) @ p.router, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def _expert_ffn(p: MoE, h: torch.Tensor, cfg) -> torch.Tensor:
    """h: (E, C, d) per-expert token buffers → (E, C, d)."""
    act = ACT[cfg.mlp_type]
    return (act(h @ p.w_gate) * (h @ p.w_up)) @ p.w_down


def _capacity(cfg, group: int) -> int:
    return max(int(cfg.moe_capacity_factor * group * cfg.experts_per_token
                   / cfg.num_experts), 1)


def _group_size(cfg, tokens: int) -> int:
    """The reference's token group: moe_group, halved until it divides."""
    tg = min(cfg.moe_group, tokens)
    while tokens % tg != 0:
        tg //= 2
    return tg


def apply_moe(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    w, idx = _routing(p, xt, cfg)
    e, k = cfg.num_experts, cfg.experts_per_token

    if cfg.moe_impl == "dense":
        out = _expert_ffn(p, xt.expand(e, t, d), cfg)  # (E, T, d)
        # combine = Σ_k w_k · out[idx_k], in f32
        picked = out.to(F32)[idx, torch.arange(t, device=x.device)[:, None]]
        return (w[..., None] * picked).sum(dim=1).to(x.dtype).reshape(b, s, d)

    tg = _group_size(cfg, t)
    g = t // tg
    cap = _capacity(cfg, tg)
    # each (token, choice)'s place in its expert's buffer: the count of
    # the group's earlier pairs routed to that expert, token-major (the
    # scan runs along the innermost axis, the pairs)
    pairs = idx.reshape(g, 1, tg * k)
    onehot = F.one_hot(pairs[:, 0], e).to(torch.int32).transpose(1, 2).contiguous()
    taken = torch.cumsum(onehot, dim=-1, dtype=torch.int32)  # (G, E, tg·k)
    slot = taken.gather(1, pairs).reshape(g, tg, k) - 1
    keep = slot < cap
    expert = idx.reshape(g, tg, k)
    row = torch.arange(g, device=x.device)[:, None, None] * e + expert
    # every pair is written; a dropped one into its expert's spare row
    # `cap`, which no expert reads
    buf = x.new_zeros((g * e * (cap + 1), d))
    buf[(row * (cap + 1) + torch.where(keep, slot, cap)).reshape(-1)] = \
        xt.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(-1, d)
    h = buf.view(g, e, cap + 1, d)[:, :, :cap].transpose(0, 1)
    out = _expert_ffn(p, h.reshape(e, g * cap, d), cfg)
    out = out.view(e, g, cap, d).transpose(0, 1).reshape(g * e * cap, d)
    # combine: Σ over kept choices of w (in x's dtype, as the reference
    # casts it) times the expert's output row
    wk = torch.where(keep, w.reshape(g, tg, k), 0).to(x.dtype)
    rows = out[row * cap + slot.clamp(max=cap - 1)]  # (G, tg, k, d)
    y = (wk[..., None] * rows).sum(dim=2)
    return y.reshape(b, s, d)


def moe_active_params(cfg) -> int:
    """Per-token active expert params (for MODEL_FLOPS accounting)."""
    per_expert = 3 * cfg.d_model * cfg.d_ff
    return cfg.experts_per_token * per_expert + cfg.d_model * cfg.num_experts
