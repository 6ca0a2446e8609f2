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

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distrib.sharding import (
    axis_size, constrain, current_rules, gather, sum_grads)
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
        self.router = ini.normal((d, e), ("fsdp", None), dtype=F32)
        self.w_gate = ini.normal((e, d, f), ("model", "fsdp", None))
        self.w_up = ini.normal((e, d, f), ("model", "fsdp", None))
        self.w_down = ini.normal((e, f, d), ("model", "fsdp", None), std=std_o)


def init_moe(ini: Initializer, cfg) -> MoE:
    return MoE(ini, cfg)


def _routing(p: MoE, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flat tokens → (weights (T, k) f32, expert ids (T, k)),
    the k largest softmax probabilities in descending order."""
    return _route(p.router, x, cfg)


def _route(router: torch.Tensor, x: torch.Tensor, cfg
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """_routing with the router's weight (d, E) given."""
    probs = torch.softmax(x.to(F32) @ router, dim=-1)
    w, idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def _expert_ffn(weights, h: torch.Tensor, cfg) -> torch.Tensor:
    """h: (E, C, d) per-expert token buffers → (E, C, d); weights:
    (w_gate, w_up, w_down) of those E experts."""
    w_gate, w_up, w_down = weights
    act = ACT[cfg.mlp_type]
    return (act(h @ w_gate) * (h @ w_up)) @ w_down


def _capacity(cfg, group: int) -> int:
    return max(int(cfg.moe_capacity_factor * group * cfg.experts_per_token
                   / cfg.num_experts), 1)


def _group_size(cfg, tokens: int) -> int:
    """The reference's token group: moe_group, halved until it divides."""
    tg = min(cfg.moe_group, tokens)
    while tokens % tg != 0:
        tg //= 2
    return tg


def _moe_tokens(xt: torch.Tensor, router: torch.Tensor, experts, cfg, *,
                group: int, first: int | None = None) -> torch.Tensor:
    """The MoE output (T, d) of flat tokens xt (T, d) in groups of
    `group`, from the experts whose (w_gate, w_up, w_down) `experts`
    holds: every expert by default; with `first`, the experts [first,
    first + len) alone, which give their share of the sum, as one rank of
    an expert-parallel layer does."""
    t, d = xt.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    el = experts[0].shape[0]
    w, idx = _route(router, xt, cfg)
    local, mine = idx, None
    if first is not None:  # another rank's experts weigh 0 here
        mine = (idx >= first) & (idx < first + el)
        local = (idx - first).clamp(0, el - 1)
        w = torch.where(mine, w, 0)

    if cfg.moe_impl == "dense":
        out = _expert_ffn(experts, xt.expand(el, t, d), cfg)  # (E, T, d)
        # combine = Σ_k w_k · out[idx_k], in f32
        picked = out.to(F32)[local, torch.arange(t, device=xt.device)[:, None]]
        return (w[..., None] * picked).sum(dim=1).to(xt.dtype)

    tg = group
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
    if mine is not None:
        keep = keep & mine.reshape(g, tg, k)
    row = (torch.arange(g, device=xt.device)[:, None, None] * el
           + local.reshape(g, tg, k))
    # every pair is written; a dropped one (or another rank's) into its
    # expert's spare row `cap`, which no expert reads
    buf = xt.new_zeros((g * el * (cap + 1), d))
    buf[(row * (cap + 1) + torch.where(keep, slot, cap)).reshape(-1)] = \
        xt.reshape(g, tg, 1, d).expand(g, tg, k, d).reshape(-1, d)
    h = buf.view(g, el, cap + 1, d)[:, :, :cap].transpose(0, 1)
    out = _expert_ffn(experts, h.reshape(el, g * cap, d), cfg)
    out = out.view(el, g, cap, d).transpose(0, 1).reshape(g * el * cap, d)
    # combine: Σ over kept choices of w (in x's dtype, as the reference
    # casts it) times the expert's output row
    wk = torch.where(keep, w.reshape(g, tg, k), 0).to(xt.dtype)
    rows = out[row * cap + slot.clamp(max=cap - 1)]  # (G, tg, k, d)
    return (wk[..., None] * rows).sum(dim=2).reshape(t, d)


def _sharded_moe(p: MoE, x: torch.Tensor, cfg, rules) -> torch.Tensor:
    """apply_moe under sharding rules, expert-parallel as the reference's
    partitioned einsums are: each rank of the model axis runs its E/M
    experts (their fsdp shards gathered) on every token of its batch
    shard's groups, and the combine's sum over experts is left pending
    over the model axis (Partial) for the constraint after it. Tokens
    come in at their placements and are gathered inside (the sequence
    over the model axis; the batch too where a group would span batch
    shards), so each rank's gradients are its shards'. A sequence that
    does not split evenly (a decode token, S = 1) comes in whole."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh, axis = rules.mesh, rules.model_axis
    b, s, d = x.shape
    group = _group_size(cfg, b * s)
    x_pl = rules.placements("batch", "seq", None)
    if s % math.prod(axis_size(mesh, a) for a, pl in
                     zip(mesh.mesh_dim_names, x_pl) if pl.is_shard(1)):
        x_pl = rules.placements("batch", None, None)
    seq_axes = tuple(a for a, pl in zip(mesh.mesh_dim_names, x_pl)
                     if pl.is_shard(1))
    batch_axes = tuple(a for a, pl in zip(mesh.mesh_dim_names, x_pl)
                       if pl.is_shard(0))
    rows = b // math.prod(axis_size(mesh, a) for a in batch_axes)
    whole = (rows * s) % group != 0  # a group spans batch shards
    out_pl = list(rules.placements("batch", None, None))
    out_pl[mesh.mesh_dim_names.index(axis)] = Partial()

    def local(xl, router, wg, wu, wd):
        model_group = mesh.get_group(axis)
        if axis not in seq_axes:  # whole on every rank of the model axis
            xl = sum_grads(xl, model_group)
        xl = gather(xl, 1, seq_axes, mesh)
        if whole:
            xl = gather(xl, 0, batch_axes, mesh)
        fsdp = rules.fsdp_axes
        router = sum_grads(gather(router, 0, fsdp, mesh), model_group)
        experts = (gather(wg, 1, fsdp, mesh), gather(wu, 1, fsdp, mesh),
                   gather(wd, 1, fsdp, mesh))
        first = mesh.get_local_rank(axis) * wg.shape[0]
        y = _moe_tokens(xl.reshape(-1, d), router, experts, cfg, group=group,
                        first=first).reshape(xl.shape)
        if whole:  # keep this rank's rows: their gradients alone flow back
            mine = 0
            for a in batch_axes:
                mine = mine * axis_size(mesh, a) + mesh.get_local_rank(a)
            y = y[mine * rows:(mine + 1) * rows]
        return y

    w_pl = rules.placements("model", "fsdp", None)
    y = local_map(local, out_placements=(tuple(out_pl),),
                  in_placements=(x_pl, rules.placements("fsdp", None),
                                 w_pl, w_pl, w_pl),
                  device_mesh=mesh, redistribute_inputs=True,
                  )(x, p.router, p.w_gate, p.w_up, p.w_down)
    return constrain(y, "batch", "seq", None)


def apply_moe(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    rules = current_rules()
    if rules is not None and rules.mesh is not None and rules.model_axis:
        return _sharded_moe(p, x, cfg, rules)
    b, s, d = x.shape
    y = _moe_tokens(x.reshape(b * s, d), p.router,
                    (p.w_gate, p.w_up, p.w_down), cfg,
                    group=_group_size(cfg, b * s))
    return constrain(y.reshape(b, s, d), "batch", "seq", None)


def moe_active_params(cfg) -> int:
    """Per-token active expert params (for MODEL_FLOPS accounting)."""
    per_expert = 3 * cfg.d_model * cfg.d_ff
    return cfg.experts_per_token * per_expert + cfg.d_model * cfg.num_experts
