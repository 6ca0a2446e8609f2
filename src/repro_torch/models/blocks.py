"""Layer composition: pre-norm residual blocks in layer order.

Port of src/repro/models/blocks.py. The reference stacks each position of
the layer pattern over periods and scans them, a compile-time device that
keeps its HLO small; eagerly there is nothing to gain, so the port keeps
the layers unstacked in an `nn.ModuleList`, in the order
`cfg.layer_list()` gives (interop.lm_params_from_numpy unstacks the
reference's periods into it).

Rematerialisation follows the reference's: the checkpointed unit is one
period of the pattern (len(cfg.pattern) layers), the remainder layers
after the last full period are not checkpointed, and decode never is.
Policies: "nothing" saves only each period's input
(`torch.utils.checkpoint`, non-reentrant), "dots" also saves the outputs
of the unbatched products (aten.mm/addmm: the projections and MLPs) and
recomputes the batched ones, as the reference's
`dots_with_no_batch_dims_saveable`, and "none" saves everything. The
flash kernel's ctypes call is invisible to a policy, so under "dots" it
is recomputed too.

mixer ∈ {"attn_full", "attn_sliding", "attn_chunked", "ssm"}
ffn   ∈ {"mlp", "moe", "none"}
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..distrib.sharding import with_rules
from .attention import attention, init_attention
from .common import Initializer, apply_norm, init_norm
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .ssm import apply_ssm, init_ssm

_KIND = {"attn_full": "full", "attn_sliding": "sliding",
         "attn_chunked": "chunked"}


class Layer(nn.Module):
    """mixer_norm, mixer (attention or SSM), and ffn_norm, ffn (MLP or
    MoE) unless the ffn is "none"."""

    def __init__(self, ini: Initializer, cfg, mixer: str, ffn: str):
        super().__init__()
        if mixer != "ssm" and mixer not in _KIND:
            raise ValueError(f"unknown mixer {mixer!r}")
        self.mixer_norm = init_norm(ini, cfg.d_model, cfg.norm_type)
        if mixer == "ssm":
            self.mixer = init_ssm(ini, cfg)
        else:
            self.mixer = init_attention(ini, cfg)
        if ffn != "none":
            self.ffn_norm = init_norm(ini, cfg.d_model, cfg.norm_type)
            self.ffn = init_moe(ini, cfg) if ffn == "moe" else init_mlp(ini, cfg)


def init_layer(ini: Initializer, cfg, mixer: str, ffn: str) -> Layer:
    return Layer(ini, cfg, mixer, ffn)


def apply_layer(
    p: Layer,
    x: torch.Tensor,
    cfg,
    mixer: str,
    ffn: str,
    positions: torch.Tensor,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    h = apply_norm(p.mixer_norm, x, cfg.norm_type)
    if mixer == "ssm":
        mx, cache = apply_ssm(p.mixer, h, cfg, cache=cache)
    else:
        mx, cache = attention(p.mixer, h, cfg, positions, kind=_KIND[mixer],
                              cache=cache)
    x = x + mx
    if ffn != "none":
        h = apply_norm(p.ffn_norm, x, cfg.norm_type)
        f = apply_moe(p.ffn, h, cfg) if ffn == "moe" else apply_mlp(p.ffn, h, cfg)
        x = x + f
    return x, cache


def split_layers(cfg) -> tuple[int, int]:
    """(num_full_periods, num_remainder_layers)."""
    plen = len(cfg.pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


def reference_layers(cfg, layers: list, stack) -> dict:
    """The reference's stacked layer tree from one tree per layer, in
    layer order: pattern position j of every full period combined by
    `stack` (a list of leaves → one leaf) under "periods" / f"l{j}", the
    layers after the last full period as they are under "remainder" /
    f"l{r}". Trees are nested dicts."""
    n_periods, rem = split_layers(cfg)
    plen = len(cfg.pattern)

    def combine(trees):
        if isinstance(trees[0], dict):
            return {k: combine([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)

    out = {"periods": {f"l{j}": combine(layers[j:n_periods * plen:plen])
                       for j in range(plen) if n_periods}}
    if rem:
        out["remainder"] = {f"l{r}": layers[n_periods * plen + r]
                            for r in range(rem)}
    return out


def init_stack(ini: Initializer, cfg) -> nn.ModuleList:
    """One Layer per entry of cfg.layer_list(), in order."""
    return nn.ModuleList(init_layer(ini, cfg, mixer, ffn)
                         for mixer, ffn in cfg.layer_list())


REMAT_POLICIES = ("nothing", "dots", "none")
#: the unbatched products, whose outputs the "dots" policy saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, policy: str):
    """body(x) under the policy's checkpoint ("none": body itself)."""
    if policy == "none":
        return body
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    # the recomputation runs in the backward, which may be on the
    # autograd engine's own thread: bound to the sharding rules of now
    return lambda x: checkpoint(with_rules(body), x, use_reentrant=False, **kw)


def apply_stack(
    layers: nn.ModuleList,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor,
    caches: list | None = None,
    *,
    remat_policy: str = "nothing",
) -> tuple[torch.Tensor, list | None]:
    """Every layer in order; caches (decode) is the per-layer list of
    serve.kvcache.init_caches, updated in place. With grad enabled and
    no caches, each full period runs under `remat_policy`'s checkpoint
    (module docstring); under no_grad nothing is saved, so none is set
    up."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat_policy!r}; "
                         f"known: {REMAT_POLICIES}")
    kinds = cfg.layer_list()
    n_periods, _ = split_layers(cfg)
    plen = len(cfg.pattern)

    def run(x, first, last):
        for i in range(first, last):
            x, _ = apply_layer(layers[i], x, cfg, *kinds[i], positions,
                               cache=None if caches is None else caches[i])
        return x

    if caches is not None or not torch.is_grad_enabled():
        remat_policy = "none"
    for p in range(n_periods):
        body = functools.partial(run, first=p * plen, last=(p + 1) * plen)
        x = _remat(body, remat_policy)(x)
    return run(x, n_periods * plen, len(kinds)), caches
