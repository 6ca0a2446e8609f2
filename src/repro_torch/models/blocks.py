"""Layer composition: pre-norm residual blocks in layer order.

Port of src/repro/models/blocks.py. The reference stacks each position of
the layer pattern over periods and scans them, a compile-time device that
keeps its HLO small; eagerly there is nothing to gain, so the port keeps
the layers unstacked in an `nn.ModuleList`, in the order
`cfg.layer_list()` gives (interop.lm_params_from_numpy unstacks the
reference's periods into it).

mixer ∈ {"attn_full", "attn_sliding", "attn_chunked", "ssm"}
ffn   ∈ {"mlp", "moe", "none"}
"""
from __future__ import annotations

import torch
from torch import nn

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


def init_stack(ini: Initializer, cfg) -> nn.ModuleList:
    """One Layer per entry of cfg.layer_list(), in order."""
    return nn.ModuleList(init_layer(ini, cfg, mixer, ffn)
                         for mixer, ffn in cfg.layer_list())


def apply_stack(
    layers: nn.ModuleList,
    x: torch.Tensor,
    cfg,
    positions: torch.Tensor,
    caches: list | None = None,
) -> tuple[torch.Tensor, list | None]:
    """Every layer in order; caches (decode) is the per-layer list of
    serve.kvcache.init_caches, updated in place."""
    for i, (layer, (mixer, ffn)) in enumerate(zip(layers, cfg.layer_list())):
        x, _ = apply_layer(layer, x, cfg, mixer, ffn, positions,
                           cache=None if caches is None else caches[i])
    return x, caches
