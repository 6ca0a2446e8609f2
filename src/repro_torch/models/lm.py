"""Full model assembly: embeddings or a stub frontend → layer stack →
norm → last-position logits. Decoder-only LMs and the encoder-only audio
arch share this file (cfg.causal distinguishes them).

Port of src/repro/models/lm.py. The vocab table is padded to a multiple
of 2048 and padded logit slots are masked to −1e30, as in the reference.
A stub frontend (qwen2-vl's vision, hubert's audio) takes precomputed
embeddings through one linear adapter in place of the token table. The
chunked cross-entropy (`lm_loss`, `_chunk_ce`) comes with training
(ROADMAP A14.5).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .blocks import apply_stack, init_stack
from .common import Initializer, apply_norm, init_norm, positions_for

F32 = torch.float32


def padded_vocab(cfg, multiple: int = 2048) -> int:
    v = cfg.vocab_size
    return -(-v // multiple) * multiple


class Frontend(nn.Module):
    """The stub frontend's adapter (d, d): it stands in for the
    patch/frame projection of the embeddings the inputs carry."""

    def __init__(self, ini: Initializer, d: int):
        super().__init__()
        self.adapter = ini.normal((d, d))


class LM(nn.Module):
    """embed (Vp, d) or, with a stub frontend, frontend.adapter (d, d);
    stack (one Layer per layer), final_norm, lm_head (d, Vp)."""

    def __init__(self, cfg, ini: Initializer):
        super().__init__()
        vp = padded_vocab(cfg)
        self.cfg = cfg
        if cfg.frontend is None:
            self.embed = ini.normal((vp, cfg.d_model))
        else:
            self.frontend = Frontend(ini, cfg.d_model)
        self.stack = init_stack(ini, cfg)
        self.final_norm = init_norm(ini, cfg.d_model, cfg.norm_type)
        self.lm_head = ini.normal((cfg.d_model, vp))


def init_lm(cfg, seed: int = 0, *, device=None) -> LM:
    """The model with weights drawn from `seed` on `device` (None = the
    CUDA device, RuntimeError without one), in cfg.param_dtype."""
    ini = Initializer(seed, cfg.param_dtype, resolve_device(device))
    return LM(cfg, ini)


def embed_inputs(params: LM, batch: dict, cfg) -> torch.Tensor:
    """batch["tokens"] (B, S) through the table, or with a stub frontend
    batch["embeds"] (B, S, d) through the adapter."""
    if cfg.frontend is None:
        return params.embed[batch["tokens"]].to(cfg.dtype)
    return (batch["embeds"].to(cfg.dtype) @ params.frontend.adapter).to(cfg.dtype)


def forward_hidden(
    params: LM,
    batch: dict,
    cfg,
    positions: torch.Tensor | None = None,
    caches: list | None = None,
) -> tuple[torch.Tensor, list | None]:
    """Normed hidden states (B, S, d). With caches (decode) each layer
    writes its token into its cache in place, and the same list comes
    back."""
    x = embed_inputs(params, batch, cfg)
    b, s = x.shape[:2]
    if positions is None:
        positions = positions_for(cfg, b, s, device=x.device)
    x, caches = apply_stack(params.stack, x, cfg, positions, caches)
    return apply_norm(params.final_norm, x, cfg.norm_type), caches


def lm_logits_last(params: LM, hidden: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits (B, Vp) of the last position; padded slots −1e30."""
    logits = (hidden[:, -1] @ params.lm_head).to(F32)
    vp = params.lm_head.shape[1]
    pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)
