"""Full model assembly: embeddings → layer stack → norm → last-position
logits.

Port of src/repro/models/lm.py for the decoder-only text path. The vocab
table is padded to a multiple of 2048 and padded logit slots are masked
to −1e30, as in the reference. Stub frontends (qwen2-vl, hubert) come
with their slice, and the chunked cross-entropy (`lm_loss`, `_chunk_ce`)
with training (ROADMAP A14).
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


class LM(nn.Module):
    """embed (Vp, d), stack (one Layer per layer), final_norm, lm_head
    (d, Vp)."""

    def __init__(self, cfg, ini: Initializer):
        super().__init__()
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"the {cfg.frontend} frontend stub comes with its slice "
                "(ROADMAP A14)")
        vp = padded_vocab(cfg)
        self.cfg = cfg
        self.embed = ini.normal((vp, cfg.d_model))
        self.stack = init_stack(ini, cfg)
        self.final_norm = init_norm(ini, cfg.d_model, cfg.norm_type)
        self.lm_head = ini.normal((cfg.d_model, vp))


def init_lm(cfg, seed: int = 0, *, device=None) -> LM:
    """The model with weights drawn from `seed` on `device` (None = the
    CUDA device, RuntimeError without one), in cfg.param_dtype."""
    ini = Initializer(seed, cfg.param_dtype, resolve_device(device))
    return LM(cfg, ini)


def embed_inputs(params: LM, batch: dict, cfg) -> torch.Tensor:
    return params.embed[batch["tokens"]].to(cfg.dtype)


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
